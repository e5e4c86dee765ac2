"""Mutation routed through the sanctioned entry points — PI001 negatives."""
import torch

from repro_torch.core import insert_batch, repack


def grow(idx, keys, vals):
    idx, _ = insert_batch(idx, keys, vals)
    return repack(idx)


def observe(idx):
    # reads of index leaves are always fine; only writes are owned
    return idx.keys.clone(), idx.pn.item()


def local_state(new_val):
    slots = torch.zeros(4)
    slots.fill_(new_val)    # a local tensor, not an index leaf
    out = torch.empty(4)
    torch.add(slots, 1, out=out)
    return out
