"""Index-state writes outside the ownership API, torch's shapes — PI001."""
import torch

from repro_torch.core.index import _rebuild_repack  # expect: PI001


def overwrite(idx, new_val):
    idx.n = idx.n + 1                               # expect: PI001
    idx.pkeys[0] = new_val                          # expect: PI001
    idx.keys.copy_(new_val)                         # expect: PI001
    idx.pvals[0:2].fill_(0)                         # expect: PI001
    idx.tomb.index_put_((new_val,), new_val)        # expect: PI001
    return idx


def into(idx, a, b):
    torch.add(a, b, out=idx.vals)                   # expect: PI001
    return idx
