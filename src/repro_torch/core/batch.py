"""Batch-execution utilities: segmented last-writer scans and compaction.

Counterpart of ``repro.core.batch``.  The paper executes a sorted query
batch per thread, sequentially, so that a query observes all
earlier-arriving writes to the same key within the batch (Alg. 4).  Here
that walk is a segmented, right-biased last-write scan over the key
segments of the sorted batch.  PyTorch has no associative scan, so the
scan is written in closed form with running maxima of lane indices.
"""
from __future__ import annotations

import torch

SEARCH, INSERT, DELETE, RANGE = 0, 1, 2, 3


def _last_index(mask: torch.Tensor) -> torch.Tensor:
    """Per lane, the largest j <= i with mask[j] (−1 when none)."""
    lanes = torch.arange(mask.shape[0], device=mask.device)
    return torch.cummax(torch.where(mask, lanes, -1), 0).values


def seg_last_write_scan(newseg, is_write, val, tomb):
    """Inclusive + exclusive segmented last-write scans.

    Args:
      newseg:   (B,) bool — True where a new key segment starts
                (``newseg[0]`` must be True).
      is_write: (B,) bool — query i is an insert or delete.
      val:      (B,) value written by query i (don't care when not a write).
      tomb:     (B,) bool — query i is a delete.

    Returns:
      (inc_has, inc_val, inc_tomb), (exc_has, exc_val, exc_tomb)
      inc_* : last write in this segment among queries [seg_start .. i]
      exc_* : last write in this segment among queries [seg_start .. i-1]

    Equal, lane for lane, to the JAX package's associative scan: the
    combined element of a prefix takes its value from the last lane that
    writes or starts a segment, and "has" is whether the last write lies
    at or after the last segment start.
    """
    j = _last_index(is_write | newseg)
    inc_val = val[j]
    inc_tomb = tomb[j]
    inc_has = _last_index(is_write) >= _last_index(newseg)
    # Exclusive: shift the inclusive scan right by one; a segment start sees
    # nothing from its left neighbour.
    exc_has = torch.where(newseg, False, torch.roll(inc_has, 1))
    exc_val = torch.roll(inc_val, 1)
    exc_tomb = torch.where(newseg, False, torch.roll(inc_tomb, 1))
    exc_has[:1] = False
    return (inc_has, inc_val, inc_tomb), (exc_has, exc_val, exc_tomb)


def compact(mask, out_size, *arrays, fill_values):
    """Stable-compact `arrays` rows where `mask` is True into `out_size` slots.

    Returns (count, dropped, compacted_arrays).  Rows beyond out_size are
    dropped (caller must check `dropped` / trigger a rebuild).
    """
    idx = torch.cumsum(mask.to(torch.int32), 0, dtype=torch.int32) - 1
    if mask.shape[0] == 0:
        count = torch.zeros((), dtype=torch.int32, device=mask.device)
    else:
        count = torch.where(mask, idx + 1, 0).max()
    # out-of-range rows land on one spare slot past the end, cut off below
    target = torch.where(mask, idx, out_size).clamp_max(out_size).long()
    outs = []
    for arr, fv in zip(arrays, fill_values):
        out = torch.full((out_size + 1,) + arr.shape[1:], fv,
                         dtype=arr.dtype, device=arr.device)
        out[target] = arr
        outs.append(out[:out_size])
    dropped = count > out_size
    return count.to(torch.int32), dropped, tuple(outs)


def sort_queries(ops, keys, vals):
    """Stable sort a query batch by key (arrival order breaks ties).

    Returns (perm, sorted_ops, sorted_keys, sorted_vals); ``perm`` is an
    int64 index tensor.  This is the paper's 'query set Q is ordered'
    precondition (Def. 3).  ``stable=True`` matters: torch's argsort is
    not stable by default, and the batch semantics need arrival order
    within a key.
    """
    perm = torch.argsort(keys, stable=True)
    return perm, ops[perm], keys[perm], vals[perm]
