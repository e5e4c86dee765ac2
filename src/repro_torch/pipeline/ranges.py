"""Range serving tier: RANGE ops as pipeline citizens, on one shard.

Counterpart of ``repro.pipeline.ranges``.  A RANGE arrival carries two key
operands — the window's ``keys2`` lane holds the inclusive upper bound —
and flows through the same collect → dispatch stages as point ops:

* **admission** — the collector coalesces exact ``(lo, hi)`` duplicates
  into one result slot (``Collector.range_covered`` flags containment).
* **semantics** — every range in a window observes the **pre-window**
  index state: the dispatcher runs ``execute_ranges`` against the index
  *before* the window's point execute.  On a CUDA stream the range work is
  enqueued first; that is sound only because the point execute never
  writes to its input index (``core.index`` is functional).
* **execution** — one ``range_agg`` per window over the whole window
  batch: the ``cuda`` backend launches ``kernels.pi_range`` once.
  Non-range lanes are neutralized to ``lo = sentinel, hi = 0`` — inert by
  construction.  Eager PyTorch compiles nothing, so where the JAX package
  counts traces of this function the port counts kernel launches:
  ``kernels.pi_range.LAUNCHES["pi_range"]`` rises by one per
  range-bearing window (S per window on a sharded index).
* **sharding** — a range spanning several shards fans out per-shard
  clipped subranges ``[max(lo, fence_s), min(hi, fence_{s+1} - 1)]`` and
  sums the ``(count, sum)`` partials; shards own disjoint key intervals,
  so the sum is exact (no double counting).  Read-only, so no routing:
  every shard sees every query lane; over ranks, each rank's partials
  are gathered and summed in global shard order.
"""
from __future__ import annotations

import torch

from repro_torch.core.batch import RANGE
from repro_torch.core.distributed import shard_of
from repro_torch.core.engine import get_engine
from repro_torch.kernels.pi_search import sentinel_for
from repro_torch.sharding import group_all_gather


def _range_lanes(ops, keys, keys2, kdt):
    """RANGE lanes pass through; everything else goes inert.

    ``lo = sentinel, hi = 0`` makes a lane's range empty in both the
    storage walk and the pending pass, so point and pad slots contribute
    exactly (0, 0).
    """
    is_r = ops == RANGE
    lo = torch.where(is_r, keys.to(kdt), sentinel_for(kdt))
    hi = torch.where(is_r, keys2.to(kdt), 0)
    return lo, hi


def execute_ranges(index, ops, keys, keys2, max_span: int):
    """Serve a window's RANGE lanes against one shard → (count, sum).

    ``index`` is the **pre-window** state (call before the point
    execute); the window arrays move to its device.  Returns two (batch,)
    int32 tensors; non-range slots read (0, 0).  Read-only.
    """
    lo, hi = _range_lanes(*_on(index.device, ops, keys, keys2),
                          index.keys.dtype)
    return get_engine(index.config).range_agg(index, lo, hi, max_span)


def execute_ranges_sharded(state, ops, keys, keys2, max_span: int):
    """Sharded fan-out/reduce: per-shard subranges, summed partials.

    Shard ``s`` owns keys in ``[fences[s], fences[s+1])``, so its
    subrange is the query clipped to that interval — empty (lo > hi,
    hence inert) when the range misses the shard — and the global
    ``(count, sum)`` is the sum of partials over disjoint intervals.
    ``max_span`` is a *per-shard* budget, so splitting can only widen what
    a span cap would truncate.  ``state`` is a ``ShardedPIIndex``; each
    rank runs one ``range_agg`` for each of its own shards (on the
    ``cuda`` backend one ``pi_range`` launch a shard), the partials of
    every rank are gathered and summed in global shard order, from zero,
    in int32 that wraps as the JAX sums do: the one-card arithmetic,
    which a backend's integer reduction need not reproduce.
    """
    fences = state.fences
    lo, hi = _range_lanes(*_on(state.device, ops, keys, keys2),
                          fences.dtype)
    first = state.first
    parts = []
    for j in range(state.shards.keys.shape[0]):
        s = first + j
        shard = shard_of(state.shards, j)
        slo = torch.maximum(lo, fences[s])
        shi = torch.minimum(hi, fences[s + 1] - 1)
        parts.append(get_engine(shard.config).range_agg(shard, slo, shi,
                                                        max_span))
    if state.group is not None:                          # (S, 2, batch)
        parts = group_all_gather(torch.stack([torch.stack(q) for q in parts]),
                                 state.group).flatten(0, 1)
    cnt = torch.zeros(lo.shape, dtype=torch.int32, device=state.device)
    sm = torch.zeros_like(cnt)
    for pc, ps in parts:
        cnt = cnt + pc
        sm = sm + ps
    return cnt, sm


def _on(device, *arrays):
    return [torch.as_tensor(a).to(device=device) for a in arrays]
