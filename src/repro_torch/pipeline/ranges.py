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
  range-bearing window.

The sharded fan-out ``execute_ranges_sharded`` moves with sharding.
"""
from __future__ import annotations

import torch

from repro_torch.core.batch import RANGE
from repro_torch.core.engine import get_engine
from repro_torch.kernels.pi_search import sentinel_for


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
    dev = index.device
    kdt = index.keys.dtype
    ops = torch.as_tensor(ops).to(device=dev)
    keys = torch.as_tensor(keys).to(device=dev)
    keys2 = torch.as_tensor(keys2).to(device=dev)
    lo, hi = _range_lanes(ops, keys, keys2, kdt)
    return get_engine(index.config).range_agg(index, lo, hi, max_span)
