"""The least bytes a window's index kernels must move, and the card's peak.

A kernel's roofline share is the least time its work could take on the
card, bytes over the published HBM bandwidth, divided by the device time
the profiler measured for it.  The bytes depend only on a window's inputs
and the configuration's geometry, so they read the same work whatever
implements the kernel:

* every lane reads its operands and writes its results once;
* a descent reads the top level whole and, below it, the F keys of each
  child group it enters; a group shared by several lanes is read once.
  A level of ``g`` groups is entered by at most ``min(lanes, g)`` distinct
  groups, so that is what each level counts for the window's distinct
  keys (keys spread over the key space, as the benchmark's are, share a
  group below the top levels about as often as never);
* a lower bound over the ``n`` live pending keys reads, at step j of its
  halving, at most ``min(lanes, 2^j)`` distinct keys;
* a range reads the key and value of every record in it and the one key
  past its end.
"""
from __future__ import annotations

import math

# NVIDIA H100 SXM data sheet: 3.35 TB/s of HBM3 at the full 700 W limit
HBM_BYTES_PER_S = 3.35e12
KEY_BYTES = 4
VAL_BYTES = 4


def level_sizes(capacity: int, fanout: int):
    """Entries of the index layer's levels 1..H, bottom up (the storage
    layer above a size of ``fanout`` entries)."""
    sizes, size = [], capacity
    while size > fanout:
        size = -(-size // fanout)
        sizes.append(size)
    return sizes


def descent_bytes(distinct: int, capacity: int, fanout: int) -> int:
    """Key bytes a descent of ``distinct`` keys must read: the top level
    whole, then one F-key group a level and one of the storage layer, each
    distinct group once."""
    sizes = level_sizes(capacity, fanout)
    arrays = [capacity] + sizes              # storage, levels 1..H
    top = arrays[-1]
    total = KEY_BYTES * top
    for n in arrays[:-1]:
        groups = -(-n // fanout)
        total += KEY_BYTES * fanout * min(distinct, groups)
    return total


def bound_bytes(distinct: int, n: int) -> int:
    """Key bytes a lower bound of ``distinct`` keys over ``n`` sorted keys
    must read."""
    if n <= 0:
        return 0
    steps = math.ceil(math.log2(n + 1))
    return KEY_BYTES * sum(min(distinct, 1 << j) for j in range(steps))


def probe_bytes(lanes: int, distinct: int, capacity: int, fanout: int,
                pending: int) -> int:
    """One ``pi_probe`` launch: each lane reads its key and writes three
    int32 results; the descent; the lower bound over the live pending
    keys."""
    return lanes * (KEY_BYTES + 12) + \
        descent_bytes(distinct, capacity, fanout) + \
        bound_bytes(distinct, pending)


def range_bytes(lanes: int, active: int, distinct_lo: int, records: int,
                capacity: int, fanout: int, pending: int) -> int:
    """One ``pi_range`` launch over ``lanes`` lanes, ``active`` of them
    real ranges with ``distinct_lo`` distinct lower bounds holding
    ``records`` records in all: each lane reads two bounds and writes two
    int32 results; each real range descends on its lower bound, reads its
    records' keys and values and the key past its end, and bounds both
    ends in the pending keys."""
    return lanes * (2 * KEY_BYTES + 8) + \
        descent_bytes(distinct_lo, capacity, fanout) + \
        records * (KEY_BYTES + VAL_BYTES) + active * KEY_BYTES + \
        2 * bound_bytes(distinct_lo, pending)


def share_pct(nbytes: int, device_s: float):
    """Least time over measured time, in %; None without a measured time."""
    if device_s <= 0:
        return None
    return 100.0 * nbytes / HBM_BYTES_PER_S / device_s
