"""Fused batched range aggregation (paper §3.2.5) as a hand-written CUDA kernel.

Counterpart of ``repro.kernels.pi_range``, with the same arguments and
outputs.  For each query ``[lo, hi]`` the kernel returns the int32
``(count, sum of values)`` of the live keys in range, in three stages:
the descent on ``lo`` to its floor slot and that slot's occupied rank;
a walk over at most ``max_span`` occupied ranks through ``dense2slot``;
and the live pending keys in range.

Two things differ from the TPU kernel, with the same results
(``csrc/pi_range.cu`` says why):

* the pending pass reads one contiguous run of the sorted pending buffer,
  ``[lb(lo), ub(hi))``, through prefix tables of the live lanes, instead
  of comparing every query with all ``PC`` lanes.  ``pending_prefix``
  builds the tables from the JAX-shaped arguments, so callers pass what
  the JAX kernel takes;
* the walk stops at the first key above ``hi``: keys ascend with rank.

The kernel serves each query with a group of ``RANGE_GROUP`` lanes (a
constant of ``csrc/pi_range.cu``): the descent reads a level's F keys at
once, the walk reads that many ranks a round, and both pending bounds are
a ``RANGE_GROUP``-ary search (``group_bounds_plain`` is its model).

``pi_range`` routes by the device of its tensors: a CPU tensor runs
``pi_range_plain`` (the port's counterpart of Pallas interpret mode); a
CUDA tensor launches the kernel or raises.  Sums wrap modulo 2^32, as the
int32 sums of the JAX package do.  ``launch_guard("pi_range")``
counts kernel launches (CPU calls never count).
"""
from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.analysis.runtime import launch_guard
from repro_torch.kernels.build import load_library
from repro_torch.kernels.pi_search import (_check_launch_args, _descend,
                                           _level_args, _raise_on,
                                           derive_levels, gather_fill,
                                           group_bounds_plain, sentinel_for)

_LAUNCHES = launch_guard("pi_range")
RANGE_GROUP = 32   # lanes a query: PI_RANGE_GROUP of csrc/pi_range.cu


def wrap_i32(x: torch.Tensor) -> torch.Tensor:
    """An integer tensor reduced modulo 2^32 into int32 (the int32 wrap
    of a JAX sum; torch's ``sum`` and ``cumsum`` return int64)."""
    x = x.long()
    return ((x + 2 ** 31) % 2 ** 32 - 2 ** 31).to(torch.int32)


def pending_prefix(pvals: torch.Tensor, plive: torch.Tensor):
    """(PC+1,) int32 prefix tables of the live pending lanes: ``pcnt[i]``
    counts the live lanes below ``i``, ``psum[i]`` sums their values
    modulo 2^32.  ``plive`` is the JAX kernel's liveness argument (1 or
    True where live)."""
    live = plive > 0
    zero = torch.zeros((1,), dtype=torch.int64, device=pvals.device)
    pcnt = torch.cat([zero, torch.cumsum(live, 0)])
    psum = torch.cat([zero, torch.cumsum(torch.where(live, pvals.long(), 0),
                                         0)])
    return pcnt.to(torch.int32), wrap_i32(psum)


# ---------------------------------------------------------------------------
# plain PyTorch version (the kernel's arithmetic, lane-parallel)
# ---------------------------------------------------------------------------

def pi_range_plain(storage: torch.Tensor, live: torch.Tensor,
                   vals: torch.Tensor, rank: torch.Tensor,
                   dense2slot: torch.Tensor, pending: torch.Tensor,
                   pvals: torch.Tensor, plive: torch.Tensor,
                   lo: torch.Tensor, hi: torch.Tensor, *, fanout: int = 8,
                   max_span: int = 1024,
                   levels: Sequence[torch.Tensor] | None = None):
    """Plain version of ``pi_range`` (same arguments and outputs).

    The walk is a (B, max_span) gather that masks what the kernel's early
    stop skips; the pending pass takes the kernel's two G-ary bounds and
    prefix tables.
    """
    if levels is None:
        levels = derive_levels(storage, fanout)
    kdt = storage.dtype
    lo, hi = lo.to(kdt), hi.to(kdt)
    C = storage.shape[0]
    sent = sentinel_for(kdt)
    pos, underflow = _descend(levels, storage, lo, fanout)
    r0 = torch.where(underflow, 0, rank[pos.clamp(0, C - 1).long()])
    r = r0.clamp_min(0).long()[:, None] + \
        torch.arange(max_span, device=lo.device)[None, :]
    slot = gather_fill(dense2slot, r, C)
    ks = gather_fill(storage, slot, sent)
    inr = (slot >= 0) & (slot < C) & (ks >= lo[:, None]) & \
        (ks <= hi[:, None]) & (gather_fill(live, slot, 0) > 0)
    cnt = inr.sum(1)
    sm = torch.where(inr, gather_fill(vals, slot, 0).long(), 0).sum(1)
    pcnt, psum = pending_prefix(pvals, plive)
    a = group_bounds_plain(pending, lo, group=RANGE_GROUP).long()
    b = group_bounds_plain(pending, hi, right=True, group=RANGE_GROUP).long()
    nonempty = lo <= hi
    cnt = cnt + torch.where(nonempty, pcnt[b] - pcnt[a], 0)
    sm = sm + torch.where(nonempty, psum[b].long() - psum[a].long(), 0)
    return cnt.to(torch.int32), wrap_i32(sm)


# ---------------------------------------------------------------------------
# CUDA launch
# ---------------------------------------------------------------------------

def _check_tables(tables, device, length):
    for name, t in tables.items():
        if t.device != device or t.dtype != torch.int32:
            raise TypeError(f"pi_range: {name} must be int32 on {device}")
        if t.dim() != 1 or not t.is_contiguous() or t.shape[0] != length:
            raise ValueError(f"pi_range: {name} must be 1-D, contiguous, "
                             f"of length {length}")


def pi_range(storage: torch.Tensor, live: torch.Tensor, vals: torch.Tensor,
             rank: torch.Tensor, dense2slot: torch.Tensor,
             pending: torch.Tensor, pvals: torch.Tensor, plive: torch.Tensor,
             lo: torch.Tensor, hi: torch.Tensor, *, fanout: int = 8,
             max_span: int = 1024, tile_q: int = 256,
             levels: Sequence[torch.Tensor] | None = None):
    """Fused batched range aggregation, ONE launch per serving window.

    Args:
      storage:    (C,) sorted gapped storage keys, sentinel slack; int32.
      live:       (C,) int32 — 1 where the slot is occupied and not
                  tombstoned (the aggregate gate).
      vals:       (C,) int32 slot values.
      rank:       (C,) int32 — occupied rank per slot (cumsum of
                  occupancy minus one).
      dense2slot: (C,) int32 — slot of the r-th occupied slot, C past the
                  last occupied rank.
      pending:    (PC,) sorted pending keys, sentinel-padded.
      pvals:      (PC,) int32 pending values.
      plive:      (PC,) int32 — 1 below the pending fill mark and not
                  tombstoned.
      lo, hi:     (B,) inclusive range bounds, any B; a lane with
                  lo > hi (the inert lo = sentinel, hi = 0) gives (0, 0).
      max_span:   occupied-key budget per query (not raw slots).
      levels:     optional index-layer arrays (bottom-up, as on
                  ``PIIndex.levels``); derived from storage when absent.
      tile_q:     kept for parity with the JAX signature; the kernel runs
                  ``RANGE_GROUP`` lanes a query.
    Returns:
      (count, sum) — two (B,) int32 tensors.
    """
    del tile_q
    if storage.device.type == "cpu":
        return pi_range_plain(storage, live, vals, rank, dense2slot, pending,
                              pvals, plive, lo, hi, fanout=fanout,
                              max_span=max_span, levels=levels)
    if levels is None:
        levels = derive_levels(storage, fanout)
    lo = lo.to(storage.dtype).contiguous()
    hi = hi.to(storage.dtype).contiguous()
    _check_launch_args("pi_range", storage, levels, (pending, lo, hi),
                       (torch.int32,))
    C, PC, B = storage.shape[0], pending.shape[0], lo.shape[0]
    if hi.shape[0] != B:
        raise ValueError(f"pi_range: {B} lower and {hi.shape[0]} upper "
                         f"bounds")
    if not 0 <= max_span < 2 ** 31:
        raise ValueError(f"pi_range: max_span {max_span} out of range")
    _check_tables(dict(live=live, vals=vals, rank=rank,
                       dense2slot=dense2slot), storage.device, C)
    _check_tables(dict(pvals=pvals, plive=plive), storage.device, PC)
    cnt = torch.empty((B,), dtype=torch.int32, device=storage.device)
    sm = torch.empty((B,), dtype=torch.int32, device=storage.device)
    if B == 0:
        return cnt, sm
    pcnt, psum = pending_prefix(pvals, plive)
    ptrs, lens, n_levels = _level_args(levels)
    with torch.cuda.device(storage.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = load_library("pi_range").pi_range_i32(
            ptrs, lens, n_levels, storage.data_ptr(), C, live.data_ptr(),
            vals.data_ptr(), rank.data_ptr(), dense2slot.data_ptr(),
            pending.data_ptr(), PC, pcnt.data_ptr(), psum.data_ptr(),
            lo.data_ptr(), hi.data_ptr(), B, fanout, max_span,
            cnt.data_ptr(), sm.data_ptr(), stream)
    _raise_on("pi_range", rc)
    _LAUNCHES.bump()
    return cnt, sm
