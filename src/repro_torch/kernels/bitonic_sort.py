"""Bitonic sort of (key, value) query batches as a hand-written CUDA kernel.

Counterpart of ``repro.kernels.bitonic_sort``.  The paper sorts each
incoming query batch before processing it (Def. 3) and suggests SIMD
mergesort for it (§4.2); the TPU kernel is a bitonic network of
log2(B)(log2(B)+1)/2 compare-exchange stages.  The values ride along with
the keys, and key ties resolve ascending by value: with the arrival index
packed into the value lane (``kernels.ops.sort_queries_kernel``, and the
``cuda`` backend's batch sort in ``core.engine``) the network gives the
stable order.

Two entry points route by the device of their tensors: a CPU tensor runs
the plain version, a CUDA tensor launches ``csrc/bitonic_sort.cu`` or
raises.

- ``bitonic_sort(keys, vals)`` is the JAX function: power-of-two batches
  only; plain version ``bitonic_sort_plain``, the TPU kernel's network of
  ``_stage`` calls in PyTorch (the port's counterpart of Pallas interpret
  mode).
- ``bitonic_argsort(keys)`` is the engine's batch sort: the stable
  argsort (int64) of a batch of any length.  The kernel pads the batch
  and makes the arrival index itself; plain version
  ``bitonic_argsort_plain``, which pads with the sentinel key and arrival
  indices past the batch and runs ``bitonic_sort_plain``.

On the card a batch of up to 2^13 pairs sorts in one block, padded to the
smallest tile of ``SINGLE_TILES`` that holds it; a larger one runs the
passes of ``pass_plan``, the one place that decides the launches (see the
``.cu`` header for the design).  NaN keys are out of scope, as in the JAX
tests, and so is the sign of a zero float key.  The guard
``launch_guard("bitonic_sort")`` counts the wrapper calls that launched
the kernel: one C call, which enqueues one launch up to 2^13 pairs and
``len(pass_plan(...))`` above; CPU calls and batches of one key never
count.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.analysis.runtime import launch_guard
from repro_torch.kernels.build import load_library
from repro_torch.kernels.pi_search import _raise_on, sentinel_for

_LAUNCHES = launch_guard("bitonic_sort")

_KEY_DTYPES = (torch.int32, torch.float32)

SINGLE_TILES = (9, 11, 12, 13)   # log2 of the one-block tiles, smallest first
LOG_TILE = 13                # log2 of the tile of the passes after the first
LOG_GATHER = 12              # log2 of the tile of a multi-stride pass
LOG_MIN_RUN = 4              # log2 of the contiguous words a gathered run
SMS = 132                    # H100 SXM: the first pass gives each SM a block
# log2 of the pairs a thread holds, by tile (scripts/bitonic_study.py):
# 2^9 in 128 threads, 2^11 in 256, 2^12 and 2^13 in 256 and 512
LOG_R = {9: 2, 11: 3, 12: 4, 13: 4}


def _log2_exact(B: int) -> int:
    if B < 1 or B & (B - 1):
        raise ValueError(f"bitonic sort needs a power-of-two batch, got {B}")
    return B.bit_length() - 1


def _stage(keys, vals, idx, stride: int, direction_block: int):
    """One compare-exchange stage: partners at distance ``stride``; twin of
    the JAX ``_stage``."""
    partner = idx ^ stride
    pk = keys[partner]
    pv = vals[partner]
    up = (idx & direction_block) == 0          # ascending block?
    is_lo = (idx & stride) == 0                # lower half of the pair?
    # a lane keeps the min if (ascending & lower) | (descending & upper)
    keep_min = ~up ^ is_lo
    kmin = torch.minimum(keys, pk)
    kmax = torch.maximum(keys, pk)
    tie = keys == pk                           # ties: order by value
    vmin = torch.where(keys < pk, vals,
                       torch.where(tie, torch.minimum(vals, pv), pv))
    vmax = torch.where(keys > pk, vals,
                       torch.where(tie, torch.maximum(vals, pv), pv))
    return torch.where(keep_min, kmin, kmax), torch.where(keep_min, vmin, vmax)


def bitonic_sort_plain(keys: torch.Tensor, vals: torch.Tensor):
    """Plain version of ``bitonic_sort`` (same arguments and outputs): the
    network of the JAX ``_bitonic_kernel``, one partner gather per stage."""
    log_b = _log2_exact(keys.shape[0])
    idx = torch.arange(keys.shape[0], device=keys.device)
    for stage in range(log_b):
        direction_block = 1 << (stage + 1)
        for sub in range(stage, -1, -1):
            keys, vals = _stage(keys, vals, idx, 1 << sub, direction_block)
    return keys, vals


def bitonic_argsort_plain(keys: torch.Tensor) -> torch.Tensor:
    """Plain version of ``bitonic_argsort``: the keys padded to the next
    power of two P with the sentinel, the arrival index 0..P-1 as value,
    ``bitonic_sort_plain``, the values of the first B lanes.  A real lane
    holding the sentinel key has an arrival below B, so it sorts ahead of
    every pad."""
    B = keys.shape[0]
    if B <= 1:
        return torch.arange(B, device=keys.device)
    P = 1 << (B - 1).bit_length()
    padded = torch.full((P,), sentinel_for(keys.dtype), dtype=keys.dtype,
                        device=keys.device)
    padded[:B] = keys
    arrival = torch.arange(P, dtype=torch.int32, device=keys.device)
    return bitonic_sort_plain(padded, arrival)[1][:B].long()


# ---------------------------------------------------------------------------
# the kernel's schedule
# ---------------------------------------------------------------------------

def network_log(n: int) -> int:
    """log2 of the lanes the kernel sorts ``n`` real ones in: the smallest
    one-block tile that holds them, else the next power of two."""
    log_n = max(1, (n - 1).bit_length())
    if log_n <= SINGLE_TILES[-1]:
        return next(t for t in SINGLE_TILES if t >= log_n)
    return log_n


def pass_plan(log_n: int, log_tile: int = LOG_TILE,
              log_first: int | None = None, min_run: int = LOG_MIN_RUN,
              log_gather: int = LOG_GATHER) -> list:
    """The kernel launches of a bitonic network over 2^log_n lanes, in
    order, as tuples (s0, s1, top, bottom, j, h, log_t).

    A pass runs, for each stage s in [s0, s1), the strides at index bits
    min(s, top) down to bottom (stage s's direction is index bit s + 1).
    Each block holds a tile of 2^log_t lanes: tile bits [0, j) are index
    bits [0, j), tile bits [j, log_t) are index bits [h, h + log_t - j),
    and the block's number fills the other index bits; j = h = log_t is a
    contiguous tile.

    - 2^log_n <= 2^log_tile: one pass, one tile, the whole network.
    - Else a first pass sorts tiles of 2^log_first (log_tile, or one less
      where that gives fewer than ``SMS`` blocks), and a second finishes
      the stages below log_tile on tiles of 2^log_tile.  Every later stage
      s runs its strides at bits s .. log_tile in multi-stride passes on
      tiles of 2^min(log_gather, log_tile), up to that less min_run bits
      each (a tile gathers runs of 2^j >= 2^min_run contiguous lanes),
      then its strides below log_tile in one pass over contiguous tiles.
    """
    if log_n <= log_tile:
        return [(0, log_n, log_n - 1, 0, log_n, log_n, log_n)]
    log_gather = min(log_gather, log_tile)
    if not 1 <= min_run < log_gather:
        raise ValueError(f"min_run {min_run} must lie in [1, {log_gather})")
    if log_first is None:
        log_first = log_tile if (1 << (log_n - log_tile)) >= SMS \
            else log_tile - 1
    plan = [(0, log_first, log_first - 1, 0, log_first, log_first,
             log_first)]
    if log_first < log_tile:
        plan.append((log_first, log_tile, log_tile - 1, 0, log_tile,
                     log_tile, log_tile))
    k_max = log_gather - min_run
    for s in range(log_tile, log_n):
        b = s
        while b >= log_tile:
            k = min(k_max, b - log_tile + 1)
            plan.append((s, s + 1, b, b - k + 1, log_gather - k, b - k + 1,
                         log_gather))
            b -= k
        plan.append((s, s + 1, log_tile - 1, 0, log_tile, log_tile,
                     log_tile))
    return plan


@functools.lru_cache(maxsize=None)
def _plan_array(log_n: int):
    """``pass_plan(log_n)`` as the C entry points take it: eight ints a
    pass, (log_r, log_t, s0, s1, top, bottom, j, h)."""
    plan = pass_plan(log_n)
    flat = [x for s0, s1, top, bottom, j, h, log_t in plan
            for x in (LOG_R[log_t], log_t, s0, s1, top, bottom, j, h)]
    return (ctypes.c_int * len(flat))(*flat), len(plan)


def _launch(entry: str, keys: torch.Tensor, *args) -> None:
    """One C call of ``entry`` over the plan for ``keys``' batch."""
    n = keys.shape[0]
    log_n = network_log(n)
    plan, n_passes = _plan_array(log_n)
    scratch = (torch.empty(1 << log_n, dtype=torch.int64, device=keys.device)
               if n_passes > 1 else None)
    fn = getattr(load_library("bitonic_sort"), entry)
    with torch.cuda.device(keys.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(keys.data_ptr(), *args,
                None if scratch is None else scratch.data_ptr(), n, log_n,
                int(keys.dtype == torch.float32), plan, n_passes, stream)
    _raise_on(entry, rc)
    _LAUNCHES.bump()


def _check_card_keys(name: str, keys: torch.Tensor) -> None:
    if keys.dtype not in _KEY_DTYPES:
        raise TypeError(f"{name}: key dtype {keys.dtype} not supported on "
                        f"the card (takes torch.int32, torch.float32)")
    if keys.shape[0] > 1 << 30:
        raise ValueError(f"{name}: batch {keys.shape[0]} longer than 2^30")


def bitonic_sort(keys: torch.Tensor, vals: torch.Tensor):
    """Sort a power-of-two batch of (key, value) pairs ascending by key,
    ties ascending by value.

    Args:
      keys: (B,) int32 or float32 keys, B a power of two.
      vals: (B,) int32 values (pack the arrival index here for a stable
            sort).
    Returns:
      (sorted keys, their values), two new (B,) tensors.
    """
    B = keys.shape[0]
    _log2_exact(B)
    if vals.shape != keys.shape or keys.dim() != 1:
        raise ValueError(f"bitonic_sort: keys {tuple(keys.shape)} and vals "
                         f"{tuple(vals.shape)} must be the same 1-D shape")
    if keys.device.type == "cpu":
        return bitonic_sort_plain(keys, vals)
    _check_card_keys("bitonic_sort", keys)
    if vals.dtype != torch.int32 or vals.device != keys.device:
        raise TypeError(f"bitonic_sort: vals must be int32 on {keys.device}")
    keys, vals = keys.contiguous(), vals.contiguous()
    if B == 1:
        return keys.clone(), vals.clone()
    k_out, v_out = torch.empty_like(keys), torch.empty_like(vals)
    _launch("bitonic_sort", keys, vals.data_ptr(), k_out.data_ptr(),
            v_out.data_ptr())
    return k_out, v_out


def bitonic_argsort(keys: torch.Tensor) -> torch.Tensor:
    """Stable argsort of a batch of keys of any length: the int64
    permutation that sorts ``keys`` ascending, ties in arrival order
    (``torch.argsort(keys, stable=True)``).  One launch of the kernel's
    plan on a CUDA tensor, none for B <= 1."""
    if keys.dim() != 1:
        raise ValueError(f"bitonic_argsort: keys {tuple(keys.shape)} must "
                         f"be 1-D")
    if keys.device.type == "cpu":
        return bitonic_argsort_plain(keys)
    _check_card_keys("bitonic_argsort", keys)
    B = keys.shape[0]
    if B <= 1:
        return torch.arange(B, device=keys.device)
    keys = keys.contiguous()
    perm = torch.empty(B, dtype=torch.int64, device=keys.device)
    _launch("bitonic_argsort", keys, perm.data_ptr())
    return perm
