"""Bitonic sort of (key, value) query batches as a hand-written CUDA kernel.

Counterpart of ``repro.kernels.bitonic_sort``.  The paper sorts each
incoming query batch before processing it (Def. 3) and suggests SIMD
mergesort for it (§4.2); the TPU kernel is a bitonic network of
log2(B)(log2(B)+1)/2 compare-exchange stages.  The values ride along with
the keys, and key ties resolve ascending by value: with the arrival index
packed into the value lane (``kernels.ops.sort_queries_kernel``, and the
``cuda`` backend's batch sort in ``core.engine``) the network gives the
stable order.

``bitonic_sort`` routes by the device of its tensors: a CPU tensor runs
``bitonic_sort_plain`` (the TPU kernel's network of ``_stage`` calls in
PyTorch, the port's counterpart of Pallas interpret mode); a CUDA tensor
launches ``csrc/bitonic_sort.cu`` or raises.  It takes power-of-two
batches only, as the JAX function does.  NaN keys are out of scope, as in
the JAX tests, and so is the sign of a zero float key.  ``LAUNCHES``
counts the wrapper's calls that launched the kernel (one C call, which
enqueues 1 launch for B <= 16384 and more above); CPU calls never count.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.build import load_library
from repro_torch.kernels.pi_search import _raise_on

LAUNCHES = {"bitonic_sort": 0}

_SUFFIX = {torch.int32: "i32", torch.float32: "f32"}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


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
    if keys.dtype not in _SUFFIX:
        raise TypeError(f"bitonic_sort: key dtype {keys.dtype} not supported "
                        f"on the card (takes torch.int32, torch.float32)")
    if vals.dtype != torch.int32 or vals.device != keys.device:
        raise TypeError(f"bitonic_sort: vals must be int32 on {keys.device}")
    if B >= 2 ** 31:
        raise ValueError(f"bitonic_sort: batch {B} longer than int32 indexing")
    keys, vals = keys.contiguous(), vals.contiguous()
    if B == 1:
        return keys.clone(), vals.clone()
    k_out, v_out = torch.empty_like(keys), torch.empty_like(vals)
    fn = getattr(load_library("bitonic_sort"),
                 "bitonic_sort_" + _SUFFIX[keys.dtype])
    with torch.cuda.device(keys.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(keys.data_ptr(), vals.data_ptr(), k_out.data_ptr(),
                v_out.data_ptr(), B, stream)
    _raise_on("bitonic_sort", rc)
    LAUNCHES["bitonic_sort"] += 1
    return k_out, v_out
