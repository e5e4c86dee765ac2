"""int8-quantized KV cache for decode.

Counterpart of ``repro.models.kvquant``.  Per-(token, head) symmetric
int8 quantization halves cache bytes against bfloat16 (4x against
float32); the scale tensor adds 1/(2·hd).  ``torch.round`` rounds half
to even, as ``jnp.round`` does, so both packages give the same int8
values and scales bit for bit.  An opt-in around the cache leaves, as in
the JAX package: no serving path calls it.
"""
from __future__ import annotations

import math

import torch


def quantize_kv(x):
    """x: (..., hd) float → (int8 values, float32 scales (..., 1))."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    scale = amax / 127.0 + 1e-12
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_kv(q, scale, dtype=torch.bfloat16):
    return (q.float() * scale).to(dtype)


def cache_bytes(shape, quantized: bool) -> int:
    """Cache footprint: bfloat16 baseline against int8 + scales."""
    n = math.prod(shape)
    if not quantized:
        return n * 2
    hd = shape[-1]
    return n * 1 + (n // hd) * 4
