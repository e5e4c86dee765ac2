"""Causal GQA flash attention (forward) as a hand-written CUDA kernel.

Counterpart of ``repro.kernels.flash_attention``.  It computes the
function of the model's ``transformer.flash_attention``, which the TPU
kernel's ``_flash_kernel`` also computes: softmax(q k^T / sqrt(D) + mask)
v per head, by an online softmax over key tiles with a float32 running
max ``m``, sum ``l`` and accumulator, the KV head of query head h being
``h // (H // KV)``; an optional sliding window (keys with
``kpos > qpos - window``) and tanh softcap of the scores.  Query positions
start at 0, as in a prefill.

The rounding follows the model function, the code this kernel replaces
on the prefill path: q is scaled in its own dtype (``q * scale`` with the
scale itself in q's dtype, as JAX's weakly typed scalar gives), and the
probabilities are cast to v's dtype before the P·V product; scores, the
softmax statistics and the accumulator are float32, the output is in q's
dtype.  Masked scores get ``-1e30`` added, not ``-inf``.

``flash_attention_fwd`` routes by the device of its tensors: on the CPU it
runs ``flash_attention_fwd_plain`` (the chunked online softmax in
PyTorch, the port's counterpart of Pallas interpret mode); on the card it
launches ``csrc/flash_attention.cu`` or raises.  The kernel tiles any
length (``tq``/``tk`` of the TPU kernel are its own tiling now, not
arguments that must divide S), and takes head dims 16, 32, 64, 96, 128
and 256 in bfloat16 or float32.  Its inputs are made contiguous once by
the wrapper (a no-op for the model's projections, which are).
``LAUNCHES`` counts the wrapper's kernel launches; CPU calls never count.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels.build import load_library
from repro_torch.kernels.pi_search import _raise_on

LAUNCHES = {"flash_attention_fwd": 0}

HEAD_DIMS = (16, 32, 64, 96, 128, 256)
_MASK = -1e30
_ENTRY = {torch.bfloat16: "flash_fwd_bf16", torch.float32: "flash_fwd_f32"}
# How far the kernel may be from its plain version on the same tensors:
# |got - want| <= atol + rtol |want|, as (atol, rtol).  The two round at
# the same places over the same key tiles and sum in other orders, so in
# bfloat16 they differ by the output's rounding (one step is at most
# 2^-7 |want|) and by a probability that rounds the other way now and
# then; in float32 by the summation order.  chip_smoke.py prints the
# share of these limits that each of its cases uses on the card.
CARD_TOL = {torch.bfloat16: (1e-3, 2.0 ** -6), torch.float32: (1e-5, 0.0)}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def kv_tile(head_dim: int) -> int:
    """The kernel's key tile at ``head_dim``: 64 keys, 32 at D = 256.  The
    plain version walks the same tiles, so that both round the
    probabilities to v's dtype against the same running max."""
    return 32 if head_dim >= 256 else 64


def card_error(got: torch.Tensor, want: torch.Tensor):
    """(max |got - want|, the largest share of its ``CARD_TOL`` limit that
    an element uses); the kernel agrees with its plain version when the
    share is at most 1."""
    atol, rtol = CARD_TOL[want.dtype]
    got, want = got.float(), want.float()
    err = (got - want).abs()
    share = err / (atol + rtol * want.abs())
    return err.max().item(), share.max().item()


def weak_scalar(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype``, as JAX rounds a weakly typed Python
    scalar next to an array of that dtype.  A tensor op with the result
    then computes what the JAX op computes, and no scalar tensor is copied
    to the card (which would make the host wait for it)."""
    return float(torch.tensor(value, dtype=dtype))


def _scaled_q(q: torch.Tensor) -> torch.Tensor:
    """q * 1/sqrt(D) in q's dtype (JAX's ``(q * scale).astype(q.dtype)``)."""
    return q * weak_scalar(1.0 / math.sqrt(q.shape[-1]), q.dtype)


def flash_attention_fwd_plain(q, k, v, *, causal: bool = True,
                              window: Optional[int] = None,
                              softcap: Optional[float] = None,
                              q_offset: int = 0,
                              kv_chunk: Optional[int] = None):
    """Online-softmax attention over key chunks of ``kv_chunk``, in plain
    PyTorch: the model's ``flash_attention`` (which calls this with its
    chunk of 1024) and the kernel's plain version (by default its tile,
    ``kv_tile(D)``).

    q: (B, Sq, H, Dk), k: (B, Sk, KV, Dk), v: (B, Sk, KV, Dv); KV heads
    broadcast to H (GQA).  ``q_offset`` is the absolute position of
    q[:, 0].  Never materializes more than one (B, H, Sq, kv_chunk) score
    block.  Returns (B, Sq, H, Dv) in q's dtype.
    """
    B, Sq, H, Dk = q.shape
    Sk, KV, Dv = k.shape[1], k.shape[2], v.shape[-1]
    rep = H // KV
    kv_chunk = kv_chunk or kv_tile(Dk)
    q = _scaled_q(q)
    qf = q.float()
    qpos = q_offset + torch.arange(Sq, device=q.device)
    m = torch.full((B, H, Sq), _MASK, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, H, Sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, H, Sq, Dv), dtype=torch.float32, device=q.device)
    for c0 in range(0, Sk, kv_chunk):
        kb = k[:, c0:c0 + kv_chunk].repeat_interleave(rep, dim=2)
        vb = v[:, c0:c0 + kv_chunk].repeat_interleave(rep, dim=2)
        kpos = c0 + torch.arange(kv_chunk, device=q.device)
        s = torch.einsum("bqhd,bkhd->bhqk", qf, kb.float())
        if softcap:
            s = torch.tanh(s / softcap) * softcap
        mask = (kpos[None, :] <= qpos[:, None]) if causal else \
            torch.ones((Sq, kv_chunk), dtype=torch.bool, device=q.device)
        if window is not None:
            mask = mask & (kpos[None, :] > qpos[:, None] - window)
        mask = mask & (kpos[None, :] < Sk)             # the ragged tail
        if s.shape[-1] < kv_chunk:                     # zero-padded keys
            s = torch.nn.functional.pad(s, (0, kv_chunk - s.shape[-1]))
            vb = torch.nn.functional.pad(
                vb, (0, 0, 0, 0, 0, kv_chunk - vb.shape[1]))
        s = s + torch.where(mask, 0.0, _MASK)[None, None]
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bhqk,bkhd->bhqd", p.to(v.dtype).float(), vb.float())
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.transpose(1, 2).to(q.dtype)


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True,
                        window: Optional[int] = None,
                        softcap: Optional[float] = None) -> torch.Tensor:
    """Attention forward: q (B,Sq,H,D), k/v (B,Sk,KV,D) → (B,Sq,H,D) in
    q's dtype.  H % KV == 0; query positions start at 0."""
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape \
            or k.shape[0] != q.shape[0] or k.shape[-1] != q.shape[-1]:
        raise ValueError(f"flash_attention_fwd: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} are not "
                         f"(B,Sq,H,D), (B,Sk,KV,D), (B,Sk,KV,D)")
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    if H % KV:
        raise ValueError(f"flash_attention_fwd: {H} heads over {KV} KV heads")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention_fwd: window {window} < 1")
    if q.device.type == "cpu":
        return flash_attention_fwd_plain(q, k, v, causal=causal,
                                         window=window, softcap=softcap)
    if q.dtype not in _ENTRY or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention_fwd: dtypes {q.dtype}, {k.dtype}, "
                        f"{v.dtype}; the card takes one of bfloat16, float32")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention_fwd: head dim {D} not in "
                         f"{HEAD_DIMS}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("flash_attention_fwd: q, k, v on different devices")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    scale = weak_scalar(1.0 / math.sqrt(D), q.dtype)
    fn = getattr(load_library("flash_attention"), _ENTRY[q.dtype])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                B, Sq, Sk, H, KV, D, int(bool(causal)),
                int(window or 0), ctypes.c_float(float(softcap or 0.0)),
                ctypes.c_float(scale), stream)
    _raise_on("flash_attention_fwd", rc)
    LAUNCHES["flash_attention_fwd"] += 1
    return out


def flash_hbm_bytes(B, Sq, Sk, H, KV, D, Dv, itemsize=2) -> int:
    """Analytic HBM traffic of the kernel: Q + O + (K+V per kv-head ×
    q-tiles that stream them).  The JAX package's formula."""
    q_bytes = B * Sq * H * D * itemsize
    o_bytes = B * Sq * H * Dv * itemsize
    kv_reads = B * H * (Sk * D + Sk * Dv) * itemsize
    return q_bytes + o_bytes + kv_reads
