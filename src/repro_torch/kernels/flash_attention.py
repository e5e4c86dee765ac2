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
softmax statistics and the accumulator are float32 (the plain version's
scores are the exact sums rounded once to float32), the output is in q's
dtype.  Masked scores get ``-1e30`` added, not ``-inf``.

``flash_attention_fwd`` routes by the device of its tensors: on the CPU it
runs ``flash_attention_fwd_plain`` (the chunked online softmax in
PyTorch, the port's counterpart of Pallas interpret mode); elsewhere it
calls the operator ``repro_torch::flash_attention_fwd``, which on the
card launches ``csrc/flash_attention.cu`` or raises, and on ``meta``
tensors (the dry run's) only makes its result.  The route there is fixed
by dtype:

* bfloat16 (the model's prefill): ``flash_fwd_kernel``, a Hopper kernel
  whose tensor cores do both products (``wgmma`` from shared memory, the
  operations being what bounds attention: 2.06e11 at phi3's prefill of
  8 x 2048).  A block takes 128 query rows of one head; two consumer
  warpgroups of 64 rows each run S = QK^T and O += PV, taking turns so
  that one's products run under the other's softmax; a producer warp
  feeds k and v tiles of ``kv_tile(D, bfloat16)`` keys (128 up to D = 96,
  64 above) by TMA into a ring of 3 stages (2 at D = 256) of
  ``mbarrier``-guarded shared memory, swizzled by 128 bytes where D is a
  multiple of 64, by 64 at D = 32 and 96 and by 32 at D = 16.  Scores are
  summed in two float32 halves over D and the softmax takes ``expf``, to
  stay near the plain version's exactly rounded scores; the causal rows
  0..63, which see at most 64 keys (there one probability rounded to
  bf16 the other way weighs enough to move the output past
  ``CARD_TOL``), take their scores exactly (bf16 products summed in
  float64 on the float64 tensor cores, rounded once), as the plain
  version does: a second instantiation of the kernel over the first
  query tile, launched as a programmatic dependent of the first, which
  takes the others (one call, one count).
* float32: ``flash_f32_kernel``, FFMAs on the CUDA cores (its bar, 1e-5 of
  the plain version, admits neither TF32 nor bfloat16 operands on the
  tensor cores).  A block of 256 threads takes 128 query rows (64 at
  D >= 128); each half warp owns 8 of them (4), so that every float4 read
  from shared memory feeds 8 to 32 FMAs; k and v tiles of
  ``kv_tile(D, float32)`` keys (64, 32 at D = 256) go by ``cp.async`` into
  two stages, the next tile loading while one computes.

The kernels tile any length (``tq``/``tk`` of the TPU kernel are their
own tiling now, not arguments that must divide S), and take head dims
16, 32, 64, 96, 128 and 256.  Their inputs are made contiguous once by
the wrapper (a no-op for the model's projections, which are), and a
tensor whose base is not 16-byte aligned (TMA's rule) is copied.
``LAUNCHES`` counts the wrapper's kernel launches; CPU calls never count.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

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


def kv_tile(head_dim: int, dtype: torch.dtype) -> int:
    """The kernel's key tile at ``head_dim`` and ``dtype``: in bfloat16
    128 keys up to D = 96, 64 above (the tensor-core kernel); in float32
    64, 32 at D = 256 (the FFMA kernel).  The plain version walks the
    same tiles, so that both round the probabilities to v's dtype against
    the same running max."""
    if dtype == torch.bfloat16:
        return 128 if head_dim <= 96 else 64
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
    ``kv_tile(D, q.dtype)``).

    q: (B, Sq, H, Dk), k: (B, Sk, KV, Dk), v: (B, Sk, KV, Dv); KV heads
    broadcast to H (GQA).  ``q_offset`` is the absolute position of
    q[:, 0].  Never materializes more than one (B, H, Sq, kv_chunk) score
    block.  Returns (B, Sq, H, Dv) in q's dtype.

    Where autograd records, each chunk's body runs under a non-reentrant
    ``torch.utils.checkpoint``, as the JAX model function wraps its scan
    step in ``jax.checkpoint``: the backward recomputes a chunk's scores
    instead of holding every chunk's (4 x 2048 tokens of phi3-mini hold
    ~8 GiB of them a layer).
    """
    B, Sq, H, Dk = q.shape
    Dv = v.shape[-1]
    kv_chunk = kv_chunk or kv_tile(Dk, q.dtype)
    q = _scaled_q(q)
    qd = q.double()
    m = torch.full((B, H, Sq), _MASK, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, H, Sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, H, Sq, Dv), dtype=torch.float32, device=q.device)
    remat = torch.is_grad_enabled() and any(
        x.requires_grad for x in (q, k, v))
    opts = dict(causal=causal, window=window, softcap=softcap,
                q_offset=q_offset, kv_chunk=kv_chunk)
    for c0 in range(0, k.shape[1], kv_chunk):
        if remat:
            m, l, acc = checkpoint(_chunk_step, m, l, acc, qd, k, v, c0,
                                   use_reentrant=False, **opts)
        else:
            m, l, acc = _chunk_step(m, l, acc, qd, k, v, c0, **opts)
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.transpose(1, 2).to(q.dtype)


def _chunk_step(m, l, acc, qd, k, v, c0: int, *, causal, window, softcap,
                q_offset, kv_chunk):
    """One key chunk of the online softmax: (m, l, acc) after keys
    [c0, c0 + kv_chunk) of k and v."""
    Sq, H = qd.shape[1], qd.shape[2]
    Sk, KV = k.shape[1], k.shape[2]
    rep = H // KV
    kb = k[:, c0:c0 + kv_chunk].repeat_interleave(rep, dim=2)
    vb = v[:, c0:c0 + kv_chunk].repeat_interleave(rep, dim=2)
    qpos = q_offset + torch.arange(Sq, device=qd.device)
    kpos = c0 + torch.arange(kv_chunk, device=qd.device)
    # float32 scores rounded once from float64 sums, in which products
    # of bf16 or float32 values are exact (and, for bf16, their sums
    # over D): the reference takes the exact scores, since two float32
    # sums in different orders that round a probability to v's dtype
    # on two sides move a short row's output past CARD_TOL
    s = torch.einsum("bqhd,bkhd->bhqk", qd, kb.double()).float()
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    mask = (kpos[None, :] <= qpos[:, None]) if causal else \
        torch.ones((Sq, kv_chunk), dtype=torch.bool, device=qd.device)
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
    return m_new, l, acc


class FlashAttention(torch.autograd.Function):
    """Attention with a gradient: the forward is ``flash_attention_fwd``
    (the CUDA kernel on the card, its plain version on the CPU); the
    backward recomputes the attention from the saved q, k and v through
    the model's own chunked function, ``flash_attention_fwd_plain`` at
    ``kv_chunk = 1024``, each chunk checkpointed, and differentiates that
    with autograd.  The JAX package likewise differentiates its pure-JAX
    ``flash_attention``; it has no Pallas backward, so neither has the
    port a backward kernel.

    ``FlashAttention.apply(q, k, v, causal, window, softcap)``; under
    ``torch.no_grad()`` it is ``flash_attention_fwd`` alone.
    """

    @staticmethod
    def forward(ctx, q, k, v, causal=True, window=None, softcap=None):
        ctx.opts = dict(causal=causal, window=window, softcap=softcap)
        ctx.save_for_backward(q, k, v)
        return flash_attention_fwd(q, k, v, **ctx.opts)

    @staticmethod
    def backward(ctx, grad_out):
        q, k, v = (x.detach().requires_grad_() for x in ctx.saved_tensors)
        with torch.enable_grad():
            out = flash_attention_fwd_plain(q, k, v, kv_chunk=1024,
                                            **ctx.opts)
            dq, dk, dv = torch.autograd.grad(out, (q, k, v), grad_out)
        return dq, dk, dv, None, None, None


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """``x``, or a fresh copy where its base is not 16-byte aligned (a
    view that starts mid-row): TMA reads only from aligned addresses."""
    return x if x.data_ptr() % 16 == 0 else x.clone()


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
    return torch.ops.repro_torch.flash_attention_fwd(
        q, k, v, bool(causal), window, softcap)


@torch.library.custom_op("repro_torch::flash_attention_fwd", mutates_args=(),
                         device_types="cuda")
def _flash_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool, window: Optional[int],
                        softcap: Optional[float]) -> torch.Tensor:
    """The kernel's launch, as one operator: a dispatch mode (the
    census of ``roofline.census``) sees it whole, and on ``meta`` tensors
    it runs its fake implementation, which allocates the result only."""
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    q, k, v = (_aligned(x.contiguous()) for x in (q, k, v))
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


@_flash_attention_op.register_fake
def _flash_attention_fake(q, k, v, causal, window, softcap):
    return torch.empty_like(q, memory_format=torch.contiguous_format)


def flash_hbm_bytes(B, Sq, Sk, H, KV, D, Dv, itemsize=2) -> int:
    """Analytic HBM traffic of the kernel: Q + O + (K+V per kv-head ×
    q-tiles that stream them).  The JAX package's formula."""
    q_bytes = B * Sq * H * D * itemsize
    o_bytes = B * Sq * H * Dv * itemsize
    kv_reads = B * H * (Sk * D + Sk * Dv) * itemsize
    return q_bytes + o_bytes + kv_reads
