"""Mamba-2 (SSD — state-space duality) blocks, chunked-parallel form.

Counterpart of ``repro.models.ssm``.  Training and prefill take the SSD
block decomposition: the intra-chunk dual form (dense products over a
chunk) and the inter-chunk linear recurrence, a Python loop over the
chunks where the JAX package runs ``lax.scan``.  Decode is the O(1)
recurrent update of a float32 state.

The reference's einsums mix the compute dtype (``x``, ``B``, ``C``) with
float32 (``dt``, the decays, ``L``), which JAX promotes to float32; each
product here casts its operands to float32 the same way, and keeps the
reference's one downcast, of the carried states to ``x``'s dtype before
the off-diagonal product.  Everything is plain PyTorch (the matrix
products are cuBLAS on the card), as the reference is plain ``jnp``: no
Pallas kernel is reached there, and this module launches no kernel of
its own.  Each phase of ``block_apply`` runs in a
``torch.profiler.record_function`` span (``ssm.in_proj``, ``ssm.conv``,
``ssm.intra``, ``ssm.inter``, ``ssm.out_proj``) by which a profile splits
a block's device time.  Across ranks ``ssd_chunked`` runs on each rank's
batch block (``sharding.local_call``).
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch.profiler import record_function
from torch.utils.checkpoint import checkpoint

from repro_torch import sharding as shd
from repro_torch.models.base import Layout, ModelConfig, ParamDef
from repro_torch.models.transformer import (norm, rmsnorm, silu, softplus,
                                            unbind_layers)


def _dims(cfg: ModelConfig):
    din = cfg.ssm_expand * cfg.d_model
    nh = din // cfg.ssm_headdim
    conv_dim = din + 2 * cfg.ssm_state
    return din, nh, conv_dim


def block_layout(cfg: ModelConfig, layers: int) -> Layout:
    d, n = cfg.d_model, cfg.ssm_state
    din, nh, conv_dim = _dims(cfg)
    L, ll = (layers,), ("layers",)
    return {
        "in_proj": ParamDef(L + (d, 2 * din + 2 * n + nh),
                            ll + ("fsdp", "mlp")),
        "conv_w": ParamDef(L + (cfg.ssm_conv, conv_dim),
                           ll + (None, "mlp")),
        "conv_b": ParamDef(L + (conv_dim,), ll + ("mlp",), "zeros"),
        "A_log": ParamDef(L + (nh,), ll + (None,), "zeros"),
        "D": ParamDef(L + (nh,), ll + (None,), "ones"),
        "dt_bias": ParamDef(L + (nh,), ll + (None,), "zeros"),
        "gate_norm": ParamDef(L + (din,), ll + ("mlp",), "zeros"),
        "out_proj": ParamDef(L + (din, d), ll + ("mlp", "fsdp")),
        "ln": ParamDef(L + (d,), ll + (None,), "zeros"),
    }


def _causal_conv(x, w, b):
    """Depthwise causal conv1d.  x: (B,S,C), w: (K,C).  The K terms are
    added in the reference's order, from 0."""
    K, S = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, K - 1, 0))
    out = 0
    for i in range(K):
        out = out + xp[:, i:i + S, :] * w[i]
    return silu(out + b)


class _SegmentDiff(torch.autograd.Function):
    """seg[..., i, j, :] = cs[..., i, :] - cs[..., j, :] of a chunk's
    cumulative decays ``cs`` (b, nc, chunk, h) in float64, subtracted in
    float64 and written once in float32: the (b, nc, chunk, chunk, h)
    differences are never held in float64.  The gradient sums their rows
    and columns in float64."""

    @staticmethod
    def forward(ctx, cs):
        b, nc, cl, h = cs.shape
        seg = cs.new_empty((b, nc, cl, cl, h), dtype=torch.float32)
        return torch.sub(cs[:, :, :, None, :], cs[:, :, None, :, :], out=seg)

    @staticmethod
    def backward(ctx, g):
        return g.sum(3, dtype=torch.float64) - g.sum(2, dtype=torch.float64)


def ssd_chunked(xh, dt, A, Bm, Cm, chunk: int):
    """SSD over chunks.  xh: (B,S,H,P), dt: (B,S,H) float32, A: (H,)
    float32, Bm/Cm: (B,S,N) (one group, shared across heads); S a
    multiple of ``chunk``.  Returns ((B,S,H,P) float32, the final state
    (B,H,P,N) float32)."""
    b, s, h, p_ = xh.shape
    n = Bm.shape[-1]
    nc = s // chunk
    x = xh.reshape(b, nc, chunk, h, p_).float()
    dt = dt.reshape(b, nc, chunk, h)
    B_ = Bm.reshape(b, nc, chunk, n)
    C_ = Cm.reshape(b, nc, chunk, n)

    dA = dt * A                     # (b,nc,cl,h) negative decays
    # the cumulative decays and their differences in float64, rounded
    # once: a float32 difference of two sums near -90 loses ~1e-5, and
    # CUDA's float32 cumsum rounds apart from the CPU's, which accumulates
    # in float64
    cs64 = torch.cumsum(dA.double(), dim=2)
    cs = cs64.float()

    with record_function("ssm.intra"):
        # intra-chunk: Y_diag[i] = Σ_{j<=i} (C_i·B_j) dt_j exp(cs_i − cs_j) x_j
        seg = _SegmentDiff.apply(cs64)                      # (b,nc,i,j,h)
        tri = torch.ones(chunk, chunk, dtype=torch.bool,
                         device=xh.device).tril()
        # the reference's where(tri, exp(seg), 0) in value; masking seg to
        # -inf before the exp keeps the masked exp(seg), which overflows
        # once a chunk's decays pass 88, out of the gradient (0 * inf)
        L = torch.exp(seg.masked_fill_(~tri[None, None, :, :, None],
                                       float("-inf")))
        del seg
        scores = torch.einsum("bcin,bcjn->bcij", C_, B_)    # compute dtype
        M = scores[..., None] * L                           # float32
        del L
        W = (M * dt[:, :, None]).permute(0, 1, 4, 2, 3)     # (b,nc,h,i,j)
        del M
        Y_diag = torch.matmul(W, x.permute(0, 1, 3, 2, 4)) \
            .permute(0, 1, 3, 2, 4)                         # (b,nc,i,h,p)
        del W
        # chunk summary states (b,nc,h,p,n)
        decay_states = torch.exp((cs64[:, :, -1:, :] - cs64).float())
        xw = ((dt * decay_states)[..., None] * x).reshape(b, nc, chunk,
                                                           h * p_)
        states = torch.matmul(xw.transpose(2, 3), B_.float()) \
            .reshape(b, nc, h, p_, n)
        del xw

    with record_function("ssm.inter"):
        # inter-chunk recurrence: S_c = S_{c-1} · decay_c + states_c, each
        # chunk reading the state before it
        chunk_decay = torch.exp(cs[:, :, -1, :])            # (b,nc,h)
        state = torch.zeros((b, h, p_, n), dtype=torch.float32,
                            device=xh.device)
        prevs = []
        for c in range(nc):
            prevs.append(state)
            state = state * chunk_decay[:, c, :, None, None] + states[:, c]
        S_prevs = torch.stack(prevs, 1)                     # (b,nc,h,p,n)
        # off-diagonal (cross-chunk) contribution, the states in x's dtype
        S_t = S_prevs.to(xh.dtype).float().permute(0, 1, 4, 2, 3) \
            .reshape(b, nc, n, h * p_)
        Y_off = torch.matmul(C_.float(), S_t).reshape(b, nc, chunk, h, p_)
        Y_off = Y_off * torch.exp(cs)[..., None]            # (b,nc,l,h,p)
    return (Y_diag + Y_off).reshape(b, s, h, p_), state


def block_apply(cfg: ModelConfig, p: Dict, x, cache=None):
    """One mamba2 block.  cache=None → chunked train/prefill; a dict with
    ``ssm`` (B,H,P,N) float32 and ``conv`` (B,K-1,conv_dim) → one decode
    step.  Returns (x, (new ssm state, new conv tail)), new tensors."""
    B_, S, d = x.shape
    din, nh, conv_dim = _dims(cfg)
    n = cfg.ssm_state
    hp = cfg.ssm_headdim
    K = cfg.ssm_conv

    res = x
    with record_function("ssm.in_proj"):
        x = norm(cfg, x, p["ln"])
        zxbcdt = x @ p["in_proj"]
        z = zxbcdt[..., :din]
        xBC = zxbcdt[..., din:din + conv_dim]
        dt_raw = zxbcdt[..., din + conv_dim:]
        A = -torch.exp(p["A_log"].float())
        dt = softplus(dt_raw.float() + p["dt_bias"])

    if cache is None:
        conv_tail = xBC[:, S - (K - 1):, :]                 # prefill carry
        with record_function("ssm.conv"):
            xBC = _causal_conv(xBC, p["conv_w"], p["conv_b"])
        xs = xBC[..., :din].reshape(B_, S, nh, hp)
        Bm = xBC[..., din:din + n]
        Cm = xBC[..., din + n:]
        # pad to a chunk multiple with dt=0 (decay 1, zero contribution)
        # so the carried state is exact for any S
        Sp = -(-S // cfg.ssm_chunk) * cfg.ssm_chunk
        xs_p, Bm, Cm, dt_p = xs, Bm, Cm, dt
        if Sp != S:
            pad = Sp - S
            xs_p = F.pad(xs, (0, 0, 0, 0, 0, pad))
            Bm = F.pad(Bm, (0, 0, 0, pad))
            Cm = F.pad(Cm, (0, 0, 0, pad))
            dt_p = F.pad(dt, (0, 0, 0, pad))
        bsn = ("batch", None, None)
        y, final_state = shd.local_call(
            lambda *a: ssd_chunked(*a, cfg.ssm_chunk),
            (xs_p, dt_p, A, Bm, Cm),
            (bsn + (None,), bsn, (None,), bsn, bsn),
            (bsn + (None,), bsn + (None,)))
        y = y[:, :S] + p["D"][None, None, :, None] * xs
        new_cache = (final_state, conv_tail)
    else:
        with record_function("ssm.conv"):
            # conv: append the current input, take the window of K
            window = torch.cat([cache["conv"], xBC], dim=1)  # (B,K,conv)
            xBC = silu(torch.einsum("bkc,kc->bc", window, p["conv_w"]) +
                       p["conv_b"])[:, None, :]
            new_conv = window[:, 1:, :]
        with record_function("ssm.inter"):
            xs = xBC[..., :din].reshape(B_, 1, nh, hp)
            Bm = xBC[:, 0, din:din + n].float()             # (B,n)
            Cm = xBC[:, 0, din + n:].float()
            dAe = torch.exp(dt[:, 0] * A)                   # (B,nh)
            upd = (xs[:, 0].float() * dt[:, 0, :, None])[..., None] * \
                Bm[:, None, None, :]                        # (B,nh,hp,n)
            new_state = cache["ssm"] * dAe[:, :, None, None] + upd
            y = torch.einsum("bn,bhpn->bhp", Cm, new_state)[:, None]
            y = y.to(x.dtype) + p["D"][None, None, :, None] * xs
        new_cache = (new_state, new_conv)

    with record_function("ssm.out_proj"):
        y = y.reshape(B_, S, din).to(res.dtype)  # SSD runs f32; back to x's
        y = rmsnorm(y * silu(z), p["gate_norm"])
        out = y @ p["out_proj"]
    return res + shd.constrain(out, "batch", "seq", "embed"), new_cache


def forward_blocks(cfg: ModelConfig, params, x):
    """Every block in order (the JAX package's ``lax.scan``); with
    ``cfg.remat``, while autograd records, each under a non-reentrant
    checkpoint that saves only its input (``nothing_saveable``)."""
    remat = cfg.remat and torch.is_grad_enabled()

    def block(p_l, h):
        return block_apply(cfg, shd.gather_fsdp(p_l), h)[0]

    for p_l in unbind_layers(params):
        x = checkpoint(shd.bound(block), p_l, x, use_reentrant=False) if remat \
            else block(p_l, x)
    return x
