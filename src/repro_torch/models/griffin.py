"""Griffin / RecurrentGemma blocks: RG-LRU recurrence + local (MQA)
attention.

Counterpart of ``repro.models.griffin``.  The layer pattern is
(recurrent, recurrent, attention) in groups (``attn_every`` = 3), then a
tail of ``n_layers % 3`` recurrent layers.  Training and prefill run the
RG-LRU as JAX's ``lax.associative_scan`` runs it, the odd/even recursion
of log2 S rounds of vectorised slices, combines and interleaves (no loop
over time); decode is the O(1) recurrent update, and the local-attention
layers keep a ring cache of the window.  Gate linears are per dimension
(diagonal), the reference's documented simplification.

The recurrence's ``a2 * b1 + b2`` is rounded once (a float64 product and
sum cast back to float32), as XLA's fused multiply-add on the CPU rounds
it: the scan then equals the jitted JAX scan bit for bit there.  The
attention layers go through ``transformer.attn_apply`` with the window,
so a prefill launches the flash kernel once an attention layer on the
card; the rest is plain PyTorch, as the reference is plain ``jnp``.  A
recurrent block's device time falls in the ``record_function`` span
``griffin.rec``, its scan in ``griffin.lru``.  Across ranks the scan runs
on each rank's block of the batch and the lanes (``sharding.local_call``).
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch.profiler import record_function
from torch.utils.checkpoint import checkpoint

from repro_torch import sharding as shd
from repro_torch.models.base import Layout, ModelConfig, ParamDef, tree_map
from repro_torch.models.transformer import (attn_apply, attn_layout,
                                            mlp_apply, mlp_layout, norm,
                                            softplus, unbind_layers)

_C = 8.0  # RG-LRU decay sharpness constant (Griffin paper)
GROUP = ("g_rec0", "g_rec1", "g_attn")


def _rec_layout(cfg: ModelConfig, prefix: str, layers: int) -> Layout:
    d, w = cfg.d_model, cfg.lru_width
    K = cfg.ssm_conv or 4
    L, ll = (layers,), ("layers",)
    return {
        f"{prefix}/w_x": ParamDef(L + (d, w), ll + ("fsdp", "mlp")),
        f"{prefix}/w_gate": ParamDef(L + (d, w), ll + ("fsdp", "mlp")),
        f"{prefix}/conv_w": ParamDef(L + (K, w), ll + (None, "mlp")),
        f"{prefix}/conv_b": ParamDef(L + (w,), ll + ("mlp",), "zeros"),
        f"{prefix}/gate_r": ParamDef(L + (w,), ll + ("mlp",), "zeros"),
        f"{prefix}/bias_r": ParamDef(L + (w,), ll + ("mlp",), "zeros"),
        f"{prefix}/gate_i": ParamDef(L + (w,), ll + ("mlp",), "zeros"),
        f"{prefix}/bias_i": ParamDef(L + (w,), ll + ("mlp",), "zeros"),
        f"{prefix}/lam": ParamDef(L + (w,), ll + ("mlp",), "ones"),
        f"{prefix}/w_out": ParamDef(L + (w, d), ll + ("mlp", "fsdp")),
    }


def _layer_unit_layout(cfg: ModelConfig, kind: str, prefix: str,
                       layers: int) -> Layout:
    """One full layer = temporal block (rec|attn) + MLP + 2 norms."""
    out: Layout = {}
    if kind == "rec":
        out.update(_rec_layout(cfg, f"{prefix}/rec", layers))
    else:
        out.update(attn_layout(cfg, f"{prefix}/attn", layers))
    out.update(mlp_layout(cfg, f"{prefix}/mlp", layers))
    out[f"{prefix}/ln1"] = ParamDef((layers, cfg.d_model), ("layers", None),
                                    "zeros")
    out[f"{prefix}/ln2"] = ParamDef((layers, cfg.d_model), ("layers", None),
                                    "zeros")
    return out


def block_layout(cfg: ModelConfig) -> Layout:
    """Groups of (rec, rec, attn) + a tail of leftover rec layers."""
    G = cfg.n_layers // cfg.attn_every
    tail = cfg.n_layers % cfg.attn_every
    out: Layout = {}
    out.update(_layer_unit_layout(cfg, "rec", "g_rec0", G))
    out.update(_layer_unit_layout(cfg, "rec", "g_rec1", G))
    out.update(_layer_unit_layout(cfg, "attn", "g_attn", G))
    for t in range(tail):
        out.update(_layer_unit_layout(cfg, "rec", f"tail{t}", 1))
    return out


# ---------------------------------------------------------------------------
# RG-LRU
# ---------------------------------------------------------------------------

def _fma(a, b, c):
    """a · b + c rounded once to float32 (XLA's fused multiply-add)."""
    return (a.double() * b.double() + c.double()).float()


def _combine(e1, e2):
    (a1, b1), (a2, b2) = e1, e2
    return a1 * a2, _fma(a2, b1, b2)


def _interleave(even, odd):
    """even[0], odd[0], even[1], ... along dim 1; ``even`` as long as
    ``odd`` or one longer."""
    n = odd.shape[1]
    out = torch.stack([even[:, :n], odd], dim=2).flatten(1, 2)
    return torch.cat([out, even[:, n:]], dim=1) if even.shape[1] > n else out


def _scan(elems):
    """JAX's ``associative_scan`` recursion over dim 1 of the pair
    ``elems`` (``jax/_src/lax/control_flow/loops.py``): combine adjacent
    pairs, scan those, then combine each odd prefix with the next even
    element."""
    n = elems[0].shape[1]
    if n < 2:
        return elems
    reduced = _combine([e[:, 0:-1:2] for e in elems],
                       [e[:, 1::2] for e in elems])
    odd = _scan(reduced)
    if n % 2 == 0:
        even = _combine([e[:, :-1] for e in odd],
                        [e[:, 2::2] for e in elems])
    else:
        even = _combine(odd, [e[:, 2::2] for e in elems])
    even = [torch.cat([e[:, :1], r], dim=1) for e, r in zip(elems, even)]
    return [_interleave(e, o) for e, o in zip(even, odd)]


def _rg_lru_scan(a, b):
    """h_t = a_t · h_{t−1} + b_t over the time axis (dim 1): the pair of
    prefix products of ``a`` and the states."""
    return tuple(_scan([a, b]))


def rec_apply(cfg: ModelConfig, p: Dict, x, cache=None):
    """Recurrent temporal block.  x: (B,S,d).  cache: None, or a dict with
    ``h`` (B,w) float32 and ``conv`` (B,K−1,w) for one decode step.
    Returns (y, (new h, new conv tail)), new tensors."""
    B, S, d = x.shape
    K = cfg.ssm_conv or 4
    u = x @ p["w_x"]                                   # (B,S,w)
    g = F.gelu(x @ p["w_gate"], approximate="tanh")

    if cache is None:
        new_conv = u[:, S - (K - 1):, :]               # prefill carry
        up = F.pad(u, (0, 0, K - 1, 0))
        acc = 0
        for i in range(K):
            acc = acc + up[:, i:i + S, :] * p["conv_w"][i]
        u = acc + p["conv_b"]
    else:
        window = torch.cat([cache["conv"], u], dim=1)
        u = (torch.einsum("bkc,kc->bc", window, p["conv_w"]) +
             p["conv_b"])[:, None]
        new_conv = window[:, 1:, :]

    r = torch.sigmoid(u * p["gate_r"] + p["bias_r"]).float()
    i = torch.sigmoid(u * p["gate_i"] + p["bias_i"]).float()
    log_a = -_C * softplus(p["lam"].float()) * r
    a = torch.exp(log_a)
    gated_in = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a),
                                          1e-6)) * (i * u.float())

    if cache is None:
        with record_function("griffin.lru"):
            lanes = ("batch", None, "mlp")
            _, h = shd.local_call(_rg_lru_scan, (a, gated_in),
                                  (lanes, lanes), (lanes, lanes))
        new_h = h[:, -1]                               # prefill carry
    else:
        h = _fma(a[:, 0], cache["h"], gated_in[:, 0])
        new_h = h
        h = h[:, None]
    y = (h.to(x.dtype) * g) @ p["w_out"]
    return y, (new_h, new_conv)


# ---------------------------------------------------------------------------
# layer units + assembly
# ---------------------------------------------------------------------------

def rec_layer(cfg, p, x, cache=None):
    with record_function("griffin.rec"):
        h, st = rec_apply(cfg, p["rec"], norm(cfg, x, p["ln1"]), cache)
    x = x + h
    x = x + mlp_apply(cfg, p["mlp"], norm(cfg, x, p["ln2"]))
    return shd.constrain(x, "batch", "seq", "embed"), st


def attn_layer(cfg, p, x, positions, cache=None):
    h, kv = attn_apply(cfg, p["attn"], norm(cfg, x, p["ln1"]), positions,
                       cache=cache, window=cfg.sliding_window)
    x = x + h
    x = x + mlp_apply(cfg, p["mlp"], norm(cfg, x, p["ln2"]))
    return shd.constrain(x, "batch", "seq", "embed"), kv


def forward_blocks(cfg: ModelConfig, params, x, positions):
    """The groups in order (the JAX package's ``lax.scan``), each under a
    non-reentrant checkpoint with ``cfg.remat`` while autograd records,
    then the tail's recurrent layers, not rematerialized (as in the
    reference)."""
    remat = cfg.remat and torch.is_grad_enabled()

    def group(p_g, h):
        p_g = shd.gather_fsdp(p_g)
        h, _ = rec_layer(cfg, p_g["g_rec0"], h)
        h, _ = rec_layer(cfg, p_g["g_rec1"], h)
        h, _ = attn_layer(cfg, p_g["g_attn"], h, positions)
        return h

    for p_g in unbind_layers({k: params[k] for k in GROUP}):
        x = checkpoint(shd.bound(group), p_g, x, use_reentrant=False) if remat \
            else group(p_g, x)
    for t in range(cfg.n_layers % cfg.attn_every):
        x, _ = rec_layer(cfg, shd.gather_fsdp(
            tree_map(lambda a: a[0], params[f"tail{t}"])),
                         x)
    return x
