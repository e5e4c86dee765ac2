"""Decoder-only transformer substrate, dense family: norms, RoPE, GQA
attention, GLU MLPs, layer-looped assembly.

Counterpart of ``repro.models.transformer``.  Every tensor program is a
function of (cfg, params, inputs), params being the nested dict of the
JAX package's keys with layers stacked on the leading dim of every
``blocks`` leaf; ``DenseLM`` wraps such a tree as an ``nn.Module``.  A
layer is a slice of the stacks, and the layer loop (``_scan_blocks``) is
a Python loop where the JAX package scans.

The full-sequence attention of ``attn_apply`` (the prefill and
``forward`` path) is ``kernels.flash_attention.flash_attention_fwd``: the
CUDA kernel on the card, once per layer, where the JAX package calls the
pure-JAX ``flash_attention``; on the CPU that wrapper runs the plain
chunked version, which ``flash_attention`` below also is.  Decode
attends over the cache with plain einsums, as the JAX package does.

Rounding follows the JAX package: norms compute in float32 and cast back;
a Python scalar that JAX would weakly type to the array's dtype is
rounded to that dtype here too; products that JAX asks for in float32
(``preferred_element_type``) are taken in float32, which relies on
``torch.backends.cuda.matmul.allow_tf32`` being off (PyTorch's default).
Sharding constraints have no counterpart on one card.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels.flash_attention import (flash_attention_fwd,
                                                 flash_attention_fwd_plain,
                                                 weak_scalar)
from repro_torch.models.base import (Layout, ModelConfig, ParamDef,
                                     cast_floats, torch_dtype, tree_map)

# the ROADMAP item that ports each family the port does not serve yet
_FAMILY_ITEM = {"moe": "A10: models/moe.py", "mla_moe": "A10: models/moe.py",
                "ssm": "A10: models/ssm.py", "griffin": "A10: models/griffin.py"}


def _check_dense(cfg: ModelConfig):
    if cfg.family != "dense":
        if cfg.family in _FAMILY_ITEM:
            raise NotImplementedError(
                f"family {cfg.family!r} is not ported yet (ROADMAP "
                f"{_FAMILY_ITEM[cfg.family]})")
        raise ValueError(cfg.family)


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------

def rmsnorm(x, scale, eps=1e-6):
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * (1.0 + scale.float())).to(x.dtype)


def layernorm(x, scale, eps=1e-5):
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, correction=0)  # jnp.var: population
    return ((xf - mu) * torch.rsqrt(var + eps) *
            (1.0 + scale.float())).to(x.dtype)


def norm(cfg: ModelConfig, x, scale):
    return rmsnorm(x, scale) if cfg.norm == "rmsnorm" else layernorm(x, scale)


def rope(x, positions, theta: float):
    """Rotary embedding. x: (..., S, H, D), positions: (..., S)."""
    d = x.shape[-1]
    half = d // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    angle = positions[..., :, None, None].float() * freq  # (...,S,1,half)
    sin, cos = torch.sin(angle), torch.cos(angle)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)
    return out.to(x.dtype)


def act_fn(cfg: ModelConfig, gate, up):
    if cfg.act == "swiglu":
        return F.silu(gate) * up
    if cfg.act == "geglu":
        return F.gelu(gate, approximate="tanh") * up
    return F.gelu(gate, approximate="tanh")  # plain gelu (no up path)


# ---------------------------------------------------------------------------
# chunked attention (plain PyTorch; O(S·chunk) memory)
# ---------------------------------------------------------------------------

def flash_attention(q, k, v, *, causal: bool, q_offset=0,
                    window: Optional[int] = None,
                    softcap: Optional[float] = None,
                    kv_chunk: int = 1024):
    """Online-softmax attention over KV chunks, the model's own version.

    q: (B, Sq, H, Dk)   k: (B, Sk, KV, Dk)   v: (B, Sk, KV, Dv).  KV heads
    are broadcast to H (GQA); ``q_offset`` is the absolute position of
    q[0]; ``window`` limits attention to the last ``window`` positions.
    The oracle of the flash kernel; the same code as its plain version
    (``kernels.flash_attention.flash_attention_fwd_plain``) at the
    model's chunk of 1024.
    """
    return flash_attention_fwd_plain(q, k, v, causal=causal, window=window,
                                     softcap=softcap, q_offset=q_offset,
                                     kv_chunk=kv_chunk)


# ---------------------------------------------------------------------------
# GQA attention layer
# ---------------------------------------------------------------------------

def attn_layout(cfg: ModelConfig, prefix: str, layers: int) -> Layout:
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.hd
    L = (layers,)
    ll = ("layers",)
    out = {
        f"{prefix}/wq": ParamDef(L + (d, H * hd), ll + ("fsdp", "heads")),
        f"{prefix}/wk": ParamDef(L + (d, KV * hd), ll + ("fsdp", "kv_heads")),
        f"{prefix}/wv": ParamDef(L + (d, KV * hd), ll + ("fsdp", "kv_heads")),
        f"{prefix}/wo": ParamDef(L + (H * hd, d), ll + ("heads", "fsdp")),
    }
    if cfg.qk_norm:
        out[f"{prefix}/q_norm"] = ParamDef(L + (hd,), ll + (None,), "zeros")
        out[f"{prefix}/k_norm"] = ParamDef(L + (hd,), ll + (None,), "zeros")
    return out


def attn_apply(cfg: ModelConfig, p: Dict, x, positions, *,
               cache=None, window=None):
    """x: (B,S,d).  cache: None (prefill from scratch: the flash kernel on
    the card) or a dict with k/v (B,T,KV,hd), pos (T,) and slot (decode:
    S == 1 written at ``slot``).

    The decode branch writes the new key, value and position into the
    cache tensors in place, where the JAX package returns new arrays
    (``dynamic_update_slice``); nothing on the serving path reads the old
    cache, and the tensors it returns are the same ones it was given.
    """
    B, S, d = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv, cfg.hd
    q = (x @ p["wq"]).reshape(B, S, H, hd)
    k = (x @ p["wk"]).reshape(B, S, KV, hd)
    v = (x @ p["wv"]).reshape(B, S, KV, hd)
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"])
        k = rmsnorm(k, p["k_norm"])
    if cfg.use_rope:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    if cache is None:
        o = flash_attention_fwd(q, k, v, causal=True, window=window,
                                softcap=cfg.logit_softcap)
        new_cache = (k, v)
    else:
        ck, cv, cpos, slot = cache["k"], cache["v"], cache["pos"], \
            cache["slot"]
        ck[:, slot:slot + S] = k
        cv[:, slot:slot + S] = v
        cpos[slot:slot + S] = positions[0].to(torch.int32)
        rep = H // KV
        kk = ck.repeat_interleave(rep, dim=2) if rep > 1 else ck
        vv = cv.repeat_interleave(rep, dim=2) if rep > 1 else cv
        q = q / weak_scalar(math.sqrt(hd), q.dtype)
        s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kk.float())
        if cfg.logit_softcap:
            s = torch.tanh(s / cfg.logit_softcap) * cfg.logit_softcap
        qpos = positions[0]                                # (S,) S==1
        mask = (cpos[None, :] >= 0) & (cpos[None, :] <= qpos[:, None])
        if window is not None:
            mask = mask & (cpos[None, :] > qpos[:, None] - window)
        s = torch.where(mask[None, None], s, -1e30)
        w = torch.softmax(s, dim=-1).to(vv.dtype)
        o = torch.einsum("bhqk,bkhd->bhqd", w.float(), vv.float()) \
            .transpose(1, 2).to(x.dtype)
        new_cache = (ck, cv, cpos)
    o = o.reshape(B, S, H * hd)
    return o @ p["wo"], new_cache


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def mlp_layout(cfg: ModelConfig, prefix: str, layers: int,
               width: Optional[int] = None) -> Layout:
    d = cfg.d_model
    ff = width or cfg.d_ff
    L = (layers,)
    ll = ("layers",)
    out = {f"{prefix}/w_up": ParamDef(L + (d, ff), ll + ("fsdp", "mlp")),
           f"{prefix}/w_down": ParamDef(L + (ff, d), ll + ("mlp", "fsdp"))}
    if cfg.act in ("swiglu", "geglu"):
        out[f"{prefix}/w_gate"] = ParamDef(L + (d, ff), ll + ("fsdp", "mlp"))
    return out


def mlp_apply(cfg: ModelConfig, p: Dict, x):
    up = x @ p["w_up"]
    if "w_gate" in p:
        h = act_fn(cfg, x @ p["w_gate"], up)
    else:
        h = act_fn(cfg, up, up)
    return h @ p["w_down"]


# ---------------------------------------------------------------------------
# dense decoder block
# ---------------------------------------------------------------------------

def dense_block_layout(cfg: ModelConfig, layers: int) -> Layout:
    out = {}
    out.update(attn_layout(cfg, "attn", layers))
    out.update(mlp_layout(cfg, "mlp", layers))
    out["ln1"] = ParamDef((layers, cfg.d_model), ("layers", None), "zeros")
    out["ln2"] = ParamDef((layers, cfg.d_model), ("layers", None), "zeros")
    return out


def dense_block_apply(cfg: ModelConfig, p: Dict, x, positions, cache=None):
    h, kv = attn_apply(cfg, p["attn"], norm(cfg, x, p["ln1"]), positions,
                       cache=cache, window=cfg.sliding_window)
    x = x + h
    x = x + mlp_apply(cfg, p["mlp"], norm(cfg, x, p["ln2"]))
    return x, kv


# ---------------------------------------------------------------------------
# model assembly
# ---------------------------------------------------------------------------

def model_layout(cfg: ModelConfig) -> Layout:
    _check_dense(cfg)
    out: Layout = {
        "embed/tok": ParamDef((cfg.vocab_padded, cfg.d_model),
                              ("vocab", "embed_fsdp"), "small"),
        "final_norm": ParamDef((cfg.d_model,), (None,), "zeros"),
    }
    if not cfg.tie_embeddings:
        out["lm_head"] = ParamDef((cfg.d_model, cfg.vocab_padded),
                                  ("embed_fsdp", "vocab"))
    for k, v in dense_block_layout(cfg, cfg.n_layers).items():
        out[f"blocks/{k}"] = v
    return out


def embed_tokens(cfg: ModelConfig, params, tokens):
    table = params["embed"]["tok"]
    emb = table.index_select(0, tokens.reshape(-1).long()) \
        .reshape(*tokens.shape, table.shape[-1])
    if cfg.embed_scale:
        emb = emb * weak_scalar(math.sqrt(cfg.d_model), emb.dtype)
    return emb.to(torch_dtype(cfg.compute_dtype))


def sinusoidal_pos(positions, d: int, dtype):
    """Classic sin/cos position embedding (musicgen: no RoPE)."""
    half = d // 2
    freq = torch.exp(-math.log(10_000.0) *
                     torch.arange(half, dtype=torch.float32,
                                  device=positions.device) / half)
    ang = positions[..., None].float() * freq
    out = torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)
    if out.shape[-1] < d:
        out = F.pad(out, (0, d - out.shape[-1]))
    return out.to(dtype)


def add_positions(cfg: ModelConfig, x, positions):
    """Additive position signal for archs without RoPE."""
    if cfg.use_rope or cfg.family in ("ssm",):
        return x
    return x + sinusoidal_pos(positions, cfg.d_model, x.dtype)


def unembed(cfg: ModelConfig, params, x):
    table = params["embed"]["tok"].T if cfg.tie_embeddings else \
        params["lm_head"]
    logits = x @ table.to(x.dtype)
    if cfg.vocab_padded != cfg.vocab:
        # padding slots never win: mask to -1e30 in the logits' dtype
        pad = torch.arange(cfg.vocab_padded, device=logits.device)
        logits = logits + torch.where(pad < cfg.vocab, 0.0, -1e30) \
            .to(logits.dtype)
    return logits


def layer_params(block_params, i: int):
    """Layer ``i`` of the stacked block parameters (views, no copy)."""
    return tree_map(lambda a: a[i], block_params)


def _scan_blocks(cfg: ModelConfig, block_params, x, positions, apply_fn):
    """The layers in order, each a slice of the stacks (the JAX package's
    ``lax.scan``; nothing is rematerialized, there is no backward here)."""
    for i in range(cfg.n_layers):
        x, _ = apply_fn(cfg, layer_params(block_params, i), x, positions)
    return x


def _inputs(cfg: ModelConfig, params, tokens, embeds):
    if cfg.input_mode == "embeddings":
        x = embeds.to(torch_dtype(cfg.compute_dtype))
        if cfg.embed_scale:
            x = x * weak_scalar(math.sqrt(cfg.d_model), x.dtype)
        return x
    return embed_tokens(cfg, params, tokens)


def forward(cfg: ModelConfig, params, tokens=None, embeds=None):
    """Full-sequence forward → (logits, aux) (the prefill-logits path)."""
    _check_dense(cfg)
    params = cast_floats(params, cfg.compute_dtype)
    x = _inputs(cfg, params, tokens, embeds)
    B, S = x.shape[:2]
    positions = torch.arange(S, device=x.device).expand(B, S)
    x = add_positions(cfg, x, positions)
    x = _scan_blocks(cfg, params["blocks"], x, positions, dense_block_apply)
    x = norm(cfg, x, params["final_norm"])
    return unembed(cfg, params, x), {}


class DenseLM(nn.Module):
    """A dense model's parameters as an ``nn.Module``: one ``Parameter``
    per leaf of the JAX tree (``blocks/attn/wq`` → (L, d, H·hd), …),
    registered under the path with ``/`` as ``__``.  ``tree()`` gives the
    nested dict the functions above take; ``forward`` is the module's
    full-sequence forward."""

    def __init__(self, cfg: ModelConfig, params: Dict):
        super().__init__()
        _check_dense(cfg)
        self.cfg = cfg
        self._paths = []

        def walk(node, prefix):
            for k, v in node.items():
                path = f"{prefix}/{k}" if prefix else k
                if isinstance(v, dict):
                    walk(v, path)
                else:
                    self.register_parameter(
                        path.replace("/", "__"),
                        nn.Parameter(v, requires_grad=False))
                    self._paths.append(path)
        walk(params, "")

    def tree(self) -> Dict:
        out: Dict = {}
        for path in self._paths:
            parts = path.split("/")
            node = out
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = getattr(self, path.replace("/", "__"))
        return out

    def forward(self, tokens=None, embeds=None):
        with torch.no_grad():
            return forward(self.cfg, self.tree(), tokens=tokens,
                           embeds=embeds)[0]
