"""Decoder-only transformer substrate: norms, RoPE, GQA attention, GLU
MLPs, layer-looped assembly of the dense family, and the model entry
points of every family (dense; moe / mla_moe through ``models.moe``, ssm
through ``models.ssm``, griffin through ``models.griffin``).

Counterpart of ``repro.models.transformer``.  Every tensor program is a
function of (cfg, params, inputs), params being the nested dict of the
JAX package's keys with layers stacked on the leading dim of every
``blocks`` leaf (``blocks/dense`` and ``blocks/moe`` stacks for the moe
families, ``blocks/g_rec0`` ... stacks of groups and ``blocks/tail<t>``
for griffin); ``DenseLM`` wraps such a tree as an ``nn.Module``.  A layer
is a view of the stacks, and the layer loop (``_scan_blocks``) is a
Python loop where the JAX package scans.

The full-sequence attention of ``attn_apply`` (the prefill, ``forward``
and training path) is ``kernels.flash_attention.FlashAttention``: its
forward is ``flash_attention_fwd``, the CUDA kernel on the card, once per
layer, where the JAX package calls the pure-JAX ``flash_attention``; on
the CPU that wrapper runs the plain chunked version, which
``flash_attention`` below also is.  Its backward differentiates that
plain version, as the JAX package differentiates its own.  Decode
attends over the cache with plain einsums, as the JAX package does.

Training (``loss_fn``) takes the parameter tree directly: ``steps.py``
detaches its leaves into tensors that require gradients.  With
``cfg.remat`` each layer runs under a non-reentrant
``torch.utils.checkpoint`` while autograd records (JAX's
``nothing_saveable`` policy: a layer saves only its input, and its
backward recomputes it, the attention kernel included).

Rounding follows the JAX package: norms compute in float32 and cast back;
a Python scalar that JAX would weakly type to the array's dtype is
rounded to that dtype here too; products that JAX asks for in float32
(``preferred_element_type``) are taken in float32, which relies on
``torch.backends.cuda.matmul.allow_tf32`` being off (PyTorch's default).

Across ranks (``sharding.use_mesh`` with the parameters and inputs
placed as DTensors, ``sharding.place``) the same functions run on
DTensors, with the reference's ``constrain`` calls at the same points.
The attention runs on each rank's own heads (``on_local_heads``): the
flash kernel, its backward and the decode attention see local tensors.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from torch.utils.checkpoint import checkpoint

from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch import sharding as shd
from repro_torch.kernels.flash_attention import (FlashAttention,
                                                 flash_attention_fwd_plain,
                                                 weak_scalar)
from repro_torch.models.base import (Layout, ModelConfig, ParamDef,
                                     cast_floats, torch_dtype, tree_leaves,
                                     tree_map)

# the families the port serves: every family of the JAX package
PORTED_FAMILIES = ("dense", "moe", "mla_moe", "ssm", "griffin")


def _check_ported(cfg: ModelConfig):
    if cfg.family not in PORTED_FAMILIES:
        raise ValueError(cfg.family)


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------

def rmsnorm(x, scale, eps=1e-6):
    if isinstance(x, DTensor):
        return shd.rowwise(lambda a, b: rmsnorm(a, b, eps), x, scale)
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * (1.0 + scale.float())).to(x.dtype)


def layernorm(x, scale, eps=1e-5):
    if isinstance(x, DTensor):
        return shd.rowwise(lambda a, b: layernorm(a, b, eps), x, scale)
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, correction=0)  # jnp.var: population
    return ((xf - mu) * torch.rsqrt(var + eps) *
            (1.0 + scale.float())).to(x.dtype)


def norm(cfg: ModelConfig, x, scale):
    return rmsnorm(x, scale) if cfg.norm == "rmsnorm" else layernorm(x, scale)


def rope(x, positions, theta: float):
    """Rotary embedding. x: (..., S, H, D), positions: (..., S)."""
    if isinstance(x, DTensor):
        return shd.rowwise(lambda a, pos: rope(a, pos, theta), x,
                           rows=(shd.full(positions),))
    d = x.shape[-1]
    half = d // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    angle = positions[..., :, None, None].float() * freq  # (...,S,1,half)
    sin, cos = torch.sin(angle), torch.cos(angle)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)
    return out.to(x.dtype)


def silu(x):
    """``jax.nn.silu``: x · sigmoid(x)."""
    return x * torch.sigmoid(x)


def softplus(x):
    """``jax.nn.softplus``: logaddexp(x, 0), with its gradient
    sigmoid(x) (also at x = 0)."""
    return torch.logaddexp(x, x.new_zeros(()))


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


def on_local_heads(fn, q, k, v, kv_name: str = "kv_heads"):
    """``fn(q, k, v)`` → (B, Sq, H, Dv), on each rank's own heads when
    ``q`` is a DTensor.

    q is placed by ("batch", -, "heads", -) and k, v by ("batch", -,
    ``kv_name``, -), the sequence whole; ``fn`` takes the local blocks.
    Where the rules shard q's heads but replicate k and v (KV heads that
    the axis does not divide: MQA), each local query head gets its own KV
    head, and the gradients of k and v are partial sums over that axis.
    Plain tensors go to ``fn`` as they are."""
    if not isinstance(q, DTensor):
        return fn(q, k, v)
    mesh = q.device_mesh
    qp = shd.placements_of(("batch", None, "heads", None), q.shape, mesh)
    kp = shd.placements_of(("batch", None, kv_name, None), k.shape, mesh)
    q, k, v = (t if tuple(t.placements) == p else t.redistribute(mesh, p)
               for t, p in ((q, qp), (k, kp), (v, kp)))
    # k, v replicated where q's heads are split: each rank's gradient is
    # its own heads' part
    gp = tuple(Partial() if isinstance(a, Shard) and a.dim == 2 and
               not isinstance(b, Shard) else b for a, b in zip(qp, kp))
    q_l = q.to_local()
    k_l, v_l = (t.to_local(grad_placements=gp) for t in (k, v))
    H, KV, H_l = q.shape[2], k.shape[2], q_l.shape[2]
    if H_l < H and k_l.shape[2] == KV:
        rep = H // KV
        off = shd.block_offset(q, 2)
        if H_l % rep == 0:          # whole groups of query heads
            k_l, v_l = (t[:, :, off // rep:(off + H_l) // rep]
                        for t in (k_l, v_l))
        elif rep % H_l == 0:        # every local head in one group
            k_l, v_l = (t[:, :, off // rep:off // rep + 1]
                        for t in (k_l, v_l))
        else:
            idx = torch.div(off + torch.arange(H_l, device=k_l.device),
                            rep, rounding_mode="floor")
            k_l, v_l = (t.index_select(2, idx) for t in (k_l, v_l))
    o = fn(q_l, k_l, v_l)
    return DTensor.from_local(o, mesh, qp, run_check=False)


def write_cache(dst, t, start: int):
    """``dst[:, start:start + S] = t`` in place: a placed cache's local
    block takes ``t`` redistributed to its placements."""
    if isinstance(dst, DTensor) and isinstance(t, DTensor):
        t = t.redistribute(dst.device_mesh, dst.placements)
    shd.local(dst)[:, start:start + t.shape[1]] = shd.local(t)


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
    """x: (B,S,d).  cache: None (training and prefill from scratch: the
    flash kernel on the card, with a gradient) or a dict with k/v (B,T,KV,hd), pos (T,) and slot (decode:
    S == 1 written at ``slot``).

    The decode branch writes the new key, value and position into the
    cache tensors in place (their local blocks, for a placed cache), where
    the JAX package returns new arrays (``dynamic_update_slice``); nothing
    on the serving path reads the old cache, and the tensors it returns
    are the same ones it was given.
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
    q = shd.constrain(q, "batch", "seq", "heads", None)
    k = shd.constrain(k, "batch", "seq", "kv_heads", None)
    if cache is None:
        o = on_local_heads(lambda q_, k_, v_: FlashAttention.apply(
            q_, k_, v_, True, window, cfg.logit_softcap), q, k, v)
        new_cache = (k, v)
    else:
        ck, cv, cpos, slot = cache["k"], cache["v"], cache["pos"], \
            cache["slot"]
        write_cache(ck, k, slot)
        write_cache(cv, v, slot)
        shd.local(cpos)[slot:slot + S] = positions[0].to(torch.int32)
        cpos_l = shd.local(cpos)
        qpos = positions[0]                                # (S,) S==1
        mask = (cpos_l[None, :] >= 0) & (cpos_l[None, :] <= qpos[:, None])
        if window is not None:
            mask = mask & (cpos_l[None, :] > qpos[:, None] - window)

        def attend(q_, ck_, cv_):
            rep = q_.shape[2] // ck_.shape[2]
            kk = ck_.repeat_interleave(rep, dim=2) if rep > 1 else ck_
            vv = cv_.repeat_interleave(rep, dim=2) if rep > 1 else cv_
            q_ = q_ / weak_scalar(math.sqrt(hd), q_.dtype)
            s = torch.einsum("bqhd,bkhd->bhqk", q_.float(), kk.float())
            if cfg.logit_softcap:
                s = torch.tanh(s / cfg.logit_softcap) * cfg.logit_softcap
            s = torch.where(mask[None, None], s, -1e30)
            w = torch.softmax(s, dim=-1).to(vv.dtype)
            return torch.einsum("bhqk,bkhd->bhqd", w.float(), vv.float()) \
                .transpose(1, 2).to(x.dtype)

        o = on_local_heads(attend, q, ck, cv)
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
    h = shd.constrain(h, "batch", "seq", "mlp")
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
    x = shd.constrain(x, "batch", "seq", "embed")
    return x, kv


# ---------------------------------------------------------------------------
# model assembly
# ---------------------------------------------------------------------------

def model_layout(cfg: ModelConfig) -> Layout:
    _check_ported(cfg)
    # cycle-free: they import this module
    from repro_torch.models import griffin, moe, ssm

    out: Layout = {
        "embed/tok": ParamDef((cfg.vocab_padded, cfg.d_model),
                              ("vocab", "embed_fsdp"), "small"),
        "final_norm": ParamDef((cfg.d_model,), (None,), "zeros"),
    }
    if not cfg.tie_embeddings:
        out["lm_head"] = ParamDef((cfg.d_model, cfg.vocab_padded),
                                  ("embed_fsdp", "vocab"))
    if cfg.family == "dense":
        blocks = dense_block_layout(cfg, cfg.n_layers)
    elif cfg.family == "ssm":
        blocks = ssm.block_layout(cfg, cfg.n_layers)
    elif cfg.family == "griffin":
        blocks = griffin.block_layout(cfg)
    else:
        blocks = moe.block_layout(cfg)
        if cfg.mtp_depth:
            for k, v in moe.mtp_layout(cfg).items():
                out[f"mtp/{k}"] = v
    for k, v in blocks.items():
        out[f"blocks/{k}"] = v
    return out


def lookup(table, tokens):
    """``table[tokens]``: (..., d) rows.  Over a vocab-sharded DTensor
    table each rank takes the tokens in its block of the vocab (0
    elsewhere) and the rows are summed over the ranks that split the
    vocab (one term is not 0: exact), so the table's gradient stays on
    its blocks."""
    if not isinstance(table, DTensor):
        return table.index_select(0, tokens.reshape(-1).long()) \
            .reshape(*tokens.shape, table.shape[-1])
    mesh = table.device_mesh
    vdims = shd.mesh_dims_of(table, 0)
    tpl = tuple(Shard(0) if m in vdims else Replicate()
                for m in range(mesh.ndim))
    if tuple(table.placements) != tpl:
        table = table.redistribute(mesh, tpl)
    if not isinstance(tokens, DTensor):      # every rank's the same
        tokens = DTensor.from_local(tokens, mesh, (Replicate(),) * mesh.ndim,
                                    run_check=False)
    rows = tuple(Replicate() if m in vdims or not p.is_shard() else p
                 for m, p in enumerate(tokens.placements))
    if tuple(tokens.placements) != rows:
        tokens = tokens.redistribute(mesh, rows)
    gp = tuple(Shard(0) if m in vdims else
               Partial() if rows[m].is_shard() else Replicate()
               for m in range(mesh.ndim))
    tbl, tok = table.to_local(grad_placements=gp), tokens.to_local().long()
    off, n = shd.block_offset(table, 0), tbl.shape[0]
    mine = (tok >= off) & (tok < off + n)
    emb = tbl.index_select(0, (tok - off).clamp(0, n - 1).reshape(-1)) \
        .reshape(*tok.shape, tbl.shape[-1])
    emb = torch.where(mine[..., None], emb, 0.0)
    emb = shd.psum_to_all(emb, shd.mesh_groups(mesh, vdims))
    return DTensor.from_local(emb, mesh, rows, run_check=False)


def embed_tokens(cfg: ModelConfig, params, tokens):
    table = params["embed"]["tok"]
    emb = lookup(table, tokens)
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
    return x + shd.replicated(sinusoidal_pos(positions, cfg.d_model,
                                             x.dtype), x)


def unembed(cfg: ModelConfig, params, x):
    table = params["embed"]["tok"].T if cfg.tie_embeddings else \
        params["lm_head"]
    logits = x @ table.to(x.dtype)
    if cfg.vocab_padded != cfg.vocab:
        # padding slots never win: mask to -1e30 in the logits' dtype
        pad = torch.arange(cfg.vocab_padded, device=logits.device)
        logits = logits + shd.replicated(
            torch.where(pad < cfg.vocab, 0.0, -1e30).to(logits.dtype),
            logits)
    return shd.constrain(logits, "batch", "seq", "vocab")


def unbind_layers(block_params):
    """Every layer's parameters at once (views, no copy), by
    ``torch.unbind`` of each stack: as many layers as the stack holds
    (``blocks`` of the dense family, or its ``dense`` and ``moe`` stacks).
    Their gradients are stacked once by ``unbind``'s backward, where a
    slice a layer would scatter each layer's into a zero tensor of the
    whole stack."""
    stacks = tree_map(lambda a: a.unbind(0), block_params)
    n_layers = len(tree_leaves(stacks)[0])
    return [tree_map(lambda t: t[i], stacks) for i in range(n_layers)]


def _scan_blocks(cfg: ModelConfig, block_params, x, positions, apply_fn):
    """The layers in order (the JAX package's ``lax.scan``); with
    ``cfg.remat``, while autograd records, each under a non-reentrant
    checkpoint that saves only its input."""
    remat = cfg.remat and torch.is_grad_enabled()

    def layer(p_l, h):
        return apply_fn(cfg, shd.gather_fsdp(p_l), h, positions)[0]

    for p_l in unbind_layers(block_params):
        x = checkpoint(shd.bound(layer), p_l, x, use_reentrant=False) if remat \
            else layer(p_l, x)
    return x


def _inputs(cfg: ModelConfig, params, tokens, embeds):
    if cfg.input_mode == "embeddings":
        x = embeds.to(torch_dtype(cfg.compute_dtype))
        if cfg.embed_scale:
            x = x * weak_scalar(math.sqrt(cfg.d_model), x.dtype)
        return x
    return embed_tokens(cfg, params, tokens)


def forward(cfg: ModelConfig, params, tokens=None, embeds=None):
    """Full-sequence forward → (logits, aux) (the prefill-logits path).
    ``aux`` is empty but for the moe families, whose holds ``lb_loss``
    and ``h_final`` (``moe.forward_blocks``)."""
    _check_ported(cfg)
    from repro_torch.models import griffin, moe, ssm

    params = cast_floats(params, cfg.compute_dtype)
    x = shd.constrain(_inputs(cfg, params, tokens, embeds),
                      "batch", "seq", "embed")
    B, S = x.shape[:2]
    positions = torch.arange(S, device=x.device).expand(B, S)
    x = add_positions(cfg, x, positions)
    aux = {}
    if cfg.family == "dense":
        x = _scan_blocks(cfg, params["blocks"], x, positions,
                         dense_block_apply)
    elif cfg.family == "ssm":
        x = ssm.forward_blocks(cfg, params["blocks"], x)
    elif cfg.family == "griffin":
        x = griffin.forward_blocks(cfg, params["blocks"], x, positions)
    else:
        x, aux = moe.forward_blocks(cfg, params["blocks"], x, positions)
    x = norm(cfg, x, params["final_norm"])
    return unembed(cfg, params, x), aux


def gold_logits(lf, labels):
    """``lf[..., labels]``: each position's logit of its label.  Over
    vocab-sharded DTensor logits each rank takes the labels in its block
    of the vocab (0 elsewhere) and the blocks are summed over the ranks
    that split the vocab: one term is not 0, so the sum is exact."""
    if not isinstance(lf, DTensor):
        return lf.gather(-1, labels[..., None].long())[..., 0]
    mesh = lf.device_mesh
    vdims = shd.mesh_dims_of(lf, lf.dim() - 1)
    rows = tuple(Replicate() if m in vdims else p
                 for m, p in enumerate(lf.placements))
    if not isinstance(labels, DTensor):
        labels = shd.place_tensor(labels, mesh, rows)
    elif tuple(labels.placements) != rows:
        labels = labels.redistribute(mesh, rows)
    lf_l, lab = lf.to_local(), labels.to_local().long()
    off, n = shd.block_offset(lf, lf.dim() - 1), lf_l.shape[-1]
    mine = (lab >= off) & (lab < off + n)
    g = lf_l.gather(-1, (lab - off).clamp(0, n - 1)[..., None])[..., 0]
    g = torch.where(mine, g, 0.0)
    g = shd.psum_to_all(g, shd.mesh_groups(mesh, vdims))
    return DTensor.from_local(g, mesh, rows, run_check=False)


def logsumexp(lf):
    """``torch.logsumexp(lf, -1)``.  Over vocab-sharded DTensor logits each
    rank sums ``exp(lf - m)`` over its block (``m`` the maximum over the
    ranks that split the vocab) and the sums are added over those ranks:
    the logits are never gathered."""
    if not isinstance(lf, DTensor):
        return torch.logsumexp(lf, dim=-1)
    mesh = lf.device_mesh
    vdims = shd.mesh_dims_of(lf, lf.dim() - 1)
    groups = shd.mesh_groups(mesh, vdims)
    if not groups:
        return shd.rowwise(lambda a: torch.logsumexp(a, dim=-1)[..., None],
                           lf)[..., 0]
    rows = tuple(Replicate() if m in vdims else p
                 for m, p in enumerate(lf.placements))
    lf_l = lf.to_local()
    m = lf_l.detach().amax(dim=-1)
    for g in groups:
        m = shd.group_pmax(m, g)
    tot = shd.psum_to_all(torch.exp(lf_l - m[..., None]).sum(dim=-1), groups)
    return DTensor.from_local(torch.log(tot) + m, mesh, rows,
                              run_check=False)


def loss_fn(cfg: ModelConfig, params, batch):
    """Causal LM loss → (loss, metrics): the mean over ``batch["mask"]``
    (all ones when absent) of logsumexp − the gold logit, in float32
    (``nll``); the moe families add 0.01 x the load-balance loss
    (``lb_loss``) and, with ``mtp_depth`` and an ``mtp`` tree, 0.3 x the
    MTP loss (``mtp_loss``); ``loss`` is the sum."""
    from repro_torch.models import moe

    logits, aux = forward(cfg, params, tokens=batch.get("tokens"),
                          embeds=batch.get("embeds"))
    labels = batch["labels"]
    lf = logits.float()
    nll = logsumexp(lf) - gold_logits(lf, labels)
    mask = batch.get("mask")
    if mask is None:
        mask = torch.ones_like(nll)
    loss = (nll * mask).sum() / torch.clamp_min(mask.sum(), 1.0)
    metrics = {"nll": loss}
    if aux.get("lb_loss") is not None:
        loss = loss + 0.01 * aux["lb_loss"]
        metrics["lb_loss"] = aux["lb_loss"]
    if cfg.mtp_depth and "mtp" in params:
        mtp_loss = moe.mtp_loss(cfg, params, batch, aux["h_final"])
        loss = loss + 0.3 * mtp_loss
        metrics["mtp_loss"] = mtp_loss
    metrics["loss"] = loss
    return loss, metrics


class DenseLM(nn.Module):
    """A model's parameters as an ``nn.Module`` (any family's tree):
    one ``Parameter``
    per leaf of the JAX tree (``blocks/attn/wq`` → (L, d, H·hd), …),
    registered under the path with ``/`` as ``__``.  ``tree()`` gives the
    nested dict the functions above take; ``forward`` is the module's
    full-sequence forward, without gradients.  Training does not go
    through the module: ``models.steps`` takes the parameter tree itself
    (``init_train_state``, ``make_train_step``)."""

    def __init__(self, cfg: ModelConfig, params: Dict):
        super().__init__()
        _check_ported(cfg)
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
