"""Serving paths of the ported families: KV cache, prefill, one-token
decode.

Counterpart of ``repro.models.decode``.  Cache layouts (leaves stacked
over layers):

  dense    : k/v (L,B,T,KV,hd), pos (L,T) — T = window for
             sliding-window archs (a ring buffer), else the cache length
  moe      : the same under "moe" (+ a "dense" stack for the leading
             dense layers)
  mla_moe  : c_kv (L,B,T,kv_lora), k_rope (L,B,T,1,dr) under "moe" and
             "dense" — MLA's compressed cache, written at the absolute
             position (no ring)
  ssm      : ssm (L,B,H,P,N) float32, conv (L,B,K−1,conv_dim)
  griffin  : per group stack: rec h (G,B,w) float32 + conv (G,B,K−1,w)
             under "g_rec0" and "g_rec1", the attention's ring k/v
             (G,B,W,KV,hd) + pos (G,W) under "g_attn", W = min(length,
             window); each tail layer's h and conv (1,...) under
             "tail<t>"

``prefill`` runs the prompt through every layer, GQA attention with the
flash kernel (one launch a layer on the card; MLA takes the plain chunked
attention), and places the captured keys and values, and the recurrent
families' final states and conv tails, in a new cache.  ``decode_step``
writes one position of the cache (or the new states) in place and
attends over it with plain einsums, as the JAX package does outside any
Pallas kernel; the cache dict it returns holds the tensors it was given.

Across ranks (DTensor parameters and inputs under ``sharding.use_mesh``)
both keep the reference's ``constrain`` calls; ``prefill`` returns the
cache placed by ``cache_logical_axes``, and ``decode_step`` writes each
rank's block of it in place.
"""
from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor, Replicate

from repro_torch import sharding as shd
from repro_torch.core.index import _device
from repro_torch.models import griffin as gr
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.base import (ModelConfig, cast_floats, torch_dtype,
                                     tree_map)
from repro_torch.models.transformer import (_check_ported, add_positions,
                                            dense_block_apply, embed_tokens,
                                            norm, unbind_layers, unembed)


def _attn_cache(cfg: ModelConfig, layers: int, B: int, T: int, dtype,
                device):
    KV, hd = cfg.n_kv, cfg.hd
    return {
        "k": torch.zeros((layers, B, T, KV, hd), dtype=dtype, device=device),
        "v": torch.zeros((layers, B, T, KV, hd), dtype=dtype, device=device),
        "pos": torch.full((layers, T), -1, dtype=torch.int32, device=device),
    }


def cache_len(cfg: ModelConfig, seq_len: int) -> int:
    if cfg.sliding_window:
        return min(seq_len, cfg.sliding_window)
    return seq_len


def init_cache(cfg: ModelConfig, B: int, seq_len: int, device=None):
    """An empty cache for ``B`` sequences of up to ``seq_len`` positions,
    on ``device`` (default: the card)."""
    _check_ported(cfg)
    dt, dev = torch_dtype(cfg.compute_dtype), _device(device)
    T = cache_len(cfg, seq_len)
    if cfg.family == "dense":
        return _attn_cache(cfg, cfg.n_layers, B, T, dt, dev)
    if cfg.family == "ssm":
        _, nh, conv_dim = ssm_mod._dims(cfg)
        L = cfg.n_layers
        return {"ssm": torch.zeros((L, B, nh, cfg.ssm_headdim,
                                    cfg.ssm_state), dtype=torch.float32,
                                   device=dev),
                "conv": torch.zeros((L, B, cfg.ssm_conv - 1, conv_dim),
                                    dtype=dt, device=dev)}
    if cfg.family == "griffin":
        G = cfg.n_layers // cfg.attn_every
        K = cfg.ssm_conv or 4
        W = min(seq_len, cfg.sliding_window or seq_len)

        def rec(layers):
            return {"h": torch.zeros((layers, B, cfg.lru_width),
                                     dtype=torch.float32, device=dev),
                    "conv": torch.zeros((layers, B, K - 1, cfg.lru_width),
                                        dtype=dt, device=dev)}
        out = {"g_rec0": rec(G), "g_rec1": rec(G),
               "g_attn": _attn_cache(cfg, G, B, W, dt, dev)}
        for t in range(cfg.n_layers % cfg.attn_every):
            out[f"tail{t}"] = rec(1)
        return out

    def stack(layers):
        if not cfg.use_mla:
            return _attn_cache(cfg, layers, B, T, dt, dev)
        return {"c_kv": torch.zeros((layers, B, T, cfg.kv_lora_rank),
                                    dtype=dt, device=dev),
                "k_rope": torch.zeros((layers, B, T, 1, cfg.qk_rope_dim),
                                      dtype=dt, device=dev)}
    out = {"moe": stack(cfg.n_layers - cfg.first_k_dense)}
    if cfg.first_k_dense:
        out["dense"] = stack(cfg.first_k_dense)
    return out


# the logical axes of a cache leaf, by its key
CACHE_AXES = {
    "k": ("layers", "batch", "kv_seq", "kv_heads", None),      # (L,B,T,KV,hd)
    "v": ("layers", "batch", "kv_seq", "kv_heads", None),
    "c_kv": ("layers", "batch", "kv_seq", None),               # (L,B,T,r)
    "k_rope": ("layers", "batch", "kv_seq", None, None),       # (L,B,T,1,dr)
    "pos": ("layers", None),
    "ssm": ("layers", "batch", "heads", None, None),           # (L,B,H,P,N)
    "conv": ("layers", "batch", None, "mlp"),                  # (L,B,K-1,C)
    "h": ("layers", "batch", "mlp"),                           # (L,B,w)
}


def cache_logical_axes(cfg: ModelConfig, cache):
    """KV caches shard over batch (+ kv_heads); states over batch."""
    def axes(node, name):
        if isinstance(node, dict):
            return {k: axes(v, k) for k, v in node.items()}
        return CACHE_AXES.get(name, (None,) * node.dim())
    return axes(cache, None)


def _constrain_cache(cfg: ModelConfig, cache):
    """Every leaf of a cache constrained by ``cache_logical_axes`` (a
    no-op without a mesh or on one rank)."""
    def walk(node, lg):
        if isinstance(node, dict):
            return {k: walk(v, lg[k]) for k, v in node.items()}
        return shd.constrain(node, *lg)
    return walk(cache, cache_logical_axes(cfg, cache))


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def decode_step(cfg: ModelConfig, params, cache, tokens, idx):
    """One token for the whole batch.  tokens: (B,1) (or embeds (B,1,d));
    idx: the absolute position (an int).  Returns (logits (B,1,V), cache),
    the cache written in place."""
    _check_ported(cfg)
    from repro_torch.models import moe

    params = cast_floats(params, cfg.compute_dtype)
    if cfg.input_mode == "embeddings":
        x = tokens.to(torch_dtype(cfg.compute_dtype))
    else:
        x = embed_tokens(cfg, params, tokens)
    B = x.shape[0]
    idx = int(idx)
    positions = torch.full((B, 1), idx, dtype=torch.int32,
                           device=shd.local(x).device)
    x = add_positions(cfg, x, positions)
    x = shd.constrain(x, "batch", None, "embed")

    def run(layer_fn, block_params, stack):
        """Every layer of one stack, its cache views written in place:
        GQA at the ring slot, MLA at the absolute position."""
        nonlocal x
        for i, p_l in enumerate(unbind_layers(block_params)):
            c_l = {k: c[i] for k, c in stack.items()}
            if cfg.use_mla:
                c_l["idx"] = idx
            else:
                c_l["slot"] = idx % c_l["k"].shape[1]
            x = layer_fn(cfg, p_l, x, positions, cache=c_l)[0]

    def rec(layer_fn, p_l, c_l):
        """One recurrent layer's step, its new state written into the
        cache views ``c_l``."""
        nonlocal x
        x, new = layer_fn(cfg, p_l, x, cache=c_l)
        for name, t in zip(("ssm", "conv") if cfg.family == "ssm"
                           else ("h", "conv"), new):
            shd.copy_into(c_l[name], t)

    def views(stack, i):
        return {k: c[i] for k, c in stack.items()}

    if cfg.family == "dense":
        run(dense_block_apply, params["blocks"], cache)
    elif cfg.family == "ssm":
        for i, p_l in enumerate(unbind_layers(params["blocks"])):
            rec(ssm_mod.block_apply, p_l, views(cache, i))
    elif cfg.family == "griffin":
        slot = idx % cache["g_attn"]["k"].shape[2]
        for i, p_g in enumerate(unbind_layers(
                {k: params["blocks"][k] for k in gr.GROUP})):
            rec(gr.rec_layer, p_g["g_rec0"], views(cache["g_rec0"], i))
            rec(gr.rec_layer, p_g["g_rec1"], views(cache["g_rec1"], i))
            x = gr.attn_layer(cfg, p_g["g_attn"], x, positions,
                              cache=dict(views(cache["g_attn"], i),
                                         slot=slot))[0]
        for t in range(cfg.n_layers % cfg.attn_every):
            rec(gr.rec_layer,
                tree_map(lambda a: a[0], params["blocks"][f"tail{t}"]),
                views(cache[f"tail{t}"], 0))
    else:
        if cfg.first_k_dense:
            run(moe.dense_layer, params["blocks"]["dense"], cache["dense"])
        run(moe.moe_layer, params["blocks"]["moe"], cache["moe"])
    x = norm(cfg, x, params["final_norm"])
    return unembed(cfg, params, x), cache


# ---------------------------------------------------------------------------
# prefill
# ---------------------------------------------------------------------------

def _fill_ring(ks, T):
    """Place captured (L,B,S,...) keys into a (L,B,T,...) ring cache.
    Returns (cache_array, pos (L,T)); a DTensor's blocks are placed
    alike (the sequence is never split), the positions replicated."""
    if isinstance(ks, DTensor):
        cache, pos = _fill_ring(ks.to_local(), T)
        return shd.like(cache, ks), shd.like(
            pos, ks, (Replicate(),) * ks.device_mesh.ndim)
    L, B, S = ks.shape[:3]
    dev = ks.device
    if S <= T:
        cache = ks.new_zeros((L, B, T) + ks.shape[3:])
        cache[:, :, :S] = ks
        pos = torch.cat([torch.arange(S, dtype=torch.int32, device=dev),
                         torch.full((T - S,), -1, dtype=torch.int32,
                                    device=dev)])
    else:
        tailpos = torch.arange(S - T, S, dtype=torch.int32, device=dev)
        slots = (tailpos % T).long()
        cache = ks.new_zeros((L, B, T) + ks.shape[3:])
        cache[:, :, slots] = ks[:, :, S - T:]
        pos = torch.zeros((T,), dtype=torch.int32, device=dev)
        pos[slots] = tailpos
    return cache, pos.expand(L, T).contiguous()


def prefill(cfg: ModelConfig, params, tokens=None, embeds=None,
            total_len: int | None = None):
    """Full-prompt forward that also builds the decode cache.
    Returns (last-token logits (B,1,V), cache)."""
    _check_ported(cfg)
    from repro_torch.models import moe

    params = cast_floats(params, cfg.compute_dtype)
    if cfg.input_mode == "embeddings":
        x = embeds.to(torch_dtype(cfg.compute_dtype))
    else:
        x = embed_tokens(cfg, params, tokens)
    x = shd.constrain(x, "batch", "seq", "embed")
    B, S = x.shape[:2]
    total_len = total_len or S
    T = cache_len(cfg, total_len)
    positions = torch.arange(S, device=shd.local(x).device).expand(B, S)
    x = add_positions(cfg, x, positions)

    def run(layer_fn, block_params):
        """Every layer of one stack → its cache: (k, v, pos) packed into
        the ring, or MLA's (c_kv, k_rope) at positions 0..S-1."""
        nonlocal x
        parts = None
        for p_l in unbind_layers(block_params):
            x, kv = layer_fn(cfg, p_l, x, positions)
            if layer_fn is moe.moe_layer:      # (kv, its lb_loss term)
                kv = kv[0]
            parts = [[] for _ in kv] if parts is None else parts
            for acc, t in zip(parts, kv):
                acc.append(t)
        names = ("c_kv", "k_rope") if cfg.use_mla else ("k", "v")
        out = {}
        for name, acc in zip(names, parts):
            out[name], pos = _fill_ring(torch.stack(acc), T)
            acc.clear()
        if not cfg.use_mla:
            out["pos"] = pos
        return out

    if cfg.family == "dense":
        new_cache = run(dense_block_apply, params["blocks"])
    elif cfg.family == "ssm":
        sts, convs = [], []
        for p_l in unbind_layers(params["blocks"]):
            x, (st, conv) = ssm_mod.block_apply(cfg, p_l, x)
            sts.append(st)
            convs.append(conv)
        new_cache = {"ssm": torch.stack(sts), "conv": torch.stack(convs)}
    elif cfg.family == "griffin":
        W = T if cfg.sliding_window else total_len
        new_cache = {k: {"h": [], "conv": []} for k in gr.GROUP[:2]}
        ks, vs = [], []
        for p_g in unbind_layers({k: params["blocks"][k] for k in gr.GROUP}):
            for k in gr.GROUP[:2]:
                x, (h, conv) = gr.rec_layer(cfg, p_g[k], x)
                new_cache[k]["h"].append(h)
                new_cache[k]["conv"].append(conv)
            x, (k_, v_) = gr.attn_layer(cfg, p_g["g_attn"], x, positions)
            ks.append(k_)
            vs.append(v_)
        new_cache = tree_map(torch.stack, new_cache)
        ck, pos = _fill_ring(torch.stack(ks), W)
        del ks
        cv, _ = _fill_ring(torch.stack(vs), W)
        del vs
        new_cache["g_attn"] = {"k": ck, "v": cv, "pos": pos}
        for t in range(cfg.n_layers % cfg.attn_every):
            x, (ht, cvt) = gr.rec_layer(
                cfg, tree_map(lambda a: a[0], params["blocks"][f"tail{t}"]),
                x)
            new_cache[f"tail{t}"] = {"h": ht[None], "conv": cvt[None]}
    else:
        new_cache = {}
        if cfg.first_k_dense:
            new_cache["dense"] = run(moe.dense_layer,
                                     params["blocks"]["dense"])
        new_cache["moe"] = run(moe.moe_layer, params["blocks"]["moe"])
    x = norm(cfg, x, params["final_norm"])
    logits = unembed(cfg, params, x[:, -1:])
    return logits, _constrain_cache(cfg, new_cache)
