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

``prefill`` runs the prompt through every layer, GQA attention with the
flash kernel (one launch a layer on the card; MLA takes the plain chunked
attention), and places the captured keys and values in a new cache.
``decode_step`` writes one position of the cache in place and attends
over it with plain einsums, as the JAX package does outside any Pallas
kernel; the cache dict it returns holds the tensors it was given.  The
ssm and griffin families raise ``NotImplementedError`` with the ROADMAP
item that ports them.
"""
from __future__ import annotations

import torch

from repro_torch.core.index import _device
from repro_torch.models.base import ModelConfig, cast_floats, torch_dtype
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
    positions = torch.full((B, 1), idx, dtype=torch.int32, device=x.device)
    x = add_positions(cfg, x, positions)

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

    if cfg.family == "dense":
        run(dense_block_apply, params["blocks"], cache)
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
    Returns (cache_array, pos (L,T))."""
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
    B, S = x.shape[:2]
    total_len = total_len or S
    T = cache_len(cfg, total_len)
    positions = torch.arange(S, device=x.device).expand(B, S)
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
    else:
        new_cache = {}
        if cfg.first_k_dense:
            new_cache["dense"] = run(moe.dense_layer,
                                     params["blocks"]["dense"])
        new_cache["moe"] = run(moe.moe_layer, params["blocks"]["moe"])
    x = norm(cfg, x, params["final_norm"])
    logits = unembed(cfg, params, x[:, -1:])
    return logits, new_cache
