"""Serving paths of the dense family: KV cache, prefill, one-token decode.

Counterpart of ``repro.models.decode``.  Cache layout (leaves stacked
over layers):

  dense : k/v (L,B,T,KV,hd), pos (L,T) — T = window for sliding-window
          archs (a ring buffer), else the cache length

``prefill`` runs the prompt through every layer with the flash kernel
(one launch a layer on the card) and places the captured keys and values
in a new cache.  ``decode_step`` writes one position of the cache in
place and attends over it with plain einsums, as the JAX package does
outside any Pallas kernel; the cache dict it returns holds the tensors it
was given.  The other families raise ``NotImplementedError`` with the
ROADMAP item that ports them.
"""
from __future__ import annotations

import torch

from repro_torch.core.index import _device
from repro_torch.models.base import ModelConfig, cast_floats, torch_dtype
from repro_torch.models.transformer import (_check_dense, add_positions,
                                            dense_block_apply, embed_tokens,
                                            layer_params, norm, unembed)


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
    _check_dense(cfg)
    return _attn_cache(cfg, cfg.n_layers, B, cache_len(cfg, seq_len),
                       torch_dtype(cfg.compute_dtype), _device(device))


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def decode_step(cfg: ModelConfig, params, cache, tokens, idx):
    """One token for the whole batch.  tokens: (B,1) (or embeds (B,1,d));
    idx: the absolute position (an int).  Returns (logits (B,1,V), cache),
    the cache written in place."""
    _check_dense(cfg)
    params = cast_floats(params, cfg.compute_dtype)
    if cfg.input_mode == "embeddings":
        x = tokens.to(torch_dtype(cfg.compute_dtype))
    else:
        x = embed_tokens(cfg, params, tokens)
    B = x.shape[0]
    idx = int(idx)
    positions = torch.full((B, 1), idx, dtype=torch.int32, device=x.device)
    x = add_positions(cfg, x, positions)
    slot = idx % cache["k"].shape[2]
    for i in range(cfg.n_layers):
        c_l = {"k": cache["k"][i], "v": cache["v"][i],
               "pos": cache["pos"][i], "slot": slot}
        x, _ = dense_block_apply(cfg, layer_params(params["blocks"], i), x,
                                 positions, cache=c_l)
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
    _check_dense(cfg)
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
    ks, vs = [], []
    for i in range(cfg.n_layers):
        x, (k, v) = dense_block_apply(cfg, layer_params(params["blocks"], i),
                                      x, positions)
        ks.append(k)
        vs.append(v)
    ck, pos = _fill_ring(torch.stack(ks), T)
    del ks
    cv, _ = _fill_ring(torch.stack(vs), T)
    x = norm(cfg, x, params["final_norm"])
    logits = unembed(cfg, params, x[:, -1:])
    return logits, {"k": ck, "v": cv, "pos": pos}
