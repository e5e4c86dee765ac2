"""Step builders: train_step / prefill_step / decode_step + input specs.

Counterpart of ``repro.models.steps``.  The JAX package lowers these for
the dry-run and executes them in its training and serving loops; here
they run eagerly, on the parameter tree itself (nested dicts of tensors,
``models.base``), not on ``DenseLM``.

A train step differentiates ``loss_fn`` with ``torch.autograd.grad`` on
tensors that share the parameters' storage (``loss_and_grad``), then
takes the optimizer step, which writes the new parameters and moments
into the tensors it was given (``optim``): the returned state is the
state passed in, updated.  The abstract state and the input specs are
tensors on the ``meta`` device beside the JAX package's logical-axis
tuples, which nothing maps onto devices on one card.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from repro_torch import optim
from repro_torch.models import decode as dec
from repro_torch.models.base import (ModelConfig, abstract_params,
                                     init_params, spec_tree, torch_dtype,
                                     tree_leaves, tree_map)
from repro_torch.models.transformer import loss_fn, model_layout


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}

# full-attention archs skip long_500k (quadratic KV); ssm/griffin run it
SUBQUADRATIC_FAMILIES = ("ssm", "griffin")


def shape_applicable(cfg: ModelConfig, shape: str) -> bool:
    if shape == "long_500k":
        return cfg.family in SUBQUADRATIC_FAMILIES
    return True


# ---------------------------------------------------------------------------
# input specs (meta tensors; no allocation)
# ---------------------------------------------------------------------------

def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: str):
    """Abstract inputs (``meta`` tensors) + their logical axes for one
    shape cell."""
    s = SHAPES[shape]
    B, S = s.global_batch, s.seq_len
    i32 = torch.int32
    cdt = torch_dtype(cfg.compute_dtype)
    if s.kind in ("train", "prefill"):
        if cfg.input_mode == "embeddings":
            batch = {"embeds": _meta((B, S, cfg.d_model), cdt)}
            logical = {"embeds": ("batch", "seq", "embed")}
        else:
            batch = {"tokens": _meta((B, S), i32)}
            logical = {"tokens": ("batch", "seq")}
        if s.kind == "train":
            batch["labels"] = _meta((B, S), i32)
            logical["labels"] = ("batch", "seq")
        return batch, logical
    # decode: one new token + a cache of seq_len
    if cfg.input_mode == "embeddings":
        tok = _meta((B, 1, cfg.d_model), cdt)
        tok_logical = ("batch", None, "embed")
    else:
        tok = _meta((B, 1), i32)
        tok_logical = ("batch", None)
    cache = dec.init_cache(cfg, B, S, device="meta")
    batch = {"tokens": tok, "idx": _meta((), i32), "cache": cache}
    logical = {"tokens": tok_logical, "idx": (),
               "cache": cache_logical_axes(cfg, cache)}
    return batch, logical


# the logical axes of a cache leaf, by its key
_CACHE_AXES = {
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
        return _CACHE_AXES.get(name, (None,) * node.dim())
    return axes(cache, None)


# ---------------------------------------------------------------------------
# parameter / optimizer state
# ---------------------------------------------------------------------------

def abstract_train_state(cfg: ModelConfig, opt_cfg: optim.OptConfig):
    """(params, their logical axes, optimizer state, its logical axes),
    the tensors on the ``meta`` device."""
    layout = model_layout(cfg)
    params = abstract_params(layout, cfg.param_dtype)
    pspecs = spec_tree(layout)
    opt_state = optim.init(opt_cfg, params)
    # moments/factors inherit the param logical axes
    return params, pspecs, opt_state, _opt_specs(opt_cfg, pspecs, opt_state)


def _opt_specs(opt_cfg, pspecs, opt_state):
    if opt_cfg.kind == "adafactor":
        def fspec(lg):
            if isinstance(lg, dict):
                return {k: fspec(v) for k, v in lg.items()}
            # row: drop the last dim; col: drop the second-to-last
            if len(lg) >= 2:
                return {"row": tuple(lg[:-1]), "col": tuple(lg[:-2] + lg[-1:])}
            return {"v": tuple(lg)}
        return {"f": fspec(pspecs), "count": ()}
    return {"m": pspecs, "v": pspecs, "count": ()}


def init_train_state(cfg: ModelConfig, opt_cfg: optim.OptConfig,
                     generator: torch.Generator, device=None):
    """(params, optimizer state) on ``device`` (default: the card), the
    parameters drawn on the CPU ``generator`` (``init_params``)."""
    params = init_params(model_layout(cfg), generator, cfg.param_dtype,
                         device)
    return params, optim.init(opt_cfg, params)


# ---------------------------------------------------------------------------
# steps
# ---------------------------------------------------------------------------

def loss_and_grad(cfg: ModelConfig, params, batch):
    """((loss, metrics), grads): ``loss_fn`` and its gradient with respect
    to every leaf of ``params`` (the JAX package's
    ``jax.value_and_grad(loss_fn, argnums=1, has_aux=True)``), taken on
    detached tensors that share the leaves' storage."""
    live = tree_map(lambda a: a.detach().requires_grad_(), params)
    with torch.enable_grad():
        loss, metrics = loss_fn(cfg, live, batch)
        # a leaf the loss does not read (embed/tok in the embeddings
        # mode) gets zeros, as from JAX
        grads = iter(torch.autograd.grad(loss, tree_leaves(live),
                                         materialize_grads=True))
    grads = tree_map(lambda _: next(grads), live)
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()}), \
        grads


def make_train_step(cfg: ModelConfig, opt_cfg: optim.OptConfig,
                    grad_accum: int = 1):
    """(params, opt_state, batch) → (params, opt_state, metrics).  The
    returned state is the one passed in, updated in place."""

    def train_step(params, opt_state, batch):
        if grad_accum > 1:
            n = next(iter(batch.values())).shape[0] // grad_accum
            grads = loss = None
            for i in range(grad_accum):
                mb = {k: x[i * n:(i + 1) * n] for k, x in batch.items()}
                (l, _), g = loss_and_grad(cfg, params, mb)
                if grads is None:
                    grads, loss = g, l
                else:
                    for acc, gi in zip(tree_leaves(grads), tree_leaves(g)):
                        acc.add_(gi)
                    loss = loss + l
                del g
            for g in tree_leaves(grads):
                g.div_(grad_accum)
            metrics = {"loss": loss / grad_accum}
        else:
            (_, metrics), grads = loss_and_grad(cfg, params, batch)
        new_params, new_opt, gnorm = optim.update(opt_cfg, grads, opt_state,
                                                  params)
        metrics = dict(metrics, grad_norm=gnorm)
        return new_params, new_opt, metrics

    return train_step


def make_prefill_step(cfg: ModelConfig, total_len: Optional[int] = None):
    def prefill_step(params, batch):
        with torch.no_grad():
            return dec.prefill(cfg, params, tokens=batch.get("tokens"),
                               embeds=batch.get("embeds"),
                               total_len=total_len)
    return prefill_step


def make_decode_step(cfg: ModelConfig):
    def decode_step(params, batch):
        with torch.no_grad():
            logits, cache = dec.decode_step(cfg, params, batch["cache"],
                                            batch["tokens"], batch["idx"])
        # the first index of the maximum, as jnp.argmax
        next_tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        return next_tok, logits, cache
    return decode_step
