"""Step builders: train_step / prefill_step / decode_step + input specs.

Counterpart of ``repro.models.steps``.  The JAX package lowers these for
the dry-run and executes them in its training and serving loops; here
they run eagerly, on the parameter tree itself (nested dicts of tensors,
``models.base``), not on ``DenseLM``.  Across ranks the same steps take
DTensors (``train_state_shardings``, ``place_batch``) under
``sharding.use_mesh``.

A train step differentiates ``loss_fn`` with ``torch.autograd.grad`` on
tensors that share the parameters' storage (``loss_and_grad``), then
takes the optimizer step, which writes the new parameters and moments
into the tensors it was given (``optim``): the returned state is the
state passed in, updated.  The abstract state and the input specs are
tensors on the ``meta`` device beside the JAX package's logical-axis
tuples, which ``sharding.tree_shardings`` maps onto a mesh.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from repro_torch import optim
from repro_torch import sharding as shd
from repro_torch.models import decode as dec
from repro_torch.models.decode import cache_logical_axes
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
        else:
            batch = {"tokens": _meta((B, S), i32)}
        if s.kind == "train":
            batch["labels"] = _meta((B, S), i32)
        return batch, {k: BATCH_AXES[k] for k in batch}
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


# the logical axes of a batch leaf (train and prefill), by its key
BATCH_AXES = {"tokens": ("batch", "seq"), "labels": ("batch", "seq"),
              "mask": ("batch", "seq"),
              "embeds": ("batch", "seq", "embed")}


def place_batch(batch, mesh, rules=shd.DEFAULT_RULES):
    """A train or prefill batch (every rank holds the same one: data are
    a function of (seed, step)) as DTensors by ``BATCH_AXES``."""
    return {k: shd.place_tensor(x, mesh, shd.placements_of(
        BATCH_AXES[k], tuple(x.shape), mesh, rules))
        for k, x in batch.items()}


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


def train_state_shardings(cfg: ModelConfig, opt_cfg: optim.OptConfig,
                          mesh, rules=shd.DEFAULT_RULES):
    """``{"params": ..., "opt": ...}``: the ``(mesh, placements)`` of every
    leaf of the train state (the reference's ``tree_shardings`` of
    ``abstract_train_state``'s specs)."""
    params, pspecs, opt_state, ospecs = abstract_train_state(cfg, opt_cfg)
    return {"params": shd.tree_shardings(pspecs, mesh, rules,
                                         shape_tree=params),
            "opt": shd.tree_shardings(ospecs, mesh, rules,
                                      shape_tree=opt_state)}


def init_train_state(cfg: ModelConfig, opt_cfg: optim.OptConfig,
                     generator: torch.Generator, device=None,
                     shardings=None):
    """(params, optimizer state) on ``device`` (default: the card), the
    parameters drawn on the CPU ``generator`` (``init_params``).  With
    ``shardings`` (``train_state_shardings``) every leaf is a DTensor:
    the parameters the same numbers, each rank's block kept; the
    optimizer's zeros made as blocks."""
    if shardings is None:
        params = init_params(model_layout(cfg), generator, cfg.param_dtype,
                             device)
        return params, optim.init(opt_cfg, params)
    params = init_params(model_layout(cfg), generator, cfg.param_dtype,
                         shardings=shardings["params"])
    return params, init_opt_state(cfg, opt_cfg, shardings)


def init_opt_state(cfg: ModelConfig, opt_cfg: optim.OptConfig, shardings):
    """``optim.init``'s state as DTensors placed by ``shardings["opt"]``,
    each rank's block of zeros made where it lives."""
    abstract = optim.init(opt_cfg, abstract_params(model_layout(cfg),
                                                   cfg.param_dtype))

    def zeros(a, sh):
        if isinstance(a, dict):
            return {k: zeros(v, sh[k]) for k, v in a.items()}
        return shd.zeros(tuple(a.shape), a.dtype, *sh)
    return zeros(abstract, shardings["opt"])


# ---------------------------------------------------------------------------
# steps
# ---------------------------------------------------------------------------

def loss_and_grad(cfg: ModelConfig, params, batch):
    """((loss, metrics), grads): ``loss_fn`` and its gradient with respect
    to every leaf of ``params`` (the JAX package's
    ``jax.value_and_grad(loss_fn, argnums=1, has_aux=True)``), taken on
    detached tensors that share the leaves' storage."""
    one = shd.one_rank_mesh(params)
    if one is not None:
        # a one-rank mesh: the one-card program on the whole blocks, bit
        # for bit (wrapping them would only reorder gradient sums)
        (loss, metrics), grads = loss_and_grad(
            cfg, tree_map(shd.local, params), tree_map(shd.local, batch))
        flat = iter(tree_leaves(grads))
        return (loss, metrics), tree_map(lambda p: shd.like(next(flat), p),
                                         params)
    live = tree_map(lambda a: a.detach().requires_grad_(), params)
    with torch.enable_grad():
        loss, metrics = loss_fn(cfg, live, batch)
        # across ranks: a loss every rank holds whole, differentiated
        # once (a partial sum's gradient would count each rank's)
        loss = shd.replicate(loss)
        # a leaf the loss does not read (embed/tok in the embeddings
        # mode) gets zeros, as from JAX
        grads = iter(torch.autograd.grad(loss, tree_leaves(live),
                                         materialize_grads=True))
    # each gradient placed as its parameter: the data-parallel reduction
    # of the partial sums
    grads = tree_map(lambda p: shd.placed_like(next(grads), p), live)
    return (loss.detach(), {k: shd.replicate(v.detach())
                            for k, v in metrics.items()}), grads


def _rows(x, i: int, n: int, key: str):
    """Rows [i n, (i + 1) n) of a batch leaf: a DTensor's gathered and
    placed again by its logical axes (a micro-batch shards like the
    batch)."""
    if not shd.is_dtensor(x):
        return x[i * n:(i + 1) * n]
    rows = shd.full(x)[i * n:(i + 1) * n]
    return shd.place_tensor(rows, x.device_mesh, shd.placements_of(
        BATCH_AXES[key], tuple(rows.shape), x.device_mesh))


def make_train_step(cfg: ModelConfig, opt_cfg: optim.OptConfig,
                    grad_accum: int = 1):
    """(params, opt_state, batch) → (params, opt_state, metrics).  The
    returned state is the one passed in, updated in place."""

    def train_step(params, opt_state, batch):
        if grad_accum > 1:
            n = next(iter(batch.values())).shape[0] // grad_accum
            grads = loss = None
            for i in range(grad_accum):
                mb = {k: _rows(x, i, n, k) for k, x in batch.items()}
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
