"""Optimizers: AdamW and Adafactor, global-norm clipping, the LR schedule.

Counterpart of ``repro.optim``, as plain functions over the port's nested
dicts of tensors (the JAX package's keys; ``models.base``).

* AdamW with moments in ``moment_dtype`` (bfloat16 halves the optimizer's
  memory, which is what lets phi3-mini's float32 parameters, gradients
  and moments share one 80 GB card).
* Adafactor: factored row/column second moments for leaves of rank >= 2,
  the update clipped to an RMS of 1.
* Global-norm clipping; linear warmup then cosine decay.

Rounding follows the JAX package: the arithmetic is float32 whatever the
leaves' dtypes, cast back once to the parameter's and the moment's dtype;
a Python scalar is rounded to float32 as JAX rounds a weakly typed one.
Leaves are visited in sorted-key order, the order of ``jax.tree.leaves``.

The port updates in place where the JAX package returns new arrays.
``clip_by_global_norm`` scales the gradients it is given, and
``adamw_update`` / ``adafactor_update`` write the new parameters and
moments into the tensors they were given, under ``torch.no_grad()``, and
return those same tensors (the decode cache does the same,
``models/transformer.py::attn_apply``).  A stacked leaf (rank >= 3, the
layers on its leading dim) is updated a layer at a time, so that an
update's float32 temporaries stay the size of one layer's matrix and not
of the stack's (805 M values for phi3-mini's ``blocks/mlp/w_up``).

Across ranks the leaves are DTensors, each gradient placed as its
parameter (``models.steps.loss_and_grad``: the data-parallel reduction).
The global norm sums every leaf's local squares over the mesh dims that
shard it; AdamW updates each rank's blocks in place, a slab at a time as
on one card; Adafactor's factors, which reduce over a sharded dim, are
DTensor operations whose results are redistributed into the state.

``compressed_psum`` is the reference's int8 all-reduce with error
feedback, over a named axis of the mesh in scope (``sharding``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List

import torch

from repro_torch import sharding as shd
from repro_torch.kernels.pi_search import torch_dtype
from repro_torch.models.base import params_from_numpy


@dataclasses.dataclass(frozen=True)
class OptConfig:
    kind: str = "adamw"          # adamw | adafactor
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    moment_dtype: str = "float32"   # bf16 halves optimizer memory
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def _leaves(tree) -> List[torch.Tensor]:
    """The leaves of a nested dict in sorted-key order (``jax.tree.leaves``)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


def _param_nodes(params, tree) -> list:
    """The nodes of ``tree`` that stand where ``params`` has its leaves,
    in the same order (``flatten_up_to`` on the parameters' structure)."""
    if isinstance(params, dict):
        return [x for k in sorted(params)
                for x in _param_nodes(params[k], tree[k])]
    return [tree]


def _tree(tree, fn):
    """``fn`` of every leaf, visited in sorted-key order."""
    if isinstance(tree, dict):
        return {k: _tree(tree[k], fn) for k in sorted(tree)}
    return fn(tree)


def _slabs(x: torch.Tensor):
    """``x`` as views of one layer each where it is a stack of matrices
    (rank >= 3), else ``x`` alone."""
    return x.unbind(0) if x.dim() >= 3 else (x,)


def schedule(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup → cosine decay to min_lr_frac·lr (float32)."""
    step = step.float()
    warm = step / max(cfg.warmup_steps, 1)
    prog = torch.clamp((step - cfg.warmup_steps) /
                       max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * \
        (1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def _sharded_dims(x) -> tuple:
    """The mesh dims of more than one rank over which a DTensor is split
    (none for a plain tensor)."""
    if not shd.is_dtensor(x):
        return ()
    return tuple(m for m, p in enumerate(x.placements)
                 if p.is_shard() and x.device_mesh.size(m) > 1)


def clip_by_global_norm(grads, max_norm: float):
    """Scale ``grads`` in place so that their global norm is at most
    ``max_norm``; returns (grads, the norm before clipping).  A DTensor's
    squares are summed over its block, then over the ranks that split it
    (one sum a set of such mesh dims)."""
    with torch.no_grad():
        parts = {}
        for g in _leaves(grads):
            key = _sharded_dims(g)
            ss = sum(s.float().square().sum()
                     for s in _slabs(shd.local(g)))
            parts[key] = parts.get(key, 0) + ss
        total = 0
        for key, ss in parts.items():
            if key:
                mesh = next(g for g in _leaves(grads)
                            if shd.is_dtensor(g)).device_mesh
                for grp in shd.mesh_groups(mesh, key):
                    ss = shd.group_psum(ss, grp)
            total = total + ss
        gn = torch.sqrt(total)
        scale = torch.clamp(max_norm / torch.clamp_min(gn, 1e-9), max=1.0)
        for g in _leaves(grads):
            shd.local(g).mul_(scale)
    return grads, gn


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def adamw_init(cfg: OptConfig, params):
    mdt = torch_dtype(cfg.moment_dtype)

    def zeros(tree):
        if isinstance(tree, dict):
            return {k: zeros(v) for k, v in tree.items()}
        return torch.zeros(tree.shape, dtype=mdt, device=tree.device)
    device = _leaves(params)[0].device
    return {"m": zeros(params), "v": zeros(params),
            "count": torch.zeros((), dtype=torch.int32, device=device)}


def adamw_update(cfg: OptConfig, grads, state, params):
    """One AdamW step, written into ``params`` and ``state``'s moments
    (each rank's blocks of DTensors)."""
    count = state["count"] + 1
    c = shd.local(count).float()
    lr = schedule(cfg, c)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1 - torch.pow(b1, c)
    bc2 = 1 - torch.pow(b2, c)
    with torch.no_grad():
        for leaf in zip(_leaves(grads), _leaves(state["m"]),
                        _leaves(state["v"]), _leaves(params)):
            for g, m, v, p in zip(*(_slabs(shd.local(x)) for x in leaf)):
                gf = g.float()
                m2 = b1 * m.float() + (1 - b1) * gf
                v2 = b2 * v.float() + (1 - b2) * gf * gf
                step = (m2 / bc1) / (torch.sqrt(v2 / bc2) + cfg.eps)
                step = step + cfg.weight_decay * p.float()
                p.copy_(p.float() - lr * step)
                m.copy_(m2)
                v.copy_(v2)
    return params, {"m": state["m"], "v": state["v"], "count": count}


# ---------------------------------------------------------------------------
# Adafactor (factored second moments for the 100B+ archs)
# ---------------------------------------------------------------------------

def adafactor_init(cfg: OptConfig, params):
    def st(p):
        if isinstance(p, dict):
            return {k: st(v) for k, v in p.items()}
        f32 = dict(dtype=torch.float32, device=p.device)
        if p.dim() >= 2:
            return {"row": torch.zeros(p.shape[:-1], **f32),
                    "col": torch.zeros(p.shape[:-2] + p.shape[-1:], **f32)}
        return {"v": torch.zeros(p.shape, **f32)}
    device = _leaves(params)[0].device
    return {"f": st(params),
            "count": torch.zeros((), dtype=torch.int32, device=device)}


def adafactor_update(cfg: OptConfig, grads, state, params):
    """One Adafactor step, written into ``params`` and ``state``'s
    factors.  The RMS clip reduces over a whole leaf, so a leaf is
    updated at once (as DTensors across ranks: the factors and the clip
    reduce over sharded dims)."""
    count = state["count"] + 1
    c = shd.local(count).float()
    lr = schedule(cfg, c)
    decay = 1.0 - c ** -0.8
    with torch.no_grad():
        for g, f, p in zip(_leaves(grads), _param_nodes(params, state["f"]),
                           _leaves(params)):
            gf = g.float()
            g2 = gf * gf + 1e-30
            if p.dim() >= 2:
                row = decay * f["row"] + (1 - decay) * g2.mean(dim=-1)
                col = decay * f["col"] + (1 - decay) * g2.mean(dim=-2)
                rfac = row / row.mean(dim=-1, keepdim=True)
                v = rfac[..., None] * col[..., None, :]
                shd.copy_into(f["row"], row)
                shd.copy_into(f["col"], col)
            else:
                v = decay * f["v"] + (1 - decay) * g2
                shd.copy_into(f["v"], v)
            step = gf / torch.clamp_min(torch.sqrt(v), 1e-30)
            # update clipping (RMS <= 1) per Adafactor
            rms = torch.sqrt(step.square().mean())
            step = step / torch.clamp_min(rms, 1.0)
            shd.copy_into(p, p.float() * (1 - lr * cfg.weight_decay) -
                          lr * step)
    return params, {"f": state["f"], "count": count}


# ---------------------------------------------------------------------------
# unified interface
# ---------------------------------------------------------------------------

def init(cfg: OptConfig, params):
    return adafactor_init(cfg, params) if cfg.kind == "adafactor" \
        else adamw_init(cfg, params)


def update(cfg: OptConfig, grads, state, params):
    """Clip ``grads`` (in place) and take one step; returns (params,
    state, the gradients' global norm before clipping).  DTensor
    gradients are first redistributed to their parameters' placements
    (partial sums reduced)."""
    flat = iter(_leaves(params))
    grads = _tree(grads, lambda g: shd.placed_like(g, next(flat)))
    grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm)
    if cfg.kind == "adafactor":
        p2, s2 = adafactor_update(cfg, grads, state, params)
    else:
        p2, s2 = adamw_update(cfg, grads, state, params)
    return p2, s2, gnorm


def opt_state_from_numpy(tree, device=None) -> Dict:
    """An optimizer state of numpy arrays (the JAX package's ``optim.init``
    or ``optim.update`` output converted with ``np.asarray``, bfloat16
    moments included) as the port's tensors, leaf for leaf, on ``device``
    (default: the card).  With ``params_from_numpy`` the training state
    of either package feeds the other."""
    if not isinstance(tree, dict) or "count" not in tree or \
            sorted(tree) not in (["count", "m", "v"], ["count", "f"]):
        raise ValueError(f"not an AdamW or Adafactor state: keys "
                         f"{sorted(tree) if isinstance(tree, dict) else tree}")
    return params_from_numpy(tree, device)


# ---------------------------------------------------------------------------
# int8 compression
# ---------------------------------------------------------------------------

def quantize_int8(x: torch.Tensor):
    scale = x.abs().max() / 127.0 + 1e-12
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def compressed_psum(x, axis_name: str, err):
    """The mean of ``x`` over ``axis_name``'s ranks, int8-quantized with
    error feedback → ``(mean, new_err)``.

    The reference's arithmetic: ``quantize_int8`` of ``x + err`` in
    float32, the dequantized values summed over the axis
    (``sharding.psum``, an ``all_reduce``) and divided by its size, and the
    quantization error carried to the next step.  As in the reference the
    sum carries float32 on the wire, not int8 (ROADMAP §C).
    """
    from repro_torch import sharding as shd
    xf = x.float() + err
    q, scale = quantize_int8(xf)
    deq = q.float() * scale
    new_err = xf - deq
    summed = shd.psum(deq, axis_name)
    return summed / shd.axis_size(axis_name), new_err
