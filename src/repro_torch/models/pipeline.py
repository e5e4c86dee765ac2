"""Pipeline parallelism: GPipe-style microbatch pipelining over a mesh
axis, one process a stage.

Counterpart of ``repro.models.pipeline``.  The layers are split into S
stages along a mesh axis, and M >= S microbatches stream through with
the GPipe schedule (bubble fraction (S-1)/(M+S-1)).  The reference's
rotating-buffer ``shard_map`` body becomes a function that every rank
runs on its own stage: each step every stage runs its layers on its
current microbatch slot, then the activations rotate one stage forward
(``sharding.ppermute`` over the axis's process group); outputs gather on
the last stage, and a ``psum`` of its one-hot contribution gives them to
every rank.  The reference's ``lax.scan`` over the M + S - 1 steps is a
Python loop with the same feed and emit conditions.

Every rank holds the same ``stage_params`` (a leading dim of S on every
leaf) and microbatches; a rank takes its stage's slice.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch import sharding as shd
from repro_torch.models.base import tree_map


def pipelined_forward(mesh, axis: str, stage_fn: Callable, stage_params,
                      x_microbatches: torch.Tensor) -> torch.Tensor:
    """Run M microbatches through the S stages of ``axis``.

    Args:
      mesh/axis: a ``DeviceMesh`` and its axis carrying stages (size S).
      stage_fn:  (stage_params_for_one_stage, x) → x  (one stage's layers).
      stage_params: nested dict with leading dim S on every leaf.
      x_microbatches: (M, mb, ...) activations, M >= S.

    Returns the (M, mb, ...) outputs on every rank: those of applying the
    stages in sequence to each microbatch.
    """
    S = shd.axis_size(axis, mesh)
    sidx = shd.axis_index(axis, mesh)
    M = x_microbatches.shape[0]
    assert M >= S, f"need at least S={S} microbatches, got {M}"
    fwd_perm = [(i, (i + 1) % S) for i in range(S)]
    group = shd.axis_group(axis, mesh)
    p_local = tree_map(lambda a: a[sidx], stage_params)
    buf = torch.zeros_like(x_microbatches[0])          # current slot
    out = torch.zeros_like(x_microbatches)
    for t in range(M + S - 1):
        if sidx == 0 and t < M:                        # stage 0 ingests t
            buf = x_microbatches[t]
        y = stage_fn(p_local, buf)
        emit = t - (S - 1)                             # last stage emits
        if sidx == S - 1 and 0 <= emit < M:
            out[emit] = y
        buf = shd.group_ppermute(y, group, fwd_perm)   # one stage forward
    contrib = out if sidx == S - 1 else torch.zeros_like(out)
    return shd.group_psum(contrib, group)


def stage_split(params, n_stages: int):
    """Reshape (L, ...) stacked layer params to (S, L/S, ...)."""
    def r(a):
        L = a.shape[0]
        assert L % n_stages == 0, (L, n_stages)
        return a.reshape((n_stages, L // n_stages) + tuple(a.shape[1:]))
    return tree_map(r, params)


def bubble_fraction(n_stages: int, n_microbatches: int) -> float:
    return (n_stages - 1) / (n_microbatches + n_stages - 1)
