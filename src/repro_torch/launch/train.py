"""Fault-tolerant training driver.

Counterpart of ``repro.launch.train``, on one card:

  * a checkpoint every ``ckpt_every`` steps (written on a background
    thread unless ``sync_ckpt``), published atomically; a restart resumes
    from the newest complete checkpoint, at the step after it (torn saves
    are skipped);
  * **straggler watchdog**: a step slower than ``straggler_factor`` x
    the median of the trailing eight steps is logged in
    ``straggler_steps``;
  * **stateless data**: batches are functions of (seed, step), so a
    resumed run sees the batches an uninterrupted one would
    (``repro_torch.data``);
  * **failure injection** (``fail_at_step``) for the restart tests.

The loss is read once a step (``float``), the step's one host sync, as
the JAX loop does.  ``mesh`` is ``None`` (the card, or ``device``) or the
port's ``core.distributed.Mesh`` of one rank, which places every leaf of
the state, restored ones included, on its device; a mesh over several
ranks raises (ROADMAP A13, the LM across cards).
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from repro_torch import checkpoint as ckpt_mod
from repro_torch import data as data_mod
from repro_torch import optim
from repro_torch.core.distributed import Mesh, make_mesh
from repro_torch.core.index import _device
from repro_torch.models import (abstract_train_state, init_train_state,
                                make_train_step)
from repro_torch.models.base import ModelConfig


@dataclasses.dataclass
class TrainLoopConfig:
    steps: int = 20
    ckpt_every: int = 5
    ckpt_dir: str = os.path.join("build", "train_ckpt")
    log_every: int = 1
    straggler_factor: float = 3.0
    fail_at_step: Optional[int] = None      # failure injection (tests)
    grad_accum: int = 1
    seed: int = 0
    sync_ckpt: bool = False   # block on saves (async loses the in-flight
                              # save on a crash — correct, but racy tests)


@dataclasses.dataclass
class TrainResult:
    final_step: int
    losses: list
    straggler_steps: list
    restored_from: Optional[int]


def _train_device(mesh, device) -> torch.device:
    if mesh is None:
        return _device(device)
    if isinstance(mesh, (list, tuple)):     # devices: one, or raise
        mesh = make_mesh((len(mesh),), ("data",), device=mesh)
    if not isinstance(mesh, Mesh):
        raise TypeError(f"mesh {mesh!r} is not a core.distributed.Mesh")
    if any(mesh.ranks(a) > 1 for a in mesh.axis_names):
        raise NotImplementedError(
            "training over a mesh of several ranks needs the LM's tensors "
            "placed over it, not ported yet (ROADMAP A13, the LM across "
            "cards)")
    return mesh.device


def train(cfg: ModelConfig, opt_cfg: optim.OptConfig,
          loop: TrainLoopConfig, dcfg: data_mod.DataConfig,
          mesh=None, hooks: Optional[Dict[str, Callable]] = None,
          device=None) -> TrainResult:
    """Run (or resume) a training loop; survives a restart mid-run.
    ``hooks``: ``pre_step(step)`` inside the timed window, ``log(step,
    loss, seconds)`` every ``log_every`` steps."""
    hooks = hooks or {}
    dev = _train_device(mesh, device)
    mgr = ckpt_mod.CheckpointManager(loop.ckpt_dir)
    restored_from = None
    if mgr.latest_step() is not None:
        params, _, opt_state, _ = abstract_train_state(cfg, opt_cfg)
        step0, state = mgr.restore_latest(
            {"params": params, "opt": opt_state}, device=dev)
        restored_from, start = step0, step0 + 1
    else:
        gen = torch.Generator().manual_seed(loop.seed)
        params, opt_state = init_train_state(cfg, opt_cfg, gen, dev)
        state = {"params": params, "opt": opt_state}
        start = 0

    train_step = make_train_step(cfg, opt_cfg, grad_accum=loop.grad_accum)
    losses, stragglers, durations = [], [], []
    for step in range(start, loop.steps):
        if loop.fail_at_step is not None and step == loop.fail_at_step:
            raise RuntimeError(f"injected failure at step {step}")
        batch = data_mod.lm_batch(dcfg, step, device=dev)
        t0 = time.perf_counter()
        if "pre_step" in hooks:       # inside the timed window: the hook
            hooks["pre_step"](step)   # simulates slow devices in tests
        p, o, metrics = train_step(state["params"], state["opt"], batch)
        loss = float(metrics["loss"])
        dt = time.perf_counter() - t0
        state = {"params": p, "opt": o}
        losses.append(loss)
        durations.append(dt)
        # straggler watchdog: compare against the trailing median
        if len(durations) >= 4:
            med = float(np.median(durations[-8:]))
            if dt > loop.straggler_factor * med:
                stragglers.append(step)
        if step % loop.ckpt_every == 0 and step > 0:
            mgr.save(step, state, blocking=loop.sync_ckpt,
                     meta={"loss": loss})
        if step % loop.log_every == 0 and "log" in hooks:
            hooks["log"](step, loss, dt)
    mgr.save(loop.steps - 1, state, blocking=True,
             meta={"loss": losses[-1] if losses else None})
    mgr.wait()
    return TrainResult(loop.steps - 1, losses, stragglers, restored_from)
