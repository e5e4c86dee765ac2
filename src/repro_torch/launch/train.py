"""Fault-tolerant training driver.

Counterpart of ``repro.launch.train``, on one card or over a mesh of
ranks:

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

The loss is read once a step (``float`` of a replicated scalar), the
step's one host sync, as the JAX loop does.  ``mesh`` is ``None`` (the
card, or ``device``), the port's ``core.distributed.Mesh`` of one rank,
which places every leaf of the state, restored ones included, on its
device, or a ``DeviceMesh`` (``launch.mesh``; or a ``Mesh`` over one):
every rank runs this loop, the state placed by ``rules``
(``steps.train_state_shardings``: init, and the elastic restore of a
checkpoint saved on any mesh), each batch placed by its logical axes,
and the step run under ``sharding.use_mesh``.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from torch.distributed.device_mesh import DeviceMesh

from repro_torch import checkpoint as ckpt_mod
from repro_torch import data as data_mod
from repro_torch import optim
from repro_torch import sharding as shd
from repro_torch.core.distributed import Mesh, make_mesh
from repro_torch.core.index import _device
from repro_torch.models import (abstract_train_state, init_train_state,
                                make_train_step)
from repro_torch.models.base import ModelConfig
from repro_torch.models.steps import place_batch, train_state_shardings


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
    state: Optional[dict] = None     # {"params", "opt"} after the last step


def _train_mesh(mesh, device):
    """(the ``DeviceMesh`` the state is placed on, or ``None``; the device
    of a batch as drawn)."""
    if mesh is None:
        return None, _device(device)
    if isinstance(mesh, (list, tuple)):     # devices: one, or raise
        mesh = make_mesh((len(mesh),), ("data",), device=mesh)
    if isinstance(mesh, Mesh):
        if mesh.device_mesh is None:
            return None, mesh.device
        mesh = mesh.device_mesh
    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"mesh {mesh!r} is neither a DeviceMesh nor a "
                        f"core.distributed.Mesh")
    return mesh, torch.device("cpu")        # every rank draws, keeps its block


def train(cfg: ModelConfig, opt_cfg: optim.OptConfig,
          loop: TrainLoopConfig, dcfg: data_mod.DataConfig,
          mesh=None, rules=shd.DEFAULT_RULES,
          hooks: Optional[Dict[str, Callable]] = None,
          device=None) -> TrainResult:
    """Run (or resume) a training loop; survives a restart mid-run.
    ``hooks``: ``pre_step(step)`` inside the timed window, ``log(step,
    loss, seconds)`` every ``log_every`` steps."""
    hooks = hooks or {}
    dm, dev = _train_mesh(mesh, device)
    shardings = None if dm is None else \
        train_state_shardings(cfg, opt_cfg, dm, rules)
    mgr = ckpt_mod.CheckpointManager(loop.ckpt_dir)
    restored_from = None
    if mgr.latest_step() is not None:
        # elastic restore: placed on the current mesh, whatever it was
        # saved from
        params, _, opt_state, _ = abstract_train_state(cfg, opt_cfg)
        step0, state = mgr.restore_latest(
            {"params": params, "opt": opt_state}, shardings, device=dev)
        restored_from, start = step0, step0 + 1
    else:
        gen = torch.Generator().manual_seed(loop.seed)
        params, opt_state = init_train_state(cfg, opt_cfg, gen, dev,
                                             shardings=shardings)
        state = {"params": params, "opt": opt_state}
        start = 0

    train_step = make_train_step(cfg, opt_cfg, grad_accum=loop.grad_accum)
    losses, stragglers, durations = [], [], []
    with shd.use_mesh(dm, rules):
        for step in range(start, loop.steps):
            if loop.fail_at_step is not None and step == loop.fail_at_step:
                raise RuntimeError(f"injected failure at step {step}")
            batch = data_mod.lm_batch(dcfg, step, device=dev)
            if dm is not None:
                batch = place_batch(batch, dm, rules)
            t0 = time.perf_counter()
            if "pre_step" in hooks:       # inside the timed window: the
                hooks["pre_step"](step)   # hook simulates slow devices
            p, o, metrics = train_step(state["params"], state["opt"], batch)
            loss = float(shd.local(metrics["loss"]))    # replicated
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
    return TrainResult(loop.steps - 1, losses, stragglers, restored_from,
                       state)
