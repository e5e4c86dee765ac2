"""Fault-tolerant checkpointing: async, atomic, one host.

Counterpart of ``repro.checkpoint``, with the same files on disk, so a
snapshot written by either package restores in the other:

  * ``save`` copies the tree's tensors to host memory on the calling
    thread, then writes ``step_<N>.tmp/host0.npz`` (``leaf_i`` in the
    flattening order below) and ``manifest.json``, and renames the
    directory to ``step_<N>/`` — a crashed or partial save can never be
    mistaken for a complete one;
  * ``latest_step`` picks the newest *complete* checkpoint; partial or
    corrupt directories are skipped;
  * saves may run on a background thread; a failed background write
    re-raises from the next ``wait()`` instead of vanishing with the
    thread;
  * ``restore`` checks every leaf's shape and dtype against the target
    and places the tensors on the card unless asked otherwise.

A tree is a ``PIIndex`` (its leaves in the JAX ``tree_flatten`` order,
``levels`` expanded: ``core.index.flat_leaves``), a dict (sorted keys, as
``jax.tree_util`` orders them), a list or tuple, or a leaf (a tensor or a
numpy array).  Elastic restore onto another sharding belongs to the
sharded path (ROADMAP A9) and is refused.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Callable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import index as pi
from repro_torch.faults import faultpoint


def _flatten(tree) -> Tuple[List[Any], Callable[[List[Any]], Any]]:
    """(leaves, rebuild): the tree's leaves in order, and a function that
    puts a list of new leaves back into the tree's structure."""
    if isinstance(tree, pi.PIIndex):
        return pi.flat_leaves(tree), \
            lambda xs: pi.from_flat_leaves(tree.config, xs)
    if isinstance(tree, (dict, list, tuple)):
        keys = sorted(tree) if isinstance(tree, dict) else range(len(tree))
        parts = [_flatten(tree[k]) for k in keys]
        counts = [len(leaves) for leaves, _ in parts]

        def rebuild(xs):
            out, start = [], 0
            for (_, sub), n in zip(parts, counts):
                out.append(sub(xs[start:start + n]))
                start += n
            if isinstance(tree, dict):
                return dict(zip(keys, out))
            return type(tree)(out)

        return [x for leaves, _ in parts for x in leaves], rebuild
    return [tree], lambda xs: xs[0]


def _host_copy(leaf) -> np.ndarray:
    """A numpy copy of a leaf that no later write to the leaf can reach."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True).numpy()
    return np.array(leaf, copy=True)


def _np_dtype(leaf) -> np.dtype:
    if isinstance(leaf, torch.Tensor):
        return torch.empty((0,), dtype=leaf.dtype).numpy().dtype
    return np.asarray(leaf).dtype


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._exc: Optional[BaseException] = None

    # -- save ---------------------------------------------------------------
    def save(self, step: int, tree: Any, blocking: bool = False,
             meta: Optional[dict] = None):
        """Checkpoint a tree of tensors (async unless ``blocking``)."""
        self.wait()
        leaves, _ = _flatten(tree)
        # snapshot to host memory NOW (later updates must not race)
        host_leaves = [_host_copy(leaf) for leaf in leaves]

        def _write():
            tmp = os.path.join(self.dir, f"step_{step}.tmp")
            final = os.path.join(self.dir, f"step_{step}")
            os.makedirs(tmp, exist_ok=True)
            np.savez(os.path.join(tmp, "host0.npz"),
                     **{f"leaf_{i}": a for i, a in enumerate(host_leaves)})
            faultpoint("ckpt.mid_write")     # arrays down, no manifest yet
            manifest = {"step": step, "n_leaves": len(host_leaves),
                        "time": time.time(), "meta": meta or {},
                        "complete": True}
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
            if os.path.exists(final):
                shutil.rmtree(final)
            faultpoint("ckpt.pre_rename")    # complete .tmp, unpublished
            os.rename(tmp, final)            # atomic publish
            self._gc()

        def _write_captured():
            try:
                _write()
            except BaseException as e:       # re-raised from wait()
                self._exc = e

        if blocking:
            _write()
        else:
            self._thread = threading.Thread(target=_write_captured,
                                            daemon=True)
            self._thread.start()

    def wait(self):
        """Join the in-flight save; re-raise its failure, if any.

        A background save that died (disk full, crash injection, ...)
        must not be mistaken for a published checkpoint — the exception
        is latched and surfaces here, once, instead of dying silently
        with the daemon thread."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._exc is not None:
            exc, self._exc = self._exc, None
            raise exc

    def _gc(self):
        steps = self.all_steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"),
                          ignore_errors=True)

    # -- restore --------------------------------------------------------------
    def all_steps(self):
        out = []
        for name in os.listdir(self.dir):
            if not name.startswith("step_") or name.endswith(".tmp"):
                continue
            path = os.path.join(self.dir, name, "manifest.json")
            try:
                with open(path) as f:
                    m = json.load(f)
                if m.get("complete"):
                    out.append(int(name.split("_")[1]))
            except (OSError, json.JSONDecodeError, ValueError):
                continue                      # partial/corrupt → skip
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, target_tree: Any, shardings: Any = None,
                *, device=None) -> Any:
        """Restore into the structure of ``target_tree``, every leaf a
        tensor on ``device`` (default: the card).  The target's leaves
        give only shapes and dtypes, so it may live on the ``meta``
        device (``core.index.leaf_spec``)."""
        if shardings is not None:
            raise NotImplementedError(
                "restore onto shardings (elastic restore) belongs to the "
                "sharded path, not ported yet (ROADMAP A9)")
        leaves, rebuild = _flatten(target_tree)
        path = os.path.join(self.dir, f"step_{step}", "host0.npz")
        with np.load(path) as z:
            loaded = [z[f"leaf_{i}"] for i in range(len(leaves))]
        for want, got in zip(leaves, loaded):
            if tuple(want.shape) != tuple(got.shape):
                raise ValueError(
                    f"checkpoint shape {got.shape} != target {want.shape}")
            if np.dtype(got.dtype) != _np_dtype(want):
                raise ValueError(
                    f"checkpoint dtype {got.dtype} != target "
                    f"{_np_dtype(want)}")
        dev = pi._device(device)
        return rebuild([torch.from_numpy(a).to(dev) for a in loaded])

    def restore_latest(self, target_tree: Any, shardings: Any = None, *,
                       device=None):
        step = self.latest_step()
        if step is None:
            return None, None
        return step, self.restore(step, target_tree, shardings,
                                  device=device)
