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
    and places the tensors on the card unless asked otherwise — or, given
    ``shardings``, each leaf where that tree says: the elastic restore,
    onto another placement than the one saved;
  * across ranks (a tree of DTensors, ``sharding.place``) every rank
    gathers each leaf (``full_tensor``), rank 0 alone writes the same
    files as one process, and the other ranks wait for it at a barrier;
    ``restore`` onto ``(DeviceMesh, placements)`` leaves has every rank
    read the files and keep its own blocks — saved on one mesh, restored
    on another or in one process.

A bfloat16 leaf, which numpy lacks, is written as the JAX package writes
it: its raw 2-byte words as a ``|V2`` array (``BF16_ON_DISK``).
``restore`` takes such a leaf for a bfloat16 target and reads its bytes
as bfloat16; every other dtype must match the target's exactly.  Here
the port departs from the reference on purpose: the JAX ``restore``
refuses its own bfloat16 files (``|V2 != bfloat16``).

A tree is a ``PIIndex`` (its leaves in the JAX ``tree_flatten`` order,
``levels`` expanded: ``core.index.flat_leaves``), a dict (sorted keys, as
``jax.tree_util`` orders them), a list or tuple, or a leaf (a tensor or a
numpy array).  A sharded index is saved as the tuple ``(shards,
fences)`` (``pipeline.recovery``), its shards' leaves stacked.
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

import torch.distributed as tdist

from repro_torch import sharding as shd
from repro_torch.core import index as pi
from repro_torch.core.distributed import Mesh
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


def _placements(tree, shardings) -> list:
    """One device, or one ``(DeviceMesh, placements)`` pair, a leaf of
    ``tree``.  ``shardings`` follows the tree's structure down to some
    node; there a device (or a ``Mesh``: its device) or a pair places
    every leaf below it."""
    if shd.is_sharding(shardings):
        return [shardings] * len(_flatten(tree)[0])
    if isinstance(shardings, Mesh):
        shardings = shardings.device
    if isinstance(shardings, (torch.device, str)):
        return [pi._device(shardings)] * len(_flatten(tree)[0])
    if isinstance(tree, pi.PIIndex):
        tree, shardings = pi.flat_leaves(tree), pi.flat_leaves(shardings)
    if isinstance(tree, dict):
        if sorted(tree) != sorted(shardings):
            raise ValueError(f"shardings keys {sorted(shardings)} != tree "
                             f"keys {sorted(tree)}")
        return [d for k in sorted(tree)
                for d in _placements(tree[k], shardings[k])]
    if isinstance(tree, (list, tuple)) and \
            isinstance(shardings, (list, tuple)) and \
            len(tree) == len(shardings):
        return [d for t, sh in zip(tree, shardings)
                for d in _placements(t, sh)]
    raise ValueError(f"shardings {shardings!r} do not match the tree")


BF16_ON_DISK = np.dtype("V2")    # a bfloat16 leaf's words in host0.npz


def _host_copy(leaf, keep: bool = True) -> Optional[np.ndarray]:
    """A numpy copy of a leaf that no later write to the leaf can reach
    (a DTensor's whole value: every rank takes part in the gather, and
    only a rank that ``keep``s it copies it to the host)."""
    if isinstance(leaf, torch.Tensor):
        whole = shd.full(leaf.detach())
        if not keep:
            return None
        host = whole.to("cpu", copy=True)
        if host.dtype == torch.bfloat16:
            return host.view(torch.int16).numpy().view(BF16_ON_DISK)
        return host.numpy()
    return np.array(leaf, copy=True)


def _np_dtype(leaf) -> np.dtype:
    """The dtype a leaf has on disk."""
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            return BF16_ON_DISK
        return torch.empty((0,), dtype=leaf.dtype).numpy().dtype
    return np.asarray(leaf).dtype


def _from_disk(a: np.ndarray, want) -> torch.Tensor:
    if isinstance(want, torch.Tensor) and want.dtype == torch.bfloat16:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._exc: Optional[BaseException] = None
        self._barrier = False      # ranks wait for rank 0's write

    # -- save ---------------------------------------------------------------
    def save(self, step: int, tree: Any, blocking: bool = False,
             meta: Optional[dict] = None):
        """Checkpoint a tree of tensors (async unless ``blocking``).  A
        tree of DTensors is saved by every rank together: each leaf is
        gathered, rank 0 writes, and the others return once it has
        (``wait``)."""
        self.wait()
        leaves, _ = _flatten(tree)
        self._barrier = any(shd.is_dtensor(leaf) for leaf in leaves) and \
            tdist.is_initialized()
        writer = not self._barrier or tdist.get_rank() == 0
        # snapshot to host memory NOW (later updates must not race)
        host_leaves = [_host_copy(leaf, writer) for leaf in leaves]
        if not writer:
            if blocking:
                self.wait()
            return

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
            self.wait()
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
        if self._barrier:
            self._barrier = False
            tdist.barrier()
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
        device (``core.index.leaf_spec``).  ``shardings``, if given,
        places the leaves instead (elastic restore): a tree of the
        target's structure whose leaves are devices or ``(DeviceMesh,
        placements)`` pairs (``sharding.tree_shardings``: each rank keeps
        its blocks), or a device, a one-device ``Mesh`` or a pair for
        every leaf below a node."""
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
        places = _placements(target_tree, shardings) \
            if shardings is not None else \
            [pi._device(device)] * len(loaded)
        return rebuild([shd.place_tensor(_from_disk(a, want), *d)
                        if shd.is_sharding(d) else _from_disk(a, want).to(d)
                        for a, want, d in zip(loaded, leaves, places)])

    def restore_latest(self, target_tree: Any, shardings: Any = None, *,
                       device=None):
        step = self.latest_step()
        if step is None:
            return None, None
        return step, self.restore(step, target_tree, shardings,
                                  device=device)
