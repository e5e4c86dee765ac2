"""Snapshot + WAL-tail recovery: the durability tier's coordinator.

Counterpart of ``repro.pipeline.recovery`` for one ``PIIndex``, with the
same directory layout, so a directory written by either package recovers
in the other (``durability.json``, ``ckpt/step_<seq>/host0.npz``,
``wal/wal-<seq>.seg``).

``Durability`` bundles the admission-point WAL (``pipeline/wal.py``) with
periodic index snapshots (``checkpoint.py``) behind two hooks the live
pipeline already exposes:

* ``on_seal(window)``   — the collector's seal hook: one WAL append per
  sealed window, *before* the window is dispatched (write-ahead).
* ``maybe_snapshot(index, seq)`` — called by the dispatcher after each
  submit; every ``snapshot_every`` windows it copies the index to host
  memory and writes it through ``CheckpointManager``, stamped with the WAL
  sequence number of the last submitted window, then deletes WAL segments
  behind the oldest *kept* snapshot.

``recover(dir)`` inverts it: load the latest complete snapshot, replay
the WAL tail (``seq > snapshot seq``) through the same ``Dispatcher``
execute path the live system uses — so the recovered state is
bit-identical to never having crashed — and return the index plus the
replayed records.

Contract: recovery always lands on a window boundary; it includes every
acknowledged window (the fsync policy defines acknowledged), may include a
fully written but unacknowledged suffix, and never replays a torn tail
record.  The sharded kind (ROADMAP A9) is not ported yet and is refused.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import List, Optional, Tuple

from repro_torch.checkpoint import CheckpointManager
from repro_torch.core import index as pi
from repro_torch.pipeline.dispatcher import Dispatcher
from repro_torch.pipeline.wal import (WalRecord, WalWriter, read_wal,
                                      record_window)

META_NAME = "durability.json"

# Backend names in durability.json.  The file records the JAX package's
# name of the search backend, so that either package can recover a
# directory the other wrote: the JAX PIConfig refuses "torch" and "cuda",
# and the port's refuses "xla" and "pallas".  The port's stock-PyTorch
# backend is the counterpart of "xla", its CUDA kernels of the Pallas
# kernels ("pallas" on the chip, "pallas-interpret" on a CPU).
BACKEND_ON_DISK = {"torch": "xla", "cuda": "pallas"}
BACKEND_FROM_DISK = {"xla": "torch", "pallas": "cuda",
                     "pallas-interpret": "cuda"}


class RecoveryError(RuntimeError):
    """The durability directory cannot seed an index: missing metadata or
    no complete snapshot (``Durability`` writes both before acknowledging
    anything, so this means the directory never finished initializing)."""


def _refuse_sharded():
    raise NotImplementedError(
        "durability of a sharded index is not ported yet (ROADMAP A9)")


class Durability:
    """WAL-on-admission + periodic snapshots for one pipeline's index.

    Creating a ``Durability`` over a fresh directory writes the geometry
    metadata and a blocking step-0 snapshot of ``index`` (the initial
    build — without it a crash before the first periodic snapshot would
    be unrecoverable); over an existing directory it validates the log,
    repairs a torn tail, and resumes sequence numbering — pass the index
    returned by ``recover`` to continue where the crash left off.
    """

    def __init__(self, directory: str, index, *,
                 fsync: str = "per_window", fsync_interval: float = 0.05,
                 snapshot_every: int = 0, keep: int = 3,
                 segment_bytes: int = 1 << 22, metrics=None,
                 async_snapshots: bool = False,
                 group_commit: "int | None" = None):
        if not isinstance(index, pi.PIIndex):
            _refuse_sharded()
        self.dir = directory
        self.snapshot_every = snapshot_every
        self.metrics = metrics
        # serving-path mode: periodic maybe_snapshot saves go through the
        # CheckpointManager's background thread instead of blocking the
        # tick (the copy to host memory still happens in the tick).  WAL
        # truncation is deferred until the next save (or close) confirms
        # the previous one landed — truncating behind a snapshot that
        # later fails would lose the only way to rebuild.  Write errors
        # surface via the manager's latched-exception contract at the
        # next save/wait.  The initial step-0 snapshot and explicit
        # snapshot() calls stay blocking regardless.
        self.async_snapshots = async_snapshots
        self._truncate_pending = False
        self.kind = "single"
        self.n_shards = 1
        self.config = index.config
        os.makedirs(directory, exist_ok=True)
        meta_path = os.path.join(directory, META_NAME)
        if not os.path.exists(meta_path):
            config = dataclasses.asdict(self.config)
            config["backend"] = BACKEND_ON_DISK[config["backend"]]
            tmp = meta_path + ".tmp"
            with open(tmp, "w") as f:
                json.dump({"kind": self.kind, "n_shards": self.n_shards,
                           "config": config}, f)
            os.rename(tmp, meta_path)
        self.ckpt = CheckpointManager(os.path.join(directory, "ckpt"),
                                      keep=keep)
        self.wal = WalWriter(os.path.join(directory, "wal"), fsync=fsync,
                             fsync_interval=fsync_interval,
                             segment_bytes=segment_bytes,
                             group_commit=group_commit)
        self._last_snap = self.ckpt.latest_step()
        if self._last_snap is None:
            # nothing acknowledged yet, so a crash inside this initial
            # snapshot is recoverable-by-vacuity; blocking so the first
            # acked window always has a base to replay onto
            self.snapshot(index, seq=self.wal.last_seq)

    @property
    def durable_seq(self) -> int:
        """Last window sequence the fsync policy guarantees on disk."""
        return self.wal.durable_seq

    @property
    def last_snapshot_seq(self) -> Optional[int]:
        return self._last_snap

    # -- live-path hooks ---------------------------------------------------

    def on_seal(self, window) -> int:
        """Collector seal hook: write-ahead append of the sealed window."""
        seq = self.wal.append(window)
        if self.metrics is not None:
            self.metrics.wal_appends += 1
            self.metrics.wal_fsyncs = self.wal.n_fsyncs
        return seq

    def maybe_snapshot(self, index, seq: Optional[int]):
        """Dispatcher post-submit hook: snapshot every N windows."""
        if (self.snapshot_every and seq is not None
                and seq - (self._last_snap or 0) >= self.snapshot_every):
            self.snapshot(index, seq=seq,
                          blocking=not self.async_snapshots)

    def snapshot(self, index, *, seq: Optional[int] = None,
                 blocking: bool = True):
        """Write the index, stamped with its WAL position.

        ``seq`` must be the sequence number of the last window already
        applied to ``index`` — recovery replays strictly-greater records
        on top.  After a blocking save the WAL is truncated behind the
        oldest snapshot the checkpoint GC kept; a non-blocking save defers
        both the truncation and its own error surfacing to the next
        save/close (``CheckpointManager.save`` waits for — and re-raises
        from — the previous background save before starting a new one).
        """
        if seq is None:
            seq = self.wal.last_seq
        prev_pending = self._truncate_pending
        self.ckpt.save(seq, index, blocking=blocking,
                       meta={"wal_seq": seq, "kind": self.kind})
        self._last_snap = seq
        if blocking:
            self._truncate()
        else:
            if prev_pending:
                # save() joined the previous background save (and would
                # have re-raised its failure), so the snapshot that
                # deferred this truncation is confirmed on disk; the save
                # now in flight is invisible to all_steps() until its
                # manifest lands, so it cannot be truncated against
                self._truncate()
            self._truncate_pending = True

    def _truncate(self):
        """Delete WAL segments behind the oldest kept snapshot."""
        self._truncate_pending = False
        steps = self.ckpt.all_steps()
        if steps:
            self.wal.truncate_through(min(steps))

    def close(self):
        self.ckpt.wait()
        if self._truncate_pending:
            # the wait() above confirmed every async save landed, so the
            # deferred truncation is safe now
            self._truncate()
        self.wal.close()


def recover(directory: str, *, metrics=None, overload=None, device=None
            ) -> Tuple[pi.PIIndex, List[WalRecord]]:
    """Rebuild the index from the latest snapshot + the WAL tail.

    Returns ``(index, replayed)``: the ``PIIndex`` on ``device`` (default:
    the card) and the ``WalRecord``s applied on top of the snapshot, in
    order.  The replay goes through ``Dispatcher.submit`` — the execute
    and rebuild path the live pipeline ran — so the result is
    bit-identical to the pre-crash state at the last durable window.

    Raises ``RecoveryError`` when the directory has no metadata or no
    complete snapshot, ``WalCorruptionError`` on interior log damage (a
    torn tail is repaired by exclusion, not an error), and
    ``NotImplementedError`` for a sharded directory (ROADMAP A9).  With
    ``overload`` the replay runs behind the breaker, as the live
    dispatcher with that config did.
    """
    meta_path = os.path.join(directory, META_NAME)
    if not os.path.exists(meta_path):
        raise RecoveryError(f"no {META_NAME} in {directory}")
    with open(meta_path) as f:
        meta = json.load(f)
    if meta["kind"] != "single":
        _refuse_sharded()
    config = dict(meta["config"])
    backend = config["backend"]
    if backend not in BACKEND_FROM_DISK:
        raise RecoveryError(f"unknown backend {backend!r} in {META_NAME}")
    config["backend"] = BACKEND_FROM_DISK[backend]
    cfg = pi.PIConfig(**config)

    ckpt = CheckpointManager(os.path.join(directory, "ckpt"))
    step = ckpt.latest_step()
    if step is None:
        raise RecoveryError(
            f"no complete snapshot under {directory}/ckpt — the initial "
            f"blocking snapshot never finished, so nothing was ever "
            f"acknowledged")
    index = ckpt.restore(step, pi.leaf_spec(cfg), device=device)

    tail = [r for r in read_wal(os.path.join(directory, "wal"))
            if r.seq > step]
    disp = Dispatcher(index, depth=0, overload=overload)
    for rec in tail:
        disp.submit(record_window(rec))
    if metrics is not None:
        metrics.recovery_replayed += len(tail)
    return disp.index, tail
