"""Snapshot + WAL-tail recovery: the durability tier's coordinator.

Counterpart of ``repro.pipeline.recovery``, for a ``PIIndex`` and for a
``ShardedPIIndex``, with the same directory layout, so a directory written
by either package recovers in the other (``durability.json`` with its
``kind`` and ``n_shards``, ``ckpt/step_<seq>/host0.npz``,
``wal/wal-<seq>.seg``).  A sharded snapshot holds the stacked shard
leaves, then the fences.

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
record.

A ``ShardedPIIndex`` over several ranks is one job: every rank runs the
same collector and dispatcher, and rank 0 alone writes.  It appends the
WAL and writes ``host0.npz``, whose stacked shard leaves every rank
gathers first, so the directory is byte for byte what one process writes;
the other ranks wait at a barrier.  They keep the WAL's sequence numbers
and pass the same fault points (``faults.py``) as rank 0 does, so that a
simulated crash stops every rank at the same instant; ``fsync="interval"``
syncs on rank 0's clock, which the others cannot follow, and is refused
across ranks.  ``recover(directory, mesh=...)`` restores onto
any number of ranks that divides the shard count: a directory written by
four ranks recovers on two, on one, and in the JAX package.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import List, Optional, Tuple

import torch.distributed as tdist

from repro_torch.checkpoint import CheckpointManager
from repro_torch.core import distributed as dist
from repro_torch.core import index as pi
from repro_torch.faults import faultpoint
from repro_torch.pipeline.dispatcher import Dispatcher
from repro_torch.pipeline.wal import (WalRecord, WalWriter, _segment_files,
                                      encode_record, read_wal, record_window)
from repro_torch.sharding import group_rank, group_size

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


def _snapshot_tree(index):
    """What a snapshot holds; a sharded index's shards are gathered from
    every rank (a collective)."""
    if isinstance(index, dist.ShardedPIIndex):
        return (dist.gather_shards(index.shards, index.group), index.fences)
    return index


class _FollowerWal:
    """The WAL as a rank other than 0 sees it: the sequence numbers rank
    0's ``WalWriter`` gives and the fault points it passes, its syncs at
    every window (``fsync="per_window"``) and at every segment rotation
    included, without a byte written.  Created after rank 0 opened (and
    repaired) the log."""

    def __init__(self, directory: str, fsync: str, segment_bytes: int):
        self.fsync = fsync
        self.segment_bytes = segment_bytes
        segs = _segment_files(directory)
        records = read_wal(directory) if segs else []
        self._next_seq = records[-1].seq + 1 if records else \
            segs[-1][0] if segs else 1
        self._bytes = os.path.getsize(segs[-1][1]) if segs else 0
        self.durable_seq = self._next_seq - 1
        self.n_appends = 0
        self.n_fsyncs = 0

    @property
    def last_seq(self) -> int:
        return self._next_seq - 1

    def append(self, window) -> int:
        seq = self._next_seq
        if window.seq is not None and window.seq != seq:
            raise ValueError(f"window carries seq {window.seq} but the log "
                             f"is at {seq}")
        self._bytes += len(encode_record(seq, window))
        faultpoint("wal.mid_append")
        faultpoint("wal.after_append")
        window.seq = seq
        self._next_seq = seq + 1
        self.n_appends += 1
        if self.fsync == "per_window":
            self.sync()
        if self._bytes >= self.segment_bytes:
            self.sync()                 # rank 0 rotates the segment
            self._bytes = 0
        return seq

    def sync(self):
        faultpoint("wal.pre_sync")
        self.durable_seq = self.last_seq
        self.n_fsyncs += 1

    def close(self):
        if self.fsync != "off":
            self.sync()


def _empty_tree(cfg: pi.PIConfig, kind: str, n_shards: int):
    """The leaf shapes and dtypes a snapshot of ``kind`` restores into."""
    if kind == "sharded":
        return dist.leaf_spec_sharded(cfg, n_shards)
    return pi.leaf_spec(cfg)


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
        self.group = None
        if isinstance(index, dist.ShardedPIIndex):
            self.kind = "sharded"
            self.n_shards = index.n_shards
            self.config = index.shards.config
            self.group = index.group
        else:
            self.kind = "single"
            self.n_shards = 1
            self.config = index.config
        if fsync == "interval" and group_size(self.group) > 1:
            # WalWriter's interval policy syncs on rank 0's clock as well,
            # which no other rank can mirror
            raise ValueError(
                'fsync="interval" syncs on rank 0\'s clock, which the other '
                'ranks cannot follow: across ranks use "per_window" or "off"')
        self.writer = group_rank(self.group) == 0
        if self.writer:
            self._open(directory, fsync, fsync_interval, segment_bytes,
                       group_commit, keep)
        self._barrier()
        if not self.writer:
            self.ckpt = CheckpointManager(os.path.join(directory, "ckpt"),
                                          keep=keep)
            self.wal = _FollowerWal(os.path.join(directory, "wal"), fsync,
                                    segment_bytes)
        self._last_snap = self.ckpt.latest_step()
        if self._last_snap is None:
            # nothing acknowledged yet, so a crash inside this initial
            # snapshot is recoverable-by-vacuity; blocking so the first
            # acked window always has a base to replay onto
            self.snapshot(index, seq=self.wal.last_seq)

    def _barrier(self):
        if self.group is not None:
            tdist.barrier(group=self.group)

    def _open(self, directory, fsync, fsync_interval, segment_bytes,
              group_commit, keep):
        """The writer's files: metadata, checkpoints and the WAL."""
        os.makedirs(directory, exist_ok=True)
        if not os.path.exists(os.path.join(directory, META_NAME)):
            config = dataclasses.asdict(self.config)
            config["backend"] = BACKEND_ON_DISK[config["backend"]]
            self._write_meta({"kind": self.kind, "n_shards": self.n_shards,
                              "config": config})
        self.ckpt = CheckpointManager(os.path.join(directory, "ckpt"),
                                      keep=keep)
        self.wal = WalWriter(os.path.join(directory, "wal"), fsync=fsync,
                             fsync_interval=fsync_interval,
                             segment_bytes=segment_bytes,
                             group_commit=group_commit)

    def _write_meta(self, meta: dict):
        path = os.path.join(self.dir, META_NAME)
        with open(path + ".tmp", "w") as f:
            json.dump(meta, f)
        os.rename(path + ".tmp", path)

    def record_capacity_factor(self, capacity_factor: float):
        """Record the sharded dispatcher's capacity factor in the metadata,
        so that ``recover`` replays the WAL at the routing the windows were
        served at (at a smaller factor a replayed window can overflow its
        send buckets).  The ``Dispatcher`` calls it; a directory whose
        windows were served at another factor is refused (``ValueError``),
        since its WAL tail would replay at neither."""
        with open(os.path.join(self.dir, META_NAME)) as f:
            meta = json.load(f)
        had = meta.get("capacity_factor")
        if had is not None and had != capacity_factor:
            raise ValueError(
                f"{self.dir} holds windows served at capacity factor {had}; "
                f"a dispatcher at {capacity_factor} cannot append to it")
        if had is None and self.writer:
            meta["capacity_factor"] = capacity_factor
            self._write_meta(meta)

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
        tree = _snapshot_tree(index)
        self._last_snap = seq
        if not self.writer:
            if blocking:
                faultpoint("ckpt.mid_write")
                faultpoint("ckpt.pre_rename")
            self._barrier()
            return
        prev_pending = self._truncate_pending
        self.ckpt.save(seq, tree, blocking=blocking,
                       meta={"wal_seq": seq, "kind": self.kind})
        self._barrier()
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
        if self.writer:
            self.ckpt.wait()
            if self._truncate_pending:
                # the wait() above confirmed every async save landed, so
                # the deferred truncation is safe now
                self._truncate()
        self.wal.close()
        self._barrier()


def recover(directory: str, *, mesh=None, metrics=None, overload=None,
            device=None) -> Tuple[object, List[WalRecord]]:
    """Rebuild the index from the latest snapshot + the WAL tail.

    Returns ``(index, replayed)``: the ``PIIndex`` or ``ShardedPIIndex``
    (per the directory's metadata) on ``device`` (default: the mesh's,
    else the card) and the ``WalRecord``s applied on top of the snapshot,
    in order.  A sharded index replays through ``mesh``; without one,
    through a mesh of ``n_shards`` shards on ``device``.  A mesh over P
    ranks (P dividing the shard count) gives each rank its own block of
    the snapshot's shards: every rank calls ``recover``.  The replay goes
    through
    ``Dispatcher.submit`` — the execute and rebuild path the live
    pipeline ran — so the result is bit-identical to the pre-crash state
    at the last durable window.

    Raises ``RecoveryError`` when the directory has no metadata or no
    complete snapshot, ``WalCorruptionError`` on interior log damage (a
    torn tail is repaired by exclusion, not an error).  With ``overload``
    the replay runs behind the breaker, as the live dispatcher with that
    config did (the sharded path has no breaker).  A sharded replay
    routes at the capacity factor the live dispatcher recorded in the
    metadata (``Durability.record_capacity_factor``), else at the default
    2.0, as the reference always does (ROADMAP §C).
    """
    meta_path = os.path.join(directory, META_NAME)
    if not os.path.exists(meta_path):
        raise RecoveryError(f"no {META_NAME} in {directory}")
    with open(meta_path) as f:
        meta = json.load(f)
    kind = meta["kind"]
    n_shards = int(meta.get("n_shards", 1))
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
    if device is None and mesh is not None:
        device = mesh.device
    group = mesh.group("data") if mesh is not None and kind == "sharded" \
        else None
    tree = ckpt.restore(step, _empty_tree(cfg, kind, n_shards),
                        device="cpu" if group is not None else device)
    if kind == "sharded":
        shards, fences = tree
        if group is not None:
            dev = pi._device(device)
            shards = pi.from_flat_leaves(cfg, [
                dist.local_block(x, n_shards, group).to(dev)
                for x in pi.flat_leaves(shards)])
            fences = fences.to(dev)
        index = dist.ShardedPIIndex(shards=shards, fences=fences,
                                    n_shards=n_shards, group=group)
        if mesh is None:
            mesh = dist.make_mesh((n_shards,), ("data",),
                                  device=index.device)
    else:
        index = tree

    tail = [r for r in read_wal(os.path.join(directory, "wal"))
            if r.seq > step]
    disp = Dispatcher(index, mesh=mesh, depth=0, overload=overload,
                      capacity_factor=meta.get("capacity_factor", 2.0))
    for rec in tail:
        disp.submit(record_window(rec))
    if metrics is not None:
        metrics.recovery_replayed += len(tail)
    return disp.index, tail
