"""The port's durability tier against the JAX package's.

* WAL (``repro_torch.pipeline.wal``): the record codec, fsync policies
  and corruption matrix of ``tests/test_wal.py`` on the port; the segment
  files the two packages write for the same windows are equal byte for
  byte, and the port reads a PIW1 segment.
* Checkpoint (``repro_torch.checkpoint``): the cases of
  ``tests/test_checkpoint.py`` with a port ``PIIndex`` (and a dict) as the
  tree; a snapshot holds the JAX leaf order, ``levels`` expanded.
* Recovery (``repro_torch.pipeline.recovery``): the single-kind cases of
  ``tests/test_durability.py`` — the crash matrix over the five fault
  points, crash after a snapshot, the crash-free round trip, resume,
  empty directory and missing snapshot, ``fsync="off"``, async snapshots.
  Each recovered index is held to a crash-free port dispatcher over the
  recovered windows, to the JAX ``recover`` of the same stream and to
  ``RefIndex``.
* Interchange: a directory written by the JAX package (``xla`` and
  ``pallas-interpret``) recovers in the port to the JAX ``recover``'s
  leaves, and one written by the port (``torch``, recorded as ``xla``)
  recovers in the JAX package to the port's.

Crashes are injected through the port's own fault hook
(``repro_torch.faults``); ``tests/faultpoints.py`` drives the JAX hook.
"""
import contextlib
import dataclasses
import json
import os
import struct
import time
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as jckpt
from repro import pipeline as jp
from repro.core import index as jpi
from repro.pipeline import wal as jwal
from repro_torch import checkpoint as tckpt
from repro_torch import faults
from repro_torch import pipeline as tp
from repro_torch.core import RANGE, RefIndex
from repro_torch.core import index as tpi
from repro_torch.pipeline import wal as twal
from repro_torch.pipeline.recovery import BACKEND_FROM_DISK, BACKEND_ON_DISK
from test_durability import drive as jax_drive
from test_durability import mk_stream
from torch_parity import assert_same_state, configs

GEOMETRY = dict(capacity=1024, pending_capacity=128, fanout=4)
KEY_SPACE = 40


# ---------------------------------------------------------------------------
# the port's crash hook
# ---------------------------------------------------------------------------

class SimulatedCrash(RuntimeError):
    """Raised out of a port fault point to model the process dying there."""


@contextlib.contextmanager
def crash_at(name: str, hit: int = 1):
    """Raise ``SimulatedCrash`` the ``hit``-th time the port reaches fault
    point ``name``; ``hits_seen`` tells whether it was reached."""
    if name not in faults.FAULT_POINTS:
        raise ValueError(f"unknown fault point {name!r}")
    state = type("CrashState", (), {"hits_seen": 0})()

    def hook(point: str):
        if point == name:
            state.hits_seen += 1
            if state.hits_seen == hit:
                raise SimulatedCrash(name)

    prev = faults.set_fault_hook(hook)
    try:
        yield state
    finally:
        faults.set_fault_hook(prev)


@contextlib.contextmanager
def fault_hook(hook):
    prev = faults.set_fault_hook(hook)
    try:
        yield
    finally:
        faults.set_fault_hook(prev)


def leaves_equal(a, b) -> bool:
    la, lb = tpi.flat_leaves(a), tpi.flat_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x.cpu(), y.cpu())
        for x, y in zip(la, lb))


# ---------------------------------------------------------------------------
# WAL
# ---------------------------------------------------------------------------

def mk_windows(pkg, n_windows, batch=8, seed=0, key_dtype="int32",
               key_space=50, ranges=False):
    """Windows sealed by ``pkg``'s collector (coalescing on) from a
    random op stream, with RANGE ops when ``ranges``."""
    rng = np.random.default_rng(seed)
    n = n_windows * batch * 2          # coalescing shrinks occupancy
    col = pkg.Collector(pkg.WindowConfig(batch=batch, key_dtype=key_dtype))
    ops = rng.integers(0, 4 if ranges else 3, n).astype(np.int32)
    keys = rng.integers(1, key_space, n).astype(key_dtype)
    vals = rng.integers(0, 1000, n).astype(np.int32)
    keys2 = np.where(ops == RANGE, keys + rng.integers(0, 9, n),
                     0).astype(key_dtype)
    _, sealed = col.offer_many(np.arange(n, dtype=np.float64), ops, keys,
                               vals, np.arange(n), keys2)
    tail = col.take()
    if tail is not None:
        sealed.append(tail)
    return sealed[:n_windows]


def write_log(directory, windows, **kw):
    w = twal.WalWriter(directory, **kw)
    for win in windows:
        w.append(win)
    w.close()
    return w


def assert_record_matches(rec, win):
    occ = win.occupancy
    assert rec.occupancy == occ
    assert rec.batch == win.ops.shape[0]
    assert np.array_equal(rec.ops, win.ops[:occ])
    assert np.array_equal(rec.keys, win.keys[:occ])
    assert np.array_equal(rec.keys2, win.keys2[:occ])
    assert rec.keys.dtype == win.keys.dtype
    assert np.array_equal(rec.vals, win.vals[:occ])
    assert rec.qids.tolist() == list(win.qids)
    assert np.array_equal(rec.slots, win.slots)


def segments(directory):
    return sorted(f for f in os.listdir(directory) if f.endswith(".seg"))


def single_segment(directory):
    segs = segments(directory)
    assert len(segs) == 1
    return os.path.join(str(directory), segs[0])


def flip_byte(path, off):
    with open(path, "r+b") as f:
        f.seek(off)
        b = f.read(1)
        f.seek(off)
        f.write(bytes([b[0] ^ 0xFF]))


@pytest.mark.parametrize("key_dtype", ["int32", "int64"])
def test_wal_roundtrip_write_read(tmp_path, key_dtype):
    wins = mk_windows(tp, 5, key_dtype=key_dtype, seed=3, ranges=True)
    write_log(str(tmp_path), wins)
    recs = twal.read_wal(str(tmp_path))
    assert [r.seq for r in recs] == list(range(1, len(wins) + 1))
    for rec, win in zip(recs, wins):
        assert_record_matches(rec, win)
        assert win.seq == rec.seq      # append stamps the window


def test_wal_record_window_reconstructs_exact_batch(tmp_path):
    wins = mk_windows(tp, 4, seed=7, ranges=True)
    write_log(str(tmp_path), wins)
    for rec, win in zip(twal.read_wal(str(tmp_path)), wins):
        re = twal.record_window(rec)
        for name in ("ops", "keys", "keys2", "vals", "slots"):
            a, b = getattr(re, name), getattr(win, name)
            assert a.dtype == b.dtype and np.array_equal(a, b), name
        assert re.occupancy == win.occupancy
        assert re.qids == list(win.qids)
        assert re.trigger == "recovered"


@pytest.mark.parametrize("key_dtype,ranges", [("int32", True),
                                              ("int64", False)])
def test_wal_segments_byte_identical_to_jax(tmp_path, key_dtype, ranges):
    """The two collectors seal the same windows and the two writers log
    them to the same bytes, across segment rotations; each package reads
    the other's log."""
    wins = {pkg: mk_windows(pkg, 8, key_dtype=key_dtype, seed=5,
                            ranges=ranges) for pkg in (tp, jp)}
    seg = 2 * len(twal.encode_record(1, wins[tp][0])) - 8
    for pkg, mod in ((tp, twal), (jp, jwal)):
        w = mod.WalWriter(str(tmp_path / pkg.__name__), segment_bytes=seg)
        for win in wins[pkg]:
            w.append(win)
        w.close()
    tdir, jdir = tmp_path / tp.__name__, tmp_path / jp.__name__
    assert segments(tdir) == segments(jdir) and len(segments(tdir)) >= 3
    for name in segments(tdir):
        assert (tdir / name).read_bytes() == (jdir / name).read_bytes()
    for rec, win in zip(twal.read_wal(str(jdir)), wins[tp]):
        assert_record_matches(rec, win)
    for rec, win in zip(jwal.read_wal(str(tdir)), wins[tp]):
        assert_record_matches(rec, win)


def _encode_v1(seq, win):
    """A PIW1 record (no keys2 lane), as pre-range logs hold them."""
    occ, n_arr = win.occupancy, win.n_arrivals
    payload = b"".join((win.ops[:occ].tobytes(), win.keys[:occ].tobytes(),
                        win.vals[:occ].tobytes(),
                        np.asarray(win.qids, np.int64).tobytes(),
                        win.slots.astype(np.int32).tobytes()))
    fields = (b"PIW1", seq, win.ops.shape[0], occ, n_arr, len(payload), 0)
    head0 = struct.pack("<4sQIIIIB3xI", *fields, 0)
    crc = zlib.crc32(payload, zlib.crc32(head0))
    return struct.pack("<4sQIIIIB3xI", *fields, crc) + payload


def test_wal_reads_piw1_segment(tmp_path):
    wins = mk_windows(tp, 4, seed=2)
    path = tmp_path / "wal-0000000000000001.seg"
    path.write_bytes(b"".join(_encode_v1(i + 1, w)
                              for i, w in enumerate(wins)))
    recs = twal.read_wal(str(tmp_path))
    want = jwal.read_wal(str(tmp_path))
    assert [r.seq for r in recs] == [r.seq for r in want] == [1, 2, 3, 4]
    for rec, jrec, win in zip(recs, want, wins):
        assert_record_matches(rec, win)
        assert not rec.keys2.any()
        for name in ("ops", "keys", "keys2", "vals", "qids", "slots"):
            assert np.array_equal(getattr(rec, name), getattr(jrec, name))
    w = twal.WalWriter(str(tmp_path))         # resumes after a v1 log
    assert w.append(mk_windows(tp, 1, seed=9)[0]) == 5
    w.close()
    assert [r.seq for r in twal.read_wal(str(tmp_path))] == [1, 2, 3, 4, 5]


def test_wal_writer_refuses_stale_seq(tmp_path):
    wins = mk_windows(tp, 2)
    w = twal.WalWriter(str(tmp_path))
    w.append(wins[0])
    wins[1].seq = 99                   # wired through a different log
    with pytest.raises(ValueError, match="seal order"):
        w.append(wins[1])
    w.close()


@pytest.mark.parametrize("policy", ["per_window", "off", "interval"])
def test_wal_fsync_policies(tmp_path, policy):
    wins = mk_windows(tp, 4)
    w = twal.WalWriter(str(tmp_path), fsync=policy, fsync_interval=3600.0)
    for win in wins:
        seq = w.append(win)
        # per_window: acked == durable on every append; else nothing yet
        assert w.durable_seq == (seq if policy == "per_window" else 0)
    assert w.n_fsyncs == (len(wins) if policy == "per_window" else 0)
    w.close()                          # syncs unless "off"
    assert w.n_fsyncs == {"per_window": len(wins) + 1, "off": 0,
                          "interval": 1}[policy]
    assert w.durable_seq == (0 if policy == "off" else len(wins))


def test_wal_group_commit_syncs_every_n(tmp_path):
    wins = mk_windows(tp, 7)
    w = twal.WalWriter(str(tmp_path), fsync="interval",
                       fsync_interval=3600.0, group_commit=3)
    for win in wins:
        w.append(win)
    assert w.n_fsyncs == 2 and w.durable_seq == 6
    w.close()
    with pytest.raises(ValueError, match="group_commit"):
        twal.WalWriter(str(tmp_path), group_commit=0)


def test_wal_bad_policy_rejected(tmp_path):
    with pytest.raises(ValueError, match="fsync"):
        twal.WalWriter(str(tmp_path), fsync="sometimes")


def test_wal_truncated_tail_recovers_prefix(tmp_path):
    wins = mk_windows(tp, 5, seed=2)
    write_log(str(tmp_path), wins)
    path = single_segment(tmp_path)
    last = twal.encode_record(len(wins), wins[-1])
    with open(path, "r+b") as f:       # tear the final record mid-payload
        f.truncate(os.path.getsize(path) - len(last) // 2)
    recs = twal.read_wal(str(tmp_path))
    assert [r.seq for r in recs] == list(range(1, len(wins)))
    for rec, win in zip(recs, wins):
        assert_record_matches(rec, win)


def test_wal_truncated_tail_repaired_on_reopen(tmp_path):
    wins = mk_windows(tp, 5, seed=2)
    write_log(str(tmp_path), wins)
    path = single_segment(tmp_path)
    with open(path, "r+b") as f:
        f.truncate(os.path.getsize(path) - 3)
    w = twal.WalWriter(str(tmp_path))
    assert w.last_seq == len(wins) - 1
    assert w.append(mk_windows(tp, 1, seed=9)[0]) == len(wins)
    w.close()
    assert [r.seq for r in twal.read_wal(str(tmp_path))] == \
        list(range(1, len(wins) + 1))


def test_wal_interior_bitflip_raises(tmp_path):
    write_log(str(tmp_path), mk_windows(tp, 5, seed=2))
    flip_byte(single_segment(tmp_path), twal._HEADER.size + 4)
    with pytest.raises(twal.WalCorruptionError, match="interior"):
        twal.read_wal(str(tmp_path))


def test_wal_final_record_bitflip_recovers_prefix(tmp_path):
    wins = mk_windows(tp, 5, seed=2)
    write_log(str(tmp_path), wins)
    path = single_segment(tmp_path)
    last = twal.encode_record(len(wins), wins[-1])
    flip_byte(path, os.path.getsize(path) - len(last) + twal._HEADER.size + 2)
    assert [r.seq for r in twal.read_wal(str(tmp_path))] == \
        list(range(1, len(wins)))


@pytest.mark.parametrize("seq,match", [(2, "duplicate"), (5, "gap")])
def test_wal_seq_duplicate_or_gap_raises(tmp_path, seq, match):
    wins = mk_windows(tp, 3, seed=2)
    write_log(str(tmp_path), wins)
    with open(single_segment(tmp_path), "ab") as f:
        f.write(twal.encode_record(seq, wins[1]))
    with pytest.raises(twal.WalCorruptionError, match=match):
        twal.read_wal(str(tmp_path))


def test_wal_missing_segment_raises(tmp_path):
    wins = mk_windows(tp, 8, seed=1)
    seg = 2 * len(twal.encode_record(1, wins[0])) - 8
    write_log(str(tmp_path), wins, segment_bytes=seg)
    segs = segments(tmp_path)
    assert len(segs) >= 3
    os.remove(os.path.join(str(tmp_path), segs[1]))
    with pytest.raises(twal.WalCorruptionError,
                       match="missing|next segment starts"):
        twal.read_wal(str(tmp_path))


def test_wal_truncate_through_drops_only_covered_whole_segments(tmp_path):
    wins = mk_windows(tp, 8, seed=1)
    seg = 2 * len(twal.encode_record(1, wins[0])) - 8
    w = twal.WalWriter(str(tmp_path), segment_bytes=seg)
    for win in wins:
        w.append(win)
    n_before = len(segments(tmp_path))
    assert n_before >= 3
    w.truncate_through(3)              # a snapshot at seq 3 is durable
    assert len(segments(tmp_path)) < n_before
    recs = twal.read_wal(str(tmp_path))
    assert recs[0].seq <= 4
    assert [r.seq for r in recs] == list(range(recs[0].seq, len(wins) + 1))
    w.truncate_through(10 ** 6)        # the live segment always stays
    assert len(segments(tmp_path)) == 1
    w.close()
    w2 = twal.WalWriter(str(tmp_path))
    assert w2.last_seq == len(wins)
    w2.close()


# ---------------------------------------------------------------------------
# checkpoint
# ---------------------------------------------------------------------------

def port_index(seed=0, pending=128, key_dtype="int32"):
    """A port PIIndex with pending inserts and tombstones, on the CPU."""
    rng = np.random.default_rng(seed)
    cfg = tpi.PIConfig(capacity=1024, pending_capacity=pending, fanout=4,
                       key_dtype=key_dtype)
    keys = rng.choice(5000, 300, replace=False)
    idx = tpi.build(cfg, keys, np.arange(300), device="cpu")
    new = torch.from_numpy(rng.choice(np.arange(5000, 6000), 50,
                                      replace=False).astype(key_dtype))
    idx, _ = tpi.insert_batch(idx, new, new.to(torch.int32))
    idx, _ = tpi.delete_batch(idx, torch.from_numpy(keys[:20]).to(new.dtype))
    return idx


def tree(kind, seed=0):
    if kind == "index":
        return port_index(seed)
    rng = np.random.default_rng(seed)
    return {"a": torch.from_numpy(rng.normal(size=(4, 3)).astype(np.float32)),
            "b": [torch.arange(5, dtype=torch.int32),
                  torch.from_numpy(rng.integers(0, 9, 7))]}


def target_like(kind):
    if kind == "index":
        return tpi.leaf_spec(port_index().config)
    return {"a": torch.zeros((4, 3)),
            "b": [torch.zeros(5, dtype=torch.int32),
                  torch.zeros(7, dtype=torch.int64)]}


def assert_tree_equal(a, b):
    la, _ = tckpt._flatten(a)
    lb, _ = tckpt._flatten(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y)


@pytest.mark.parametrize("kind", ["index", "dict"])
@pytest.mark.parametrize("blocking", [True, False])
def test_ckpt_save_restore_roundtrip(tmp_path, kind, blocking):
    t = tree(kind)
    m = tckpt.CheckpointManager(str(tmp_path))
    m.save(3, t, blocking=blocking, meta={"wal_seq": 3})
    m.wait()
    assert m.latest_step() == 3
    got = m.restore(3, target_like(kind), device="cpu")
    assert_tree_equal(got, t)
    with open(os.path.join(str(tmp_path), "step_3", "manifest.json")) as f:
        assert json.load(f)["meta"]["wal_seq"] == 3


def test_ckpt_save_copies_to_host_before_returning(tmp_path):
    """The snapshot is the state at ``save``, whatever the caller writes
    into its tensors afterwards (the background write reads a copy)."""
    t = tree("dict")
    want = {"a": t["a"].clone(), "b": [x.clone() for x in t["b"]]}
    m = tckpt.CheckpointManager(str(tmp_path))
    with fault_hook(lambda p: time.sleep(0.2) if p == "ckpt.mid_write"
                    else None):
        m.save(1, t, blocking=False)
        t["a"].fill_(7.0)
        t["b"][0].fill_(7)
        m.wait()
    assert_tree_equal(m.restore(1, target_like("dict"), device="cpu"), want)


def test_ckpt_index_snapshot_holds_the_jax_leaf_order(tmp_path):
    """leaf_0..leaf_{9+H}: keys, vals, tomb, n, levels[0..H-1], pkeys,
    pvals, ptomb, pn, n_updates, overflow — and the JAX manager restores
    it into a JAX PIIndex with the same state."""
    idx = port_index()
    H = idx.config.num_levels
    m = tckpt.CheckpointManager(str(tmp_path))
    m.save(0, idx, blocking=True)
    with np.load(tmp_path / "step_0" / "host0.npz") as z:
        assert sorted(z.files) == sorted(f"leaf_{i}" for i in range(10 + H))
        specs = [(z[f"leaf_{i}"].shape, z[f"leaf_{i}"].dtype.name)
                 for i in range(10 + H)]
    C, PC = 1024, 128
    assert specs[:4] == [((C,), "int32"), ((C,), "int32"), ((C,), "bool"),
                         ((), "int32")]
    assert specs[4:4 + H] == [((idx.config.level_size(lvl),), "int32")
                              for lvl in range(1, H + 1)]
    assert specs[4 + H:] == [((PC,), "int32"), ((PC,), "int32"),
                             ((PC,), "bool"), ((), "int32"), ((), "int32"),
                             ((), "bool")]
    jcfg, _ = configs(backend="xla", **GEOMETRY)
    jidx = jckpt.CheckpointManager(str(tmp_path)).restore(0, jpi.empty(jcfg))
    assert_same_state(jidx, idx, "port snapshot read by JAX")


def test_ckpt_restores_a_jax_snapshot(tmp_path):
    jcfg, tcfg = configs(backend="xla", **GEOMETRY)
    rng = np.random.default_rng(1)
    keys = rng.choice(5000, 300, replace=False).astype(np.int32)
    jidx = jpi.build(jcfg, jnp.asarray(keys), jnp.arange(300,
                                                         dtype=jnp.int32))
    jidx, _ = jpi.insert_batch(jidx, jnp.arange(7000, 7040, dtype=jnp.int32),
                               jnp.arange(40, dtype=jnp.int32))
    jckpt.CheckpointManager(str(tmp_path)).save(2, jidx, blocking=True)
    got = tckpt.CheckpointManager(str(tmp_path)).restore(
        2, tpi.leaf_spec(tcfg), device="cpu")
    assert_same_state(jidx, got, "JAX snapshot read by the port")
    assert tpi.validate_layout(got)


def test_ckpt_restore_latest_empty_dir(tmp_path):
    m = tckpt.CheckpointManager(str(tmp_path))
    assert m.latest_step() is None
    assert m.restore_latest(target_like("dict")) == (None, None)


def test_ckpt_latest_step_skips_partial_and_corrupt(tmp_path):
    t = tree("index")
    m = tckpt.CheckpointManager(str(tmp_path))
    m.save(1, t, blocking=True)
    m.save(2, t, blocking=True)
    os.makedirs(os.path.join(str(tmp_path), "step_9.tmp"))
    bad = os.path.join(str(tmp_path), "step_7")
    os.makedirs(bad)
    with open(os.path.join(bad, "manifest.json"), "w") as f:
        f.write("{not json")
    worse = os.path.join(str(tmp_path), "step_8")
    os.makedirs(worse)
    with open(os.path.join(worse, "manifest.json"), "w") as f:
        json.dump({"step": 8}, f)
    assert m.all_steps() == [1, 2]
    assert m.latest_step() == 2


@pytest.mark.parametrize("point", ["ckpt.mid_write", "ckpt.pre_rename"])
def test_ckpt_crash_leaves_no_visible_checkpoint(tmp_path, point):
    t = tree("index")
    m = tckpt.CheckpointManager(str(tmp_path))
    with crash_at(point) as state:
        with pytest.raises(SimulatedCrash):
            m.save(5, t, blocking=True)
    assert state.hits_seen == 1
    assert m.latest_step() is None
    assert os.path.isdir(os.path.join(str(tmp_path), "step_5.tmp"))
    m.save(5, t, blocking=True)        # a later save publishes over it
    assert m.latest_step() == 5
    assert_tree_equal(m.restore(5, target_like("index"), device="cpu"), t)


def test_ckpt_async_failure_reraises_from_wait(tmp_path):
    t = tree("index")
    m = tckpt.CheckpointManager(str(tmp_path))
    with crash_at("ckpt.mid_write"):
        m.save(4, t, blocking=False)
        with pytest.raises(SimulatedCrash):
            m.wait()
    assert m.latest_step() is None
    m.wait()                           # the latch is one-shot
    m.save(6, t, blocking=True)
    assert m.latest_step() == 6


def test_ckpt_async_failure_reraises_from_next_save(tmp_path):
    t = tree("index")
    m = tckpt.CheckpointManager(str(tmp_path))
    with crash_at("ckpt.mid_write"):
        m.save(4, t, blocking=False)
        with pytest.raises(SimulatedCrash):
            m.save(5, t, blocking=False)
    m.save(5, t, blocking=True)
    assert m.latest_step() == 5


def test_ckpt_keep_gc(tmp_path):
    t = tree("dict")
    m = tckpt.CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        m.save(s, t, blocking=True)
    assert m.all_steps() == [3, 4]
    assert not os.path.exists(os.path.join(str(tmp_path), "step_1"))


@pytest.mark.parametrize("field,match", [("pending", "shape"),
                                         ("key_dtype", "dtype")])
def test_ckpt_restore_mismatch_raises(tmp_path, field, match):
    m = tckpt.CheckpointManager(str(tmp_path))
    m.save(1, tree("index"), blocking=True)
    other = port_index(pending=64) if field == "pending" else \
        port_index(key_dtype="int64")
    with pytest.raises(ValueError, match=match):
        m.restore(1, other, device="cpu")


def test_ckpt_refuses_shardings_and_needs_a_card_by_default(tmp_path):
    m = tckpt.CheckpointManager(str(tmp_path))
    m.save(1, tree("dict"), blocking=True)
    with pytest.raises(NotImplementedError, match="A9"):
        m.restore(1, target_like("dict"), shardings=object())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            m.restore(1, target_like("dict"))


# ---------------------------------------------------------------------------
# recovery: the port driven like tests/test_durability.py drives JAX
# ---------------------------------------------------------------------------

def seeded(backend="cuda"):
    """The initial build of ``test_durability.seeded`` on the port."""
    rng = np.random.default_rng(5)
    keys0 = np.unique(rng.integers(1, KEY_SPACE, 25).astype(np.int32))
    vals0 = rng.integers(0, 1000, keys0.size).astype(np.int32)
    _, tcfg = configs(backend="xla", **GEOMETRY)
    return tpi.build(dataclasses.replace(tcfg, backend=backend), keys0,
                     vals0, device="cpu"), (keys0, vals0)


def copy_window(w):
    return tp.Window(ops=w.ops.copy(), keys=w.keys.copy(),
                     vals=w.vals.copy(), occupancy=w.occupancy,
                     qids=list(w.qids), slots=w.slots.copy(),
                     t_open=w.t_open, t_enq=w.t_enq.copy(),
                     trigger=w.trigger, keys2=w.keys2.copy())


def drive(d, *, backend="cuda", crash_point=None, hit=1, snapshot_every=4,
          n=300, batch=16, fsync="per_window", seed=11):
    """``test_durability.drive`` on the port: the same stream through a
    durable port pipeline, optionally dying mid-way.  Returns (sealed
    window copies, acked seqs, crashed?, metrics)."""
    index, _ = seeded(backend)
    t, ops, keys, vals = mk_stream(n, seed)
    met = tp.PipelineMetrics()
    sealed, acked = [], []
    crashed = False
    ctx = (crash_at(crash_point, hit) if crash_point
           else contextlib.nullcontext())
    try:
        with ctx:
            dur = tp.Durability(d, index, fsync=fsync,
                                snapshot_every=snapshot_every, metrics=met)

            def hook(win):
                sealed.append(copy_window(win))
                acked.append(dur.on_seal(win))

            col = tp.Collector(tp.WindowConfig(batch=batch), on_seal=hook)
            disp = tp.Dispatcher(index, depth=1, durability=dur)
            qids = np.arange(n)
            for s in range(0, n, batch):
                e = min(n, s + batch)
                for w in col.offer_many(t[s:e], ops[s:e], keys[s:e],
                                        vals[s:e], qids[s:e])[1]:
                    disp.submit(w)
            tail = col.take()
            if tail is not None:
                disp.submit(tail)
            disp.flush()
            dur.close()
    except SimulatedCrash:
        crashed = True
    return sealed, acked, crashed, met


def fresh_replay(windows, backend="cuda"):
    """The never-crashed reference: a port dispatcher over ``windows``."""
    index, _ = seeded(backend)
    disp = tp.Dispatcher(index, depth=0)
    for w in windows:
        disp.submit(copy_window(w))
    return disp.index


def ref_pairs(windows):
    """Sequential RefIndex over the same windows, as sorted pairs."""
    _, (keys0, vals0) = seeded()
    ref = RefIndex.build(keys0, vals0)
    for w in windows:
        occ = w.occupancy
        ref.execute(w.ops[:occ], w.keys[:occ], w.vals[:occ])
    return sorted(ref.data.items())


def live_pairs(index):
    k, v = tpi.live_items(index)
    return list(zip(k.tolist(), v.tolist()))


def recovered(d):
    step = tckpt.CheckpointManager(os.path.join(d, "ckpt")).latest_step()
    index, replayed = tp.recover(d, device="cpu")
    assert [r.seq for r in replayed] == \
        list(range(step + 1, step + 1 + len(replayed)))
    return index, step + len(replayed)


def check_recovery_contract(d, sealed, acked, crash_point):
    """The acked-prefix contract of ``test_durability``, on the port."""
    index, n_applied = recovered(d)
    acked_max = acked[-1] if acked else 0
    assert acked_max <= n_applied <= len(sealed)
    if crash_point == "wal.mid_append":
        assert n_applied == acked_max          # the torn record is out
    elif crash_point in ("wal.after_append", "wal.pre_sync"):
        assert n_applied <= acked_max + 1
    else:
        assert n_applied == acked_max == len(sealed)
    assert leaves_equal(index, fresh_replay(sealed[:n_applied]))
    assert live_pairs(index) == ref_pairs(sealed[:n_applied])
    return index, n_applied


def same_windows(a, b):
    return len(a) == len(b) and all(
        np.array_equal(x.ops, y.ops) and np.array_equal(x.keys, y.keys)
        and np.array_equal(x.vals, y.vals) and x.qids == y.qids
        for x, y in zip(a, b))


@pytest.mark.parametrize("point", faults.FAULT_POINTS)
def test_crash_point_recovery(tmp_path, point):
    """Die at each fault point, recover on the port: the acked-prefix
    contract, bit-identity to a crash-free dispatcher and RefIndex, and
    the same windows and leaves as the JAX package crashed at the same
    point and recovered by the JAX ``recover``."""
    hit = 3 if point.startswith("wal.") else 2
    d = str(tmp_path / "port")
    sealed, acked, crashed, _ = drive(d, crash_point=point, hit=hit)
    assert crashed, f"fault point {point} was never reached"
    index, n_applied = check_recovery_contract(d, sealed, acked, point)
    assert n_applied > 0
    jd = str(tmp_path / "jax")
    jsealed, jacked, jcrashed, _ = jax_drive(jd, "single", crash_point=point,
                                             hit=hit)
    assert jcrashed and jacked == acked
    assert same_windows(sealed, jsealed)
    jindex, jreplayed = jp.recover(jd)
    assert_same_state(jindex, index, point)


def test_crash_after_snapshot_replays_only_tail(tmp_path):
    d = str(tmp_path)
    sealed, _, crashed, _ = drive(d, crash_point="wal.mid_append", hit=7,
                                  snapshot_every=4)
    assert crashed
    step = tckpt.CheckpointManager(os.path.join(d, "ckpt")).latest_step()
    assert step >= 4                           # a periodic snapshot landed
    met = tp.PipelineMetrics()
    index, replayed = tp.recover(d, metrics=met, device="cpu")
    assert met.recovery_replayed == len(replayed) == 6 - step
    assert leaves_equal(index, fresh_replay(sealed[:6]))


@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_crashfree_roundtrip_is_bit_identical(tmp_path, backend):
    d = str(tmp_path)
    sealed, acked, crashed, met = drive(d, backend=backend,
                                        snapshot_every=5)
    assert not crashed
    assert met.wal_appends == len(sealed) == acked[-1]
    assert met.wal_fsyncs >= met.wal_appends
    rmet = tp.PipelineMetrics()
    index, replayed = tp.recover(d, metrics=rmet, device="cpu")
    assert index.config.backend == backend
    assert rmet.summary()["recovery_replayed"] == len(replayed) > 0
    final = fresh_replay(sealed, backend)
    assert leaves_equal(index, final)
    assert live_pairs(index) == ref_pairs(sealed)
    # the other backend replays the same directory to the same leaves
    other = tpi.with_backend(tp.recover(d, device="cpu")[0],
                             "torch" if backend == "cuda" else "cuda")
    assert leaves_equal(other, final)


def test_recover_after_crash_then_resume(tmp_path):
    """recover → a new Durability over the same dir → keep serving → the
    second recovery sees one continuous history."""
    d = str(tmp_path)
    sealed, acked, crashed, _ = drive(d, crash_point="wal.mid_append", hit=4)
    assert crashed
    index, n1 = recovered(d)
    assert n1 == acked[-1]
    dur = tp.Durability(d, index, fsync="per_window", snapshot_every=0)
    assert dur.wal.last_seq == n1              # seq continues, tear gone
    sealed2 = []

    def hook(win):
        sealed2.append(copy_window(win))
        dur.on_seal(win)

    col = tp.Collector(tp.WindowConfig(batch=16), on_seal=hook)
    disp = tp.Dispatcher(index, depth=0, durability=dur)
    t, ops, keys, vals = mk_stream(120, seed=77)
    for w in col.offer_many(t, ops, keys, vals, np.arange(120))[1]:
        disp.submit(w)
    tail = col.take()
    if tail is not None:
        disp.submit(tail)
    disp.flush()
    dur.close()
    index2, _ = tp.recover(d, device="cpu")
    assert leaves_equal(index2, disp.index)
    assert leaves_equal(index2, fresh_replay(sealed[:n1] + sealed2))


def test_recover_empty_dir_raises(tmp_path):
    with pytest.raises(tp.RecoveryError, match="durability.json"):
        tp.recover(str(tmp_path), device="cpu")


def test_recover_without_snapshot_raises(tmp_path):
    d = str(tmp_path)
    with crash_at("ckpt.mid_write", hit=1):
        with pytest.raises(SimulatedCrash):
            tp.Durability(d, seeded()[0])
    with pytest.raises(tp.RecoveryError, match="snapshot"):
        tp.recover(d, device="cpu")


def test_fsync_off_recovery_still_prefix_consistent(tmp_path):
    d = str(tmp_path)
    sealed, _, crashed, met = drive(d, crash_point="wal.mid_append", hit=5,
                                    fsync="off")
    assert crashed and met.wal_fsyncs == 0
    index, n_applied = recovered(d)
    assert n_applied <= len(sealed)
    assert leaves_equal(index, fresh_replay(sealed[:n_applied]))


SNAP_SLEEP = 0.3  # how long each snapshot write is forced to take


def _drive_timed_snapshots(d, *, async_snapshots, n=96, batch=16):
    """Six windows, one periodic snapshot (seq 4) under slow writes;
    returns (submit wall time per seq, sealed copies, final index)."""
    index, _ = seeded()
    t, ops, keys, vals = mk_stream(n, seed=23)
    dur = tp.Durability(d, index, fsync="per_window", snapshot_every=4,
                        async_snapshots=async_snapshots)
    sealed, times = [], {}

    def hook(win):
        sealed.append(copy_window(win))
        dur.on_seal(win)

    col = tp.Collector(tp.WindowConfig(batch=batch), on_seal=hook)
    disp = tp.Dispatcher(index, depth=0, durability=dur)

    def timed_submit(w):
        t0 = time.perf_counter()
        disp.submit(w)
        times[w.seq] = time.perf_counter() - t0

    with fault_hook(lambda p: time.sleep(SNAP_SLEEP)
                    if p == "ckpt.mid_write" else None):
        for s in range(0, n, batch):
            for w in col.offer_many(t[s:s + batch], ops[s:s + batch],
                                    keys[s:s + batch], vals[s:s + batch],
                                    np.arange(s, s + batch))[1]:
                timed_submit(w)
        tail = col.take()
        if tail is not None:
            timed_submit(tail)
        disp.flush()
        dur.close()
    return times, sealed, disp.index


def test_async_snapshot_does_not_stall_the_serving_tick(tmp_path):
    times, sealed, final = _drive_timed_snapshots(str(tmp_path / "async"),
                                                  async_snapshots=True)
    assert times[4] < SNAP_SLEEP / 2
    index, _ = tp.recover(str(tmp_path / "async"), device="cpu")
    assert leaves_equal(index, final)
    assert leaves_equal(index, fresh_replay(sealed))
    times_b, _, _ = _drive_timed_snapshots(str(tmp_path / "block"),
                                           async_snapshots=False)
    assert times_b[4] >= SNAP_SLEEP


def test_async_snapshot_error_surfaces_at_close_and_loses_nothing(tmp_path):
    d = str(tmp_path)
    index, _ = seeded()
    t, ops, keys, vals = mk_stream(96, seed=29)
    dur = tp.Durability(d, index, fsync="per_window", snapshot_every=4,
                        async_snapshots=True)
    sealed = []

    def seal_hook(win):
        sealed.append(copy_window(win))
        dur.on_seal(win)

    col = tp.Collector(tp.WindowConfig(batch=16), on_seal=seal_hook)
    disp = tp.Dispatcher(index, depth=0, durability=dur)

    def fail(point):
        if point == "ckpt.mid_write":
            raise SimulatedCrash(point)

    with fault_hook(fail):
        for s in range(0, 96, 16):
            for w in col.offer_many(t[s:s + 16], ops[s:s + 16],
                                    keys[s:s + 16], vals[s:s + 16],
                                    np.arange(s, s + 16))[1]:
                disp.submit(w)     # the seq-4 snapshot fails in the back
        tail = col.take()
        if tail is not None:
            disp.submit(tail)
        disp.flush()
        with pytest.raises(SimulatedCrash):
            dur.close()
    assert tckpt.CheckpointManager(os.path.join(d, "ckpt")).latest_step() \
        == 0
    index2, replayed = tp.recover(d, device="cpu")
    assert len(replayed) == len(sealed)
    assert leaves_equal(index2, fresh_replay(sealed))


# ---------------------------------------------------------------------------
# interchange of durability directories
# ---------------------------------------------------------------------------

def mixed_stream(n=400, seed=3):
    """Point ops and RANGEs over a small key space (the WAL's v2 lane)."""
    rng = np.random.default_rng(seed)
    ops = rng.integers(0, 4, n).astype(np.int32)
    keys = rng.integers(1, 300, n).astype(np.int32)
    s = type("Stream", (), {})()
    s.t = np.arange(n, dtype=np.float64)
    s.ops, s.keys = ops, keys
    s.vals = rng.integers(0, 1000, n).astype(np.int32)
    s.keys2 = np.where(ops == RANGE, keys + rng.integers(0, 40, n),
                       0).astype(np.int32)
    return s


def initial_keys():
    rng = np.random.default_rng(8)
    keys0 = rng.choice(np.arange(1, 300), 80, replace=False).astype(np.int32)
    return keys0, np.arange(80, dtype=np.int32)


def run_durable(pkg, index, d, stream):
    """A whole stream through ``pkg``'s ``Dispatcher.run`` with a
    Durability (snapshots every 3 windows), then ``close``."""
    dur = pkg.Durability(d, index, snapshot_every=3)
    disp = pkg.Dispatcher(index, depth=1, durability=dur)
    retired = disp.run(stream, pkg.WindowConfig(batch=32))
    dur.close()
    return disp.index, retired


@pytest.mark.parametrize("jax_backend", ["xla", "pallas-interpret"])
def test_port_recovers_a_jax_directory(tmp_path, jax_backend):
    jcfg, _ = configs(backend=jax_backend, **GEOMETRY)
    keys0, vals0 = initial_keys()
    d = str(tmp_path)
    jlive, _ = run_durable(jp, jpi.build(jcfg, jnp.asarray(keys0),
                                         jnp.asarray(vals0)),
                           d, mixed_stream())
    with open(os.path.join(d, "durability.json")) as f:
        assert json.load(f)["config"]["backend"] == jax_backend
    jindex, jreplayed = jp.recover(d)
    index, replayed = tp.recover(d, device="cpu")
    assert index.config.backend == BACKEND_FROM_DISK[jax_backend]
    assert [r.seq for r in replayed] == [r.seq for r in jreplayed] != []
    assert_same_state(jindex, index, "JAX directory, port recover")
    assert_same_state(jlive, index, "JAX live state")


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_jax_reads_a_port_directory(tmp_path, backend):
    """The port records its backend under the JAX name.  A ``torch``
    directory ("xla") recovers in the JAX package to the port's leaves; a
    ``cuda`` one ("pallas") names the Pallas kernels, which the JAX
    package runs only on a TPU, so here it restores the snapshot and
    reads the log with the JAX modules."""
    _, tcfg = configs(backend="xla", **GEOMETRY)
    keys0, vals0 = initial_keys()
    d = str(tmp_path)
    live, retired = run_durable(
        tp, tpi.build(dataclasses.replace(tcfg, backend=backend), keys0,
                      vals0, device="cpu"), d, mixed_stream())
    assert any(r.rcnt is not None for r in retired)
    with open(os.path.join(d, "durability.json")) as f:
        meta = json.load(f)
    assert meta["config"]["backend"] == BACKEND_ON_DISK[backend]
    index, replayed = tp.recover(d, device="cpu")
    assert leaves_equal(index, live)
    if backend == "torch":
        jindex, jreplayed = jp.recover(d)
        assert [r.seq for r in jreplayed] == [r.seq for r in replayed] != []
        assert_same_state(jindex, index, "port directory, JAX recover")
        return
    jcfg, _ = configs(backend="xla", **GEOMETRY)
    m = jckpt.CheckpointManager(os.path.join(d, "ckpt"))
    step = m.latest_step()
    jsnap = m.restore(step, jpi.empty(jcfg))
    tsnap = tckpt.CheckpointManager(os.path.join(d, "ckpt")).restore(
        step, tpi.leaf_spec(index.config), device="cpu")
    assert_same_state(jsnap, tsnap, "snapshot")
    jrecs = jwal.read_wal(os.path.join(d, "wal"))
    assert [r.seq for r in jrecs if r.seq > step] == \
        [r.seq for r in replayed]


def test_sharded_and_overload_are_refused(tmp_path):
    """The sharded kind is refused (ROADMAP A9).  An overload config is
    accepted now that the breaker is ported: the replay behind it gives
    the state a replay without it gives."""
    d = str(tmp_path)
    tp.Durability(d, seeded()[0]).close()
    meta_path = os.path.join(d, "durability.json")
    with open(meta_path) as f:
        meta = json.load(f)
    behind, _ = tp.recover(d, overload=tp.OverloadConfig(), device="cpu")
    assert leaves_equal(behind, tp.recover(d, device="cpu")[0])
    meta.update(kind="sharded", n_shards=2)
    with open(meta_path, "w") as f:
        json.dump(meta, f)
    with pytest.raises(NotImplementedError, match="A9"):
        tp.recover(d, device="cpu")
    with pytest.raises(NotImplementedError, match="A9"):
        tp.Durability(str(tmp_path / "other"), object())
