"""Segmented, CRC-framed write-ahead log at the admission point.

Counterpart of ``repro.pipeline.wal``, byte for byte: a segment written
by either package reads in the other.  It is host code (numpy over the
port's ``Window``); nothing here touches the card.

Durability rides the seam the pipeline already has: every arrival enters
the index through a sealed collection ``Window``, so logging one record
per seal captures the complete update stream — ops/keys/vals of the
occupied slot prefix plus the arrival-side qid→slot map, as raw numpy
bytes.  Replaying those records through the *same* dispatcher execute
path the live system uses makes recovery bit-identical to never having
crashed (window seal is the single serialized point where logging
composes with the batched, latch-free execute).

Format — segments ``wal-<firstseq:016d>.seg``, each a run of records:

    header (36 B, little-endian):
        magic   4s   b"PIW2" (b"PIW1" read-compatibly; see below)
        seq     u64  1-based, strictly consecutive across segments
        batch   u32  the window's static batch shape (replay re-pads to it)
        occ     u32  occupied slots logged (<= batch)
        n_arr   u32  admitted arrivals (qids/slots length)
        plen    u32  payload byte length (redundant; integrity cross-check)
        kdt     u8   key dtype code (0=int32, 1=int64) + 3 pad bytes
        crc     u32  crc32 over header-with-crc-zeroed + payload
    payload: ops i32[occ] | keys kdt[occ] | keys2 kdt[occ] | vals i32[occ]
           | qids i64[n_arr] | slots i32[n_arr]

Version 2 adds the ``keys2`` lane (RANGE upper bounds, 0 at point slots)
so recovery replays range-bearing windows through the same dispatcher
path.  The writer always emits v2; the reader accepts v1 segments from
pre-range logs — their payload simply lacks the keys2 block, which
decodes as all-zeros (v1 windows cannot contain RANGE ops).  Each magic
implies its own exact payload length, so the CRC + length cross-check
still rejects any frame that doesn't parse as its declared version.

Torn-tail vs corruption: a record that runs past EOF, or whose CRC fails
with nothing valid after it in the *final* segment, is a torn tail — the
log recovers to the prefix before it (an unacknowledged window, never
acked under any fsync policy).  A CRC failure followed by valid records,
a sequence-number duplicate or gap, or a missing segment file is interior
corruption: ``WalCorruptionError``, never a silent drop of interior
records.

Fsync policy: ``per_window`` fsyncs every append
(acknowledged == durable), ``interval`` fsyncs when ``fsync_interval``
seconds have passed since the last sync — or, with ``group_commit=N``
set, when N appends have accumulated unsynced, whichever comes first
(bounded loss window in both time and count, one fsync amortized over
the group; ``group_commit=None``, the default, keeps the policy purely
time-driven), ``off``
never fsyncs (durable only against process death, not host death).
``durable_seq`` is the last sequence number the policy guarantees.
"""
from __future__ import annotations

import dataclasses
import os
import re
import struct
import time
import zlib
from typing import List, Optional

import numpy as np

from repro_torch.core.batch import SEARCH
from repro_torch.faults import faultpoint
from repro_torch.kernels.pi_search import sentinel_for
from repro_torch.pipeline.collector import Window

MAGIC_V1 = b"PIW1"
MAGIC = b"PIW2"
_HEADER = struct.Struct("<4sQIIIIB3xI")
_KDT_CODES = {"int32": 0, "int64": 1}
_KDT_NAMES = {v: k for k, v in _KDT_CODES.items()}

FSYNC_POLICIES = ("per_window", "interval", "off")

_SEG_RE = re.compile(r"^wal-(\d{16})\.seg$")


class WalCorruptionError(RuntimeError):
    """The log is damaged beyond a torn tail: interior CRC mismatch,
    sequence duplicate/gap, or a missing segment.  Recovery must stop
    loudly — replaying around the damage would silently drop interior
    records."""


@dataclasses.dataclass
class WalRecord:
    """One decoded log record (the durable image of a sealed window)."""

    seq: int
    batch: int
    ops: np.ndarray    # (occ,) int32
    keys: np.ndarray   # (occ,) key dtype
    vals: np.ndarray   # (occ,) int32
    qids: np.ndarray   # (n_arr,) int64
    slots: np.ndarray  # (n_arr,) int32
    keys2: Optional[np.ndarray] = None  # (occ,) key dtype; None == zeros
    #   (v1 records and hand-built point-only records have no range lane)

    @property
    def occupancy(self) -> int:
        return self.ops.shape[0]


# ---------------------------------------------------------------------------
# record codec
# ---------------------------------------------------------------------------

def _payload_len(occ: int, n_arr: int, key_itemsize: int,
                 version: int = 2) -> int:
    # v2 carries two key lanes per occupied slot (keys + keys2); v1 one
    nkeys = 2 if version >= 2 else 1
    return occ * (8 + nkeys * key_itemsize) + n_arr * 12


def encode_record(seq: int, window: Window) -> bytes:
    occ = window.occupancy
    n_arr = window.n_arrivals
    kdt = window.keys.dtype
    code = _KDT_CODES.get(kdt.name)
    if code is None:
        raise ValueError(f"unsupported WAL key dtype {kdt}")
    keys2 = window.keys2[:occ] if window.keys2 is not None \
        else np.zeros(occ, kdt)
    payload = b"".join((
        np.ascontiguousarray(window.ops[:occ], np.int32).tobytes(),
        np.ascontiguousarray(window.keys[:occ]).tobytes(),
        np.ascontiguousarray(keys2, kdt).tobytes(),
        np.ascontiguousarray(window.vals[:occ], np.int32).tobytes(),
        np.asarray(window.qids, np.int64).tobytes(),
        np.ascontiguousarray(window.slots, np.int32).tobytes(),
    ))
    head0 = _HEADER.pack(MAGIC, seq, window.ops.shape[0], occ, n_arr,
                         len(payload), code, 0)
    crc = zlib.crc32(payload, zlib.crc32(head0))
    return _HEADER.pack(MAGIC, seq, window.ops.shape[0], occ, n_arr,
                        len(payload), code, crc) + payload


def _decode_payload(seq, batch, occ, n_arr, kdt, payload,
                    version: int) -> WalRecord:
    ksz = kdt.itemsize
    o = 0
    ops = np.frombuffer(payload, np.int32, occ, o); o += 4 * occ
    keys = np.frombuffer(payload, kdt, occ, o); o += ksz * occ
    if version >= 2:
        keys2 = np.frombuffer(payload, kdt, occ, o); o += ksz * occ
    else:
        keys2 = np.zeros(occ, kdt)   # pre-range log: no RANGE ops existed
    vals = np.frombuffer(payload, np.int32, occ, o); o += 4 * occ
    qids = np.frombuffer(payload, np.int64, n_arr, o); o += 8 * n_arr
    slots = np.frombuffer(payload, np.int32, n_arr, o)
    return WalRecord(seq=seq, batch=batch, ops=ops, keys=keys, vals=vals,
                     qids=qids, slots=slots, keys2=keys2)


def record_window(rec: WalRecord) -> Window:
    """Re-pad a logged record to the exact batch arrays ``execute`` saw.

    Pad slots are sentinel SEARCHes, byte-for-byte what ``Collector._seal``
    produced — so replaying the window through the dispatcher is
    bit-identical to the live execution it logs.
    """
    occ = rec.occupancy
    kdt = rec.keys.dtype
    ops = np.full(rec.batch, SEARCH, np.int32)
    keys = np.full(rec.batch, sentinel_for(kdt), kdt)
    keys2 = np.zeros(rec.batch, kdt)
    vals = np.zeros(rec.batch, np.int32)
    ops[:occ] = rec.ops
    keys[:occ] = rec.keys
    if rec.keys2 is not None:
        keys2[:occ] = rec.keys2
    vals[:occ] = rec.vals
    return Window(ops=ops, keys=keys, vals=vals, occupancy=occ,
                  qids=rec.qids.tolist(), slots=rec.slots.copy(),
                  t_open=0.0, t_enq=np.zeros(rec.qids.shape[0]),
                  trigger="recovered", seq=rec.seq, keys2=keys2)


# ---------------------------------------------------------------------------
# reading
# ---------------------------------------------------------------------------

def _try_parse(buf: bytes, off: int):
    """Parse one record at ``off``; None if the bytes there don't frame a
    complete, CRC-clean record (used both by the scanner and by the
    tail-vs-interior disambiguation)."""
    if len(buf) - off < _HEADER.size:
        return None
    magic, seq, batch, occ, n_arr, plen, code, crc = _HEADER.unpack_from(
        buf, off)
    if magic not in (MAGIC, MAGIC_V1) or code not in _KDT_NAMES \
            or occ > batch:
        return None
    version = 2 if magic == MAGIC else 1
    kdt = np.dtype(_KDT_NAMES[code])
    if plen != _payload_len(occ, n_arr, kdt.itemsize, version):
        return None
    end = off + _HEADER.size + plen
    if end > len(buf):
        return None
    head0 = _HEADER.pack(magic, seq, batch, occ, n_arr, plen, code, 0)
    payload = buf[off + _HEADER.size:end]
    if zlib.crc32(payload, zlib.crc32(head0)) != crc:
        return None
    return _decode_payload(seq, batch, occ, n_arr, kdt, payload,
                           version), end


def _scan_segment(path: str, expect_seq: int, is_last: bool):
    """Decode one segment → (records, valid_end_offset).

    A broken record at the effective end of the final segment is a torn
    tail (scan stops, prefix survives); broken bytes anywhere else — or a
    clean record with the wrong sequence number — raise."""
    with open(path, "rb") as f:
        buf = f.read()
    records: List[WalRecord] = []
    off = 0
    while off < len(buf):
        parsed = _try_parse(buf, off)
        if parsed is None:
            if is_last and _tail_is_dead(buf, off):
                break                      # torn tail: prefix survives
            raise WalCorruptionError(
                f"unreadable record at byte {off} of {path} with valid "
                f"data after it (interior corruption, not a torn tail)")
        rec, end = parsed
        if rec.seq != expect_seq:
            kind = "duplicate" if rec.seq < expect_seq else "gap in"
            raise WalCorruptionError(
                f"{kind} sequence numbers at byte {off} of {path}: "
                f"got seq {rec.seq}, expected {expect_seq}")
        records.append(rec)
        expect_seq += 1
        off = end
    return records, off


def _tail_is_dead(buf: bytes, off: int) -> bool:
    """True iff no complete valid record exists at or after ``off`` —
    i.e. the damage is a torn tail, not interior corruption."""
    # a torn write corrupts one contiguous region; scanning forward at
    # every offset is O(n^2) worst case but runs only on a damaged tail
    for o in range(off, len(buf)):
        if _try_parse(buf, o) is not None:
            return False
    return True


def _segment_files(directory: str):
    out = []
    for name in sorted(os.listdir(directory)):
        m = _SEG_RE.match(name)
        if m:
            out.append((int(m.group(1)), os.path.join(directory, name)))
    return out


def read_wal(directory: str) -> List[WalRecord]:
    """Decode every surviving record, in sequence order.

    Raises ``WalCorruptionError`` on interior damage; a torn tail in the
    final segment silently ends the scan (those bytes were never
    acknowledged under any fsync policy)."""
    segs = _segment_files(directory)
    records: List[WalRecord] = []
    expect = None
    for i, (start, path) in enumerate(segs):
        if expect is not None and start != expect:
            raise WalCorruptionError(
                f"missing WAL segment: records {expect}..{start - 1} "
                f"absent before {os.path.basename(path)}")
        recs, _ = _scan_segment(path, start, is_last=(i == len(segs) - 1))
        if i < len(segs) - 1 and len(recs) != \
                (segs[i + 1][0] - start):
            raise WalCorruptionError(
                f"segment {os.path.basename(path)} ends at seq "
                f"{start + len(recs) - 1} but the next segment starts at "
                f"{segs[i + 1][0]}")
        records.extend(recs)
        expect = start + len(recs)
    return records


# ---------------------------------------------------------------------------
# writing
# ---------------------------------------------------------------------------

class WalWriter:
    """Appender with segment rotation, torn-tail repair and fsync policy.

    Opening an existing directory validates the whole log (so corruption
    is caught at restart, not at the next recovery), truncates a torn
    tail off the final segment, and resumes the sequence numbering.
    Files are opened unbuffered: every ``write`` reaches the OS, so a
    Python-level crash can tear at most the record being appended —
    exactly the failure the ``wal.mid_append`` fault point simulates.
    """

    def __init__(self, directory: str, *, fsync: str = "per_window",
                 fsync_interval: float = 0.05,
                 segment_bytes: int = 1 << 22,
                 group_commit: "int | None" = None):
        if fsync not in FSYNC_POLICIES:
            raise ValueError(f"fsync {fsync!r} not in {FSYNC_POLICIES}")
        if group_commit is not None and group_commit < 1:
            raise ValueError(f"group_commit must be >= 1, got {group_commit}")
        self.dir = directory
        self.fsync = fsync
        self.fsync_interval = fsync_interval
        self.segment_bytes = segment_bytes
        # under fsync="interval": also sync once this many appends are
        # unsynced, amortizing one fsync over a batch of windows while
        # bounding the acknowledged-but-volatile frontier by count as
        # well as by time; None = time-driven only (the legacy policy)
        self.group_commit = group_commit
        self._unsynced = 0
        self.n_appends = 0
        self.n_fsyncs = 0
        os.makedirs(directory, exist_ok=True)
        segs = _segment_files(directory)
        if segs:
            records = read_wal(directory)          # validates; raises early
            last_start, last_path = segs[-1]
            _, valid_end = _scan_segment(
                last_path, last_start, is_last=True)
            if valid_end < os.path.getsize(last_path):
                with open(last_path, "r+b") as f:  # drop the torn tail
                    f.truncate(valid_end)
            self._next_seq = (records[-1].seq + 1) if records else last_start
            self._path = last_path
            self._bytes = valid_end
        else:
            self._next_seq = 1
            self._path = self._seg_path(1)
            self._bytes = 0
        self._f = open(self._path, "ab", buffering=0)
        # whatever already survived on disk predates this process: treat
        # it as durable (it was acked under the previous writer's policy)
        self.durable_seq = self._next_seq - 1
        self._t_last_fsync = time.monotonic()

    def _seg_path(self, first_seq: int) -> str:
        return os.path.join(self.dir, f"wal-{first_seq:016d}.seg")

    @property
    def last_seq(self) -> int:
        """Last fully appended sequence number (0 = empty log)."""
        return self._next_seq - 1

    def append(self, window: Window) -> int:
        """Log one sealed window; returns its sequence number.

        Stamps ``window.seq``.  A window sealed elsewhere with a stale
        seq is a wiring bug — two writers, or a collector resumed without
        the log — and is refused before any bytes are written.
        """
        seq = self._next_seq
        if window.seq is not None and window.seq != seq:
            raise ValueError(
                f"window carries seq {window.seq} but the log is at "
                f"{seq}: windows must reach the WAL in seal order")
        blob = encode_record(seq, window)
        half = len(blob) // 2
        self._f.write(blob[:half])
        faultpoint("wal.mid_append")               # torn record on crash
        self._f.write(blob[half:])
        faultpoint("wal.after_append")             # written, not yet synced
        window.seq = seq
        self._next_seq = seq + 1
        self._bytes += len(blob)
        self.n_appends += 1
        self._unsynced += 1
        if self.fsync == "per_window":
            self.sync()
        elif self.fsync == "interval" and (
                (self.group_commit is not None and
                 self._unsynced >= self.group_commit) or
                time.monotonic() - self._t_last_fsync >= self.fsync_interval):
            self.sync()
        if self._bytes >= self.segment_bytes:
            self._rotate()
        return seq

    def sync(self):
        """fsync the current segment; advances the acknowledged frontier."""
        faultpoint("wal.pre_sync")    # written in full, ack not yet durable
        os.fsync(self._f.fileno())
        self.durable_seq = self.last_seq
        self.n_fsyncs += 1
        self._unsynced = 0
        self._t_last_fsync = time.monotonic()

    def _rotate(self):
        self.sync()                 # a sealed segment is always durable
        self._f.close()
        self._path = self._seg_path(self._next_seq)
        self._bytes = 0
        self._f = open(self._path, "ab", buffering=0)

    def truncate_through(self, seq: int):
        """Delete whole segments whose every record is <= ``seq``.

        Called after a snapshot stamped ``seq`` becomes durable: those
        records are materialized in the snapshot and replay starts after
        it.  The live (last) segment is never deleted, so the
        seq-continuity invariant across surviving segments holds."""
        segs = _segment_files(self.dir)
        for (start, path), (nxt_start, _) in zip(segs, segs[1:]):
            if nxt_start - 1 <= seq:
                os.remove(path)

    def close(self):
        if not self._f.closed:
            if self.fsync != "off":
                self.sync()
            self._f.close()
