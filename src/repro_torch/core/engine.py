"""SearchEngine — pluggable batched floor search over one PI shard.

Counterpart of ``repro.core.engine``.  Every traversal consumer
(``lookup``, ``execute``, ``traverse``) asks the engine for positions, and
``execute`` asks it for its batch sort; the engine dispatches one of two
backends:

================  ==========================================================
backend           what runs
================  ==========================================================
``torch``         the descent and a ``torch.searchsorted`` pending probe in
                  stock PyTorch ops (the JAX package's ``xla`` backend);
                  the batch sort is the stable ``torch.argsort`` of
                  ``core.batch.sort_queries``.
``cuda``          the hand-written kernels ``kernels.pi_search.pi_probe`` /
                  ``pi_search``, and ``kernels.bitonic_sort`` for the batch
                  sort.  On a CPU tensor the wrappers run their plain
                  versions, as ``pallas-interpret`` runs the Pallas kernels
                  on a CPU.  The default.
================  ==========================================================

The primitive is ``probe``: one batched call that returns the
storage-layer floor slot, the pending-buffer insertion point and the key
match flags for a whole query batch; ``cuda`` computes all three in one
kernel launch.  The backends agree bit for bit.  Liveness (tombstones,
``pn``) is the caller's business.

``range_agg`` aggregates ranges: ``cuda`` runs ``kernels.pi_range`` (one
launch: descent + occupied-rank walk + pending pass), ``torch`` computes
the same values in stock PyTorch ops.  Both read the tables of
``range_tables``, whose C-wide rank tables ``KEY_TABLES`` builds once per
storage key array.

``sort_queries`` is the batch sort of ``execute`` (the paper's Def. 3):
``cuda`` runs ``bitonic_argsort`` once (the kernel pads the batch and
puts the arrival index in the tie-break lane itself); both backends give
the same permutation.  The pending merge and the rebuilds sort with
``torch.argsort`` on both, as the JAX package sorts them outside any
Pallas kernel.
"""
from __future__ import annotations

import collections
import dataclasses
import functools
import threading
import weakref

import torch

from repro_torch.analysis.runtime import launch_guard
from repro_torch.core.batch import sort_queries
from repro_torch.kernels.bitonic_sort import bitonic_argsort
from repro_torch.kernels.pi_range import pending_prefix, pi_range, wrap_i32
from repro_torch.kernels.pi_search import (FLAG_MAIN_MATCH, FLAG_PENDING_HIT,
                                           gather_fill, pi_probe, pi_search,
                                           sentinel_for)

BACKENDS = ("torch", "cuda")


@dataclasses.dataclass(frozen=True)
class Probe:
    """Per-query result of the fused floor-search primitive.

    ``pos`` is raw (−1 on underflow, or past the live region for sentinel
    queries); ``ppos`` is clipped to the pending capacity.  ``p_hit`` is a
    *key* match within the pending array — the caller still intersects it
    with ``ppos < pn``.
    """

    pos: torch.Tensor         # (B,) int32 storage floor position, −1 = below
    main_match: torch.Tensor  # (B,) bool  storage key at pos equals query
    ppos: torch.Tensor        # (B,) int32 clipped pending insertion point
    p_hit: torch.Tensor       # (B,) bool  pending key at ppos equals query


class SearchEngine:
    """Backend-selectable descent over index layer + pending buffer."""

    def __init__(self, backend: str = "cuda", tile_q: int = 256):
        if backend not in BACKENDS:
            raise ValueError(
                f"unknown search backend {backend!r}; pick one of {BACKENDS}")
        self.backend = backend
        self.tile_q = tile_q

    def __repr__(self):
        return f"SearchEngine(backend={self.backend!r}, tile_q={self.tile_q})"

    # -- primitives --------------------------------------------------------

    def floor(self, index, q: torch.Tensor) -> torch.Tensor:
        """Floor positions: largest i with keys[i] <= q, else −1."""
        q = q.to(index.keys.dtype)
        if self.backend == "cuda":
            return pi_search(index.keys, q, fanout=index.config.fanout,
                             tile_q=self.tile_q, levels=index.levels)
        pos, underflow = self._descend_torch(index, q)
        return torch.where(underflow, -1, pos)

    def probe(self, index, q: torch.Tensor) -> Probe:
        """Fused floor + pending probe for a whole batch (the hot path)."""
        q = q.to(index.keys.dtype)
        if self.backend == "cuda":
            return self._probe_cuda(index, q)
        return self._probe_torch(index, q)

    def range_agg(self, index, lo: torch.Tensor, hi: torch.Tensor,
                  max_span: int):
        """Batched range aggregation → (count, sum) over keys in [lo, hi].

        The walk advances through *occupied ranks*, not raw slots: a
        rank→slot table skips segment slack so ``max_span`` counts real
        keys (live + tombstoned), and tombstones are gated out of the
        aggregate.  ``cuda`` runs ``kernels.pi_range``; ``torch`` computes
        the identical values with stock ops.  Sums wrap modulo 2^32.
        """
        kdt = index.keys.dtype
        lo, hi = lo.to(kdt), hi.to(kdt)
        live, rank, dense2slot, plive = range_tables(index)
        if self.backend == "cuda":
            return pi_range(
                index.keys, live, index.vals, rank, dense2slot, index.pkeys,
                index.pvals, plive, lo, hi, fanout=index.config.fanout,
                max_span=max_span, tile_q=self.tile_q, levels=index.levels)
        return self._range_torch(index, lo, hi, max_span, rank, dense2slot,
                                 plive)

    def sort_queries(self, ops: torch.Tensor, keys: torch.Tensor,
                     vals: torch.Tensor):
        """Stable sort of a query batch by key → (perm, ops, keys, vals)
        sorted, ``perm`` int64 (``core.batch.sort_queries``'s contract).

        ``cuda`` runs ``bitonic_argsort`` once: one C call that pads the B
        keys inside the kernel to its network's size with lanes that sort
        after every real one, makes the arrival index in registers as the
        tie-break value, sorts, and writes the int64 permutation of the
        first B lanes -- the stable argsort, since the network orders key
        ties by arrival.  Up to 2^13 keys that is one launch of one block;
        above, the launches of ``kernels.bitonic_sort.pass_plan``.  B <= 1
        launches nothing.
        """
        if self.backend != "cuda":
            return sort_queries(ops, keys, vals)
        perm = bitonic_argsort(keys)
        return perm, ops[perm], keys[perm], vals[perm]

    # -- torch backend -----------------------------------------------------

    def _descend_torch(self, index, q: torch.Tensor):
        """Vectorized Alg. 2: descend level H→1, at each level compare the
        F keys of the current entry's child group and take the rank."""
        cfg = index.config
        F = cfg.fanout
        sent = sentinel_for(index.keys.dtype)

        # top level: at most F entries -> one compare against the whole level
        top = index.levels[-1] if cfg.num_levels else index.keys
        rank = (top[None, :] <= q[:, None]).sum(1, dtype=torch.int32) - 1
        pos = rank.clamp_min(0)
        underflow = rank < 0

        lanes = torch.arange(F, dtype=torch.int32, device=q.device)
        for lvl in range(cfg.num_levels - 1, -1, -1):
            arr = index.levels[lvl - 1] if lvl >= 1 else index.keys
            child = pos[:, None].long() * F + lanes[None, :]
            ck = gather_fill(arr, child, sent)
            r = (ck <= q[:, None]).sum(1, dtype=torch.int32) - 1
            pos = pos * F + r.clamp_min(0)
        return pos, underflow

    def _probe_torch(self, index, q: torch.Tensor) -> Probe:
        pos, underflow = self._descend_torch(index, q)
        pos = torch.where(underflow, -1, pos)
        C = index.keys.shape[0]
        main_match = (pos >= 0) & (index.keys[pos.clamp(0, C - 1).long()] == q)
        PC = index.pkeys.shape[0]
        ppos = torch.searchsorted(index.pkeys, q, out_int32=True)
        ppos_c = ppos.clamp_max(PC - 1)
        p_hit = (index.pkeys[ppos_c.long()] == q) & (ppos < PC)
        return Probe(pos=pos, main_match=main_match, ppos=ppos_c, p_hit=p_hit)

    def _range_torch(self, index, lo, hi, max_span, rank, dense2slot,
                     plive):
        """The JAX ``xla`` range path, with the pending pass made two
        ``searchsorted`` over prefix tables instead of a (B, PC)
        broadcast."""
        C = index.keys.shape[0]
        sent = sentinel_for(index.keys.dtype)
        pos = self.floor(index, lo)
        r0 = torch.where(pos >= 0, rank[pos.clamp(0, C - 1).long()], 0)
        r = r0[:, None].long() + \
            torch.arange(max_span, device=lo.device)[None, :]
        slot = gather_fill(dense2slot, r, C)
        ks = gather_fill(index.keys, slot, sent)
        ts = gather_fill(index.tomb, slot, True)
        vs = gather_fill(index.vals, slot, 0)
        inr = (ks >= lo[:, None]) & (ks <= hi[:, None]) & ~ts & (ks != sent)
        cnt = inr.sum(1)
        sm = torch.where(inr, vs.long(), 0).sum(1)
        pcnt, psum = pending_prefix(index.pvals, plive)
        a = torch.searchsorted(index.pkeys, lo)
        b = torch.searchsorted(index.pkeys, hi, right=True)
        nonempty = lo <= hi
        cnt = cnt + torch.where(nonempty, pcnt[b] - pcnt[a], 0)
        sm = sm + torch.where(nonempty, psum[b].long() - psum[a].long(), 0)
        return cnt.to(torch.int32), wrap_i32(sm)

    # -- cuda backend ------------------------------------------------------

    def _probe_cuda(self, index, q: torch.Tensor) -> Probe:
        mpos, ppos, flags = pi_probe(
            index.keys, index.pkeys, q, fanout=index.config.fanout,
            tile_q=self.tile_q, levels=index.levels)
        PC = index.pkeys.shape[0]
        return Probe(
            pos=mpos,
            main_match=(flags & FLAG_MAIN_MATCH) > 0,
            ppos=ppos.clamp_max(PC - 1),
            p_hit=(flags & FLAG_PENDING_HIT) > 0,
        )


def range_tables(index):
    """The tables ``pi_range`` takes beside the index's own leaves:
    ``(live, rank, dense2slot, plive)``, all int32.

    ``rank[slot]`` is the occupied rank (occupied slots at or before it,
    minus one); ``dense2slot[r]`` the slot of the r-th occupied key, C past
    the end; tombstoned slots keep their key, hence are occupied.  Both
    depend on ``keys`` alone, which changes only at build and rebuild, so
    they come from ``KEY_TABLES``, built once per key array; ``live``
    (``tomb``) and ``plive`` (``pn``, ``ptomb``) are computed each call.
    ``rank`` and ``dense2slot`` are shared by every caller: read only.
    """
    occ, rank, dense2slot = KEY_TABLES.get(index.keys)
    live = (occ > index.tomb).to(torch.int32)   # occupied, not tombstoned
    pidx = torch.arange(index.pkeys.shape[0], device=index.device)
    plive = (pidx < index.pn) & ~index.ptomb
    return live, rank, dense2slot, plive.to(torch.int32)


def _build_key_tables(keys: torch.Tensor):
    """``(occ, rank, dense2slot)`` of one key array.  The scatter lands
    dropped rows on a spare row past the end, which is cut off (the JAX
    package's ``.at[].set(mode="drop")``)."""
    _TABLE_BUILDS.bump()
    C = keys.shape[0]
    dev = keys.device
    occ = keys != sentinel_for(keys.dtype)
    rank = torch.cumsum(occ, 0, dtype=torch.int32) - 1
    dense2slot = torch.full((C + 1,), C, dtype=torch.int32, device=dev)
    dense2slot[torch.where(occ, rank, C).long()] = torch.arange(
        C, dtype=torch.int32, device=dev)
    return occ, rank, dense2slot[:C]


# Bumped once per build of a key array's range tables, on either backend:
# once per miss of ``KEY_TABLES``.  Over a run that rebuilds nothing, one
# build serves every range-bearing window (``launch_guard("pipeline.
# ranges")``): the hit share is 1 - builds / range launches.
_TABLE_BUILDS = launch_guard("core.range_tables")


class KeyTables:
    """The keys-only range tables of each key array, held outside the
    index: built on the first ``get`` and returned again until the array
    changes.

    An entry belongs to one array: its storage (address, offset, length,
    stride, dtype, device) and the value of its version counter, which
    every in-place write to the array or to a view of its storage bumps;
    a ``get`` after such a write builds the tables anew.  A write that
    bypasses the counter (through ``.data``, a numpy alias or a raw
    pointer) is not seen.  An entry dies with its storage (a finalizer on
    it), so no later allocation at the same address can find it.  At most
    ``MAX_ENTRIES`` live, the least recently used dropped first; a single
    shard takes one, stacked shards one for each shard's view of the
    stacked keys (the views share one counter, so a write to any shard
    rebuilds them all).  No host sync.
    """

    MAX_ENTRIES = 32

    def __init__(self):
        # slot -> [version, tables, finalizer], least recently used first
        self._entries = collections.OrderedDict()
        self._lock = threading.Lock()

    def __len__(self) -> int:
        return len(self._entries)

    def get(self, keys: torch.Tensor):
        """``(occ, rank, dense2slot)`` of ``keys`` (bool, int32, int32)."""
        storage = keys.untyped_storage()
        slot = (storage.data_ptr(), keys.storage_offset(), keys.shape[0],
                keys.stride(0), keys.dtype, keys.device)
        version = keys._version
        with self._lock:
            entry = self._entries.get(slot)
            if entry is None:
                entry = self._entries[slot] = [None, None, weakref.finalize(
                    storage, self._entries.pop, slot, None)]
                while len(self._entries) > self.MAX_ENTRIES:
                    self._entries.popitem(last=False)[1][2].detach()
            self._entries.move_to_end(slot)
            if entry[0] != version:
                entry[0], entry[1] = version, _build_key_tables(keys)
            return entry[1]


KEY_TABLES = KeyTables()


@functools.lru_cache(maxsize=None)
def _make_engine(backend: str, tile_q: int) -> SearchEngine:
    return SearchEngine(backend=backend, tile_q=tile_q)


def get_engine(config) -> SearchEngine:
    """The (memoized) engine a ``PIConfig`` selects via ``config.backend``."""
    return _make_engine(config.backend, config.tile_q)
