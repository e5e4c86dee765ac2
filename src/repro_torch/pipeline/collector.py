"""Collection window: arrivals → the static sorted-batch shape the core runs.

This is the paper's first pipeline stage ("incoming queries are collected",
Alg. 1) made explicit: a fixed-capacity window admits arrivals one at a
time and seals into a sentinel-padded, statically-shaped batch when either
trigger fires:

* **size** — ``batch`` distinct query slots are occupied (full window);
* **deadline** — the window has been open for ``deadline`` time units
  (bounds the queueing delay of a query that arrives into a lull).

Two policies ride on top:

* **Coalescing** — a SEARCH on key *k* with no intervening write to *k*
  inside the window returns, by the batch semantics (Def. 3 / Alg. 4),
  exactly the result of the previous SEARCH on *k* — so it shares that
  query's slot instead of occupying a new one.  One window slot can then
  serve many arrivals, which is where skewed (zipf/hotkey) streams win
  big.  Writes are never coalesced (a DELETE's result and a write's
  last-writer position are arrival-order-dependent), and a write on *k*
  invalidates *k*'s coalescing point.

  RANGE ops carry a second key operand (``keys2`` = the inclusive upper
  bound) and coalesce on the *exact* ``(lo, hi)`` pair: every range in a
  window observes the same pre-window index state (the dispatcher runs
  the fused range execute before the window's point ops, DESIGN.md §9),
  so equal ranges share one result slot and window writes never
  invalidate a range's coalescing point.  A range merely *subsumed* by a
  queued range (``lo' <= lo, hi <= hi'``) still gets its own slot — its
  aggregate differs — but is detectable via ``range_covered`` and is the
  overload ladder's cheapest-to-shed class after exact duplicates.
* **Backpressure** — ``offer`` returns ``False`` instead of admitting when
  the window is sealed (full, or past its deadline).  The caller must
  ``take()`` the sealed window and re-offer.  Nothing is ever dropped
  silently: refusing admission here is what keeps the core's pending
  buffer (whose overflow *is* data loss) out of reach of open-loop floods.

The collector is deliberately host-side, dtype-faithful numpy: it is the
boundary where ragged reality becomes the fixed shapes of the core's
batch.  It is a copy of ``repro.pipeline.collector`` (the port imports
nothing of the JAX package): the same arrivals give the same windows,
array for array.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional

import numpy as np

from repro_torch import tracing
from repro_torch.core.batch import RANGE, SEARCH
from repro_torch.kernels.pi_search import sentinel_for

TRIGGER_SIZE = "size"
TRIGGER_DEADLINE = "deadline"
TRIGGER_FLUSH = "flush"


@dataclasses.dataclass(frozen=True)
class WindowConfig:
    """Policy surface of the collection window."""

    batch: int = 8192            # static batch shape (query slots per window)
    deadline: float = math.inf   # max window age before a partial seal
    coalesce: bool = True        # share slots between equivalent SEARCHes
    key_dtype: str = "int32"


@dataclasses.dataclass
class Window:
    """A sealed, sentinel-padded batch plus the arrival→slot map.

    ``ops/keys/vals`` are exactly the arrays ``core.execute`` takes; pad
    slots are SEARCHes on the sentinel key (legal by the engine contract,
    results discarded).  Arrival ``qids[i]`` reads its result from batch
    position ``slots[i]`` — several arrivals may share a slot (coalescing).
    """

    ops: np.ndarray        # (batch,) int32
    keys: np.ndarray       # (batch,) key dtype
    vals: np.ndarray       # (batch,) int32
    occupancy: int         # real query slots in use (<= batch)
    qids: List[int]        # admitted arrivals, in admission order
    slots: np.ndarray      # (n_arrivals,) int32 result slot per arrival
    t_open: float          # admission time of the first arrival
    t_enq: np.ndarray      # (n_arrivals,) float64 admission time per arrival
    trigger: str           # size | deadline | flush | recovered
    seq: Optional[int] = None  # WAL sequence number (stamped at append)
    keys2: Optional[np.ndarray] = None  # (batch,) RANGE upper bounds
    #   second key operand lane: keys2[s] is the inclusive upper bound of
    #   the RANGE at slot s (keys[s] is the lower), 0 at every non-RANGE
    #   slot for deterministic WAL bytes.  None == a window with no range
    #   lane (pre-range producers; treated as all-zeros).

    @property
    def n_arrivals(self) -> int:
        return len(self.qids)


class Collector:
    """Fixed-capacity admission window with size/deadline seal triggers.

    ``on_seal`` is the durability seam: called with every ``Window`` the
    instant it seals — before the caller can dispatch it — so the
    write-ahead log hooked here (``pipeline/wal.py``, through
    ``pipeline.recovery.Durability.on_seal``) has the window on disk
    before its effects can be exposed.  The hook sees windows in
    seal order regardless of the admission path (scalar ``offer``, bulk
    ``offer_many``, or an explicit ``take``).
    """

    def __init__(self, cfg: WindowConfig, on_seal=None):
        if cfg.batch < 1:
            raise ValueError("window batch must be >= 1")
        self.cfg = cfg
        self.on_seal = on_seal
        self._sent = int(sentinel_for(np.dtype(cfg.key_dtype)))
        # bound locals: offer() runs once per arrival and is the pipeline's
        # host-side unit cost — keep its fast path free of attribute and
        # dataclass-field chasing
        self._batch = cfg.batch
        self._deadline = cfg.deadline
        self._coalesce = cfg.coalesce
        self._kdt = np.dtype(cfg.key_dtype)
        self._reset()

    def _reset(self):
        # slot-side state: the window's query slots live in preallocated
        # buffers of the static shape — scalar offers write one element,
        # bulk admission writes slices, and sealing hands the buffers to
        # the Window outright (pad-fill only, no copy, no list boxing)
        B = self._batch
        self._buf_ops = np.empty(B, np.int32)
        self._buf_keys = np.empty(B, self._kdt)
        self._buf_keys2 = np.zeros(B, self._kdt)  # 0 at non-RANGE slots
        self._buf_vals = np.empty(B, np.int32)
        self._n = 0               # occupied slots
        # arrival-side state: (qid, slot, t_enq) per admitted arrival, as
        # segments — scalar offers append to tail lists, bulk admission
        # appends whole arrays; sealing concatenates once
        self._n_arr = 0
        self._seg_qids: List = []
        self._seg_slots: List[np.ndarray] = []
        self._seg_tenq: List[np.ndarray] = []
        self._tail_qids: List[int] = []
        self._tail_slots: List[int] = []
        self._tail_tenq: List[float] = []
        self._t_open: Optional[float] = None
        # key -> slot of the latest SEARCH with no write since (coalescing
        # point); a write to the key deletes its entry
        self._search_slot: Dict[int, int] = {}
        # (lo, hi) -> slot of the window's first RANGE on that exact pair.
        # Never write-invalidated: every range in a window observes the
        # pre-window state (ranges execute before the window's point ops)
        self._range_slot: Dict[tuple, int] = {}
        # bulk admission keeps its coalescing carry as sorted arrays (slot
        # -1 = write-cleared) shadowing the dict; scalar offers materialize
        # them first — per-key dict churn is exactly the host cost
        # offer_many exists to avoid
        self._lazy_keys: Optional[np.ndarray] = None
        self._lazy_slots: Optional[np.ndarray] = None

    # -- policy retuning ---------------------------------------------------

    @property
    def deadline(self) -> float:
        """The deadline currently in force (may differ from ``cfg.deadline``
        once a controller has retuned it)."""
        return self._deadline

    def set_deadline(self, deadline: float):
        """Retune the seal deadline online (the adaptive-deadline seam).

        Takes effect from the *next* expiry check — the currently-open
        window is judged against the new value too, which is what an
        overload controller wants (shrinking the deadline must be able to
        seal an already-old window).  ``batch`` is deliberately not
        retunable: it is the static compiled shape.
        """
        if not deadline > 0.0:
            raise ValueError(f"deadline must be > 0, got {deadline}")
        self._deadline = float(deadline)

    def coalesce_hits(self, keys) -> np.ndarray:
        """Which of ``keys`` hold a coalescing point in the open window.

        A SEARCH on such a key would share an already-occupied slot — its
        result duplicates a query the window already carries, which makes
        it the cheapest possible arrival to shed under overload (the
        client is rereading an answer the system is about to produce
        anyway).  Vectorized; read-only (admission state untouched).
        """
        keys = np.asarray(keys)
        if not self._coalesce or (not self._search_slot
                                  and self._lazy_keys is None):
            return np.zeros(keys.shape, bool)
        uk = np.unique(keys)
        hit_uk = self._prior_slots(uk) >= 0
        return hit_uk[np.searchsorted(uk, keys)]

    def range_covered(self, los, his) -> np.ndarray:
        """Which of the ranges ``[los[i], his[i]]`` are contained in a
        range the open window already queues (including exact duplicates).

        A covered range's keys are a subset of keys the window will scan
        anyway, which makes it the cheapest *range* arrival to shed under
        overload — the range analogue of ``coalesce_hits``.  Vectorized
        via a prefix-max of queued upper bounds over queued lower bounds;
        read-only (admission state untouched).
        """
        los = np.asarray(los)
        his = np.asarray(his)
        if not self._coalesce or not self._range_slot:
            return np.zeros(los.shape, bool)
        pairs = sorted(self._range_slot.keys())
        ql = np.array([p[0] for p in pairs], np.int64)
        hmax = np.maximum.accumulate(
            np.array([p[1] for p in pairs], np.int64))
        idx = np.searchsorted(ql, los, side="right") - 1
        return (idx >= 0) & (np.take(hmax, np.maximum(idx, 0))
                             >= his.astype(np.int64))

    # -- admission ---------------------------------------------------------

    def _expired(self, now: float) -> bool:
        return (self._t_open is not None
                and now - self._t_open >= self._deadline)

    def ready(self, now: Optional[float] = None) -> bool:
        """A sealed window is waiting (size hit, or deadline passed)."""
        if self._n >= self._batch:
            return True
        return now is not None and self._n_arr > 0 and self._expired(now)

    def offer(self, t: float, op: int, key: int, val: int, qid: int,
              key2: int = 0) -> bool:
        """Admit one arrival; ``False`` = backpressure (take() first).

        A RANGE op reads ``key`` as the inclusive lower bound and ``key2``
        as the inclusive upper bound (``key2`` is ignored for point ops).
        Refusal is the *only* overload behaviour — the collector never
        drops and never grows past the static shape.  Validation precedes
        every state change: a raising ``offer`` leaves the collector
        exactly as it found it (no stale ``_t_open`` from a rejected
        arrival that could later fake a deadline expiry).
        """
        if key == self._sent:
            raise ValueError("sentinel key is reserved for padding")
        if op == RANGE:
            if key2 == self._sent:
                raise ValueError("sentinel key is reserved for padding")
            if key > key2:
                raise ValueError(
                    f"RANGE lower bound must be <= upper bound, "
                    f"got [{key}, {key2}]")
        if self._lazy_keys is not None:
            self._sync_search_slot()
        slot = self._n
        if slot >= self._batch:
            return False
        t_open = self._t_open
        if t_open is None:
            self._t_open = t
        elif slot and t - t_open >= self._deadline:
            return False
        if op == SEARCH:
            if self._coalesce:
                shared = self._search_slot.get(key)
                if shared is not None:
                    slot = shared
                else:
                    self._search_slot[key] = slot
                    self._put(slot, op, key, val)
            else:
                self._put(slot, op, key, val)
        elif op == RANGE:
            # exact-pair coalescing; a window write never invalidates it
            # (all ranges observe the pre-window state) and a RANGE never
            # ends a SEARCH's coalescing run (it writes nothing)
            if self._coalesce:
                shared = self._range_slot.get((key, key2))
                if shared is not None:
                    slot = shared
                else:
                    self._range_slot[(key, key2)] = slot
                    self._put(slot, op, key, val, key2)
            else:
                self._put(slot, op, key, val, key2)
        else:
            # a write ends the coalescing run for this key: later SEARCHes
            # see the write's effect, not the pre-write result
            self._search_slot.pop(key, None)
            self._put(slot, op, key, val)
        self._tail_qids.append(qid)
        self._tail_slots.append(slot)
        self._tail_tenq.append(t)
        self._n_arr += 1
        return True

    def _put(self, slot: int, op: int, key: int, val: int, key2: int = 0):
        self._buf_ops[slot] = op
        self._buf_keys[slot] = key
        self._buf_keys2[slot] = key2
        self._buf_vals[slot] = val
        self._n = slot + 1

    # -- bulk admission ----------------------------------------------------

    def offer_many(self, t, ops, keys, vals, qids, keys2=None):
        """Admit a contiguous run of arrivals; ``(n_admitted, sealed)``.

        Vectorized equivalent of the scalar loop

            for i in range(n):
                while not offer(t[i], ops[i], keys[i], vals[i], qids[i],
                                keys2[i]):
                    sealed.append(take(t[i]))

        guaranteed to produce *bit-identical* windows: the same
        ops/keys/keys2/vals/occupancy/qids/slots/t_enq/trigger per sealed
        window and the same residual open window afterwards.  Windows that
        fill (size) or expire (deadline) mid-run are sealed internally and
        returned in seal order; the trailing partial window stays open —
        later ``offer``/``offer_many`` calls continue it and ``take()``
        flushes it.  The host cost is one numpy pass per sealed window
        instead of ~1–2 µs of Python per arrival, which is what lifts the
        pipeline's admission ceiling (ROADMAP: "Vectorized admission").

        ``keys2`` carries the RANGE upper bounds (ignored at point ops;
        ``None`` == a run with no ranges).

        Error contract — *stronger* than the scalar path: the whole run is
        validated before any state changes, so a raising ``offer_many``
        (sentinel key anywhere in the run, an inverted or sentinel range
        bound, non-monotone times, ragged arrays) leaves the collector
        untouched; no prefix is admitted.

        Times must be nondecreasing (arrival order); all arrays are 1-D
        of one shared length.
        """
        with tracing.span(tracing.ADMIT):
            return self._offer_many(t, ops, keys, vals, qids, keys2)

    def _offer_many(self, t, ops, keys, vals, qids, keys2):
        t = np.ascontiguousarray(t, np.float64)
        ops = np.ascontiguousarray(ops, np.int32)
        keys = np.ascontiguousarray(keys, np.dtype(self.cfg.key_dtype))
        vals = np.ascontiguousarray(vals, np.int32)
        qids = np.asarray(qids)
        if keys2 is None:
            keys2 = np.zeros(keys.shape, keys.dtype)
        else:
            keys2 = np.ascontiguousarray(keys2,
                                         np.dtype(self.cfg.key_dtype))
        if t.ndim != 1 or not (ops.shape == keys.shape == vals.shape
                               == qids.shape == t.shape == keys2.shape):
            raise ValueError("offer_many arrays must share one 1-D shape")
        n = t.shape[0]
        if n == 0:
            return 0, []
        # validate the entire run BEFORE mutating anything (atomic failure)
        if np.any(keys == self._sent):
            raise ValueError("sentinel key is reserved for padding")
        is_r = ops == RANGE
        if np.any(is_r):
            if np.any(is_r & (keys2 == self._sent)):
                raise ValueError("sentinel key is reserved for padding")
            if np.any(is_r & (keys > keys2)):
                raise ValueError("RANGE lower bound must be <= upper bound")
        # non-RANGE slots carry keys2 == 0 (deterministic WAL bytes)
        keys2 = np.where(is_r, keys2, 0).astype(keys.dtype)
        if np.any(np.diff(t) < 0.0):
            raise ValueError("offer_many arrival times must be nondecreasing")
        sealed: List[Window] = []
        start = 0
        while start < n:
            start = self._admit_chunk(t, ops, keys, keys2, vals, qids,
                                      start, sealed)
        return n, sealed

    def _admit_chunk(self, t, ops, keys, keys2, vals, qids, start: int,
                     sealed: List[Window]) -> int:
        """Admit arrivals from ``start`` up to the next seal boundary.

        Appends any sealed window and returns the new start index.  One
        call performs at most one seal, so coalescing state resets land
        exactly where the scalar loop puts them.
        """
        cur = self._n
        # entry refusals: window already full, or already expired at the
        # chunk's first arrival — seal exactly as the scalar loop's
        # ``take(t[start])`` would, and let the next iteration reopen
        if cur >= self._batch:
            sealed.append(self._take(float(t[start])))
            return start
        if self._t_open is None:
            t_open = float(t[start])
            lo = start + 1            # the opening arrival never expires
        else:
            t_open = self._t_open
            lo = start
            if cur and float(t[start]) - t_open >= self._deadline:
                sealed.append(self._take(float(t[start])))
                return start
        n = t.shape[0]
        # cap the candidate segment: a window admits at most batch-cur new
        # slots, so ~2x that keeps total re-scanned work O(n) even when
        # every arrival coalesces into an already-open slot
        cap_end = min(n, start + max(1024, 2 * (self._batch - cur)))
        # deadline boundary: the first arrival with t - t_open >= deadline
        # is refused.  The predicate must be the scalar offer's, bit for
        # bit — t >= t_open + deadline is NOT the same test in floats —
        # and fl(t - t_open) is nondecreasing (monotone rounding), so
        # searchsorted on the differences finds the exact boundary.
        dl_refusal = None
        if self._deadline != math.inf and lo < cap_end:
            off = int(np.searchsorted(t[lo:cap_end] - t_open,
                                      self._deadline, side="left"))
            if off < cap_end - lo:
                dl_refusal = lo + off
        end = cap_end if dl_refusal is None else dl_refusal
        m = end - start
        o = ops[start:end]
        k = keys[start:end]
        k2 = keys2[start:end]
        v = vals[start:end]
        is_r = o == RANGE
        is_w = (o != SEARCH) & ~is_r
        if self._coalesce:
            with tracing.span(tracing.ADMIT_COALESCE):
                newslot, slots, ckeys, cslots, rpairs, rslots = \
                    self._coalesce_chunk(k, k2, is_w, is_r, cur)
        else:
            newslot = np.ones(m, bool)
            slots = cur + np.arange(m, dtype=np.int64)
        excl = np.cumsum(newslot) - newslot  # new slots before each arrival
        b_size = int(np.searchsorted(excl, self._batch - cur, side="left"))
        if b_size < m:
            # arrival start+b_size finds the window full → size seal
            a, trigger = b_size, TRIGGER_SIZE
        elif dl_refusal is not None:
            # arrival at ``end`` is past the deadline; take() checks size
            # first, so a window that also just filled reads as size
            occ = cur + int(excl[m - 1]) + int(newslot[m - 1])
            a = m
            trigger = TRIGGER_SIZE if occ >= self._batch else TRIGGER_DEADLINE
        else:
            # no refusal inside the segment: admit all of it and keep the
            # window open (even if exactly full — sealing waits for the
            # next refused arrival, as in the scalar path)
            self._admit_slice(t, o, k, k2, v, qids, start, m, newslot,
                              slots, cur, t_open)
            if self._coalesce:
                self._merge_carry(ckeys, cslots)
                self._merge_range_carry(rpairs, rslots)
            return end
        self._admit_slice(t, o, k, k2, v, qids, start, a, newslot, slots,
                          cur, t_open)
        sealed.append(self._seal(trigger))
        return start + a

    def _admit_slice(self, t, o, k, k2, v, qids, start: int, a: int,
                     newslot, slots, cur: int, t_open: float):
        """Commit the chunk's first ``a`` arrivals into the open window."""
        sel = newslot[:a]
        occ = cur + int(np.count_nonzero(sel))
        self._buf_ops[cur:occ] = o[:a][sel]
        self._buf_keys[cur:occ] = k[:a][sel]
        self._buf_keys2[cur:occ] = k2[:a][sel]
        self._buf_vals[cur:occ] = v[:a][sel]
        self._n = occ
        self._flush_tail()
        # copies, not views: the caller owns the input arrays and may reuse
        # them before this window seals
        self._seg_qids.append(np.array(qids[start:start + a]))
        self._seg_slots.append(slots[:a].astype(np.int32))
        self._seg_tenq.append(np.array(t[start:start + a]))
        self._n_arr += a
        self._t_open = t_open

    def _coalesce_chunk(self, k: np.ndarray, k2: np.ndarray,
                        is_w: np.ndarray, is_r: np.ndarray, cur: int):
        """Vectorized slot assignment for one candidate segment.

        A SEARCH's coalescing group is ``(key, #writes to that key earlier
        in the segment)``: every member of a group shares one slot — the
        slot of the group's first member, or the open window's existing
        coalescing point when the group has seen no segment write and the
        window already holds one.  Writes always take fresh slots (their
        results are arrival-order-dependent).  A RANGE's group is its
        exact ``(lo, hi)`` pair — epochless, since window writes never
        invalidate a range (pre-window semantics).

        One stable sort by key puts each point key's arrivals in arrival
        order; a write ends its (key, epoch) run, so runs start at a key
        change or right after a write, and a run holding searches always
        starts with one.  Fresh slots are numbered in ARRIVAL order
        *across* the point and range classes, so the windows stay
        bit-identical to the scalar offer loop.  Returns ``(newslot,
        slots, carry_keys, carry_slots, range_pairs, range_slots)`` where
        the carry pair is each point key's post-segment coalescing point
        (slot, or -1 when a trailing write cleared it), sorted by key,
        and the range lists map each distinct segment ``(lo, hi)`` to its
        slot.
        """
        m = k.shape[0]
        pure_points = not is_r.any()
        if pure_points:
            pidx = None
            kp, wsp = k, is_w
        else:
            pidx = np.nonzero(~is_r)[0]
            kp, wsp = k[pidx], is_w[pidx]
        mp = kp.shape[0]
        # --- point class ---------------------------------------------------
        order = np.argsort(kp, kind="stable")
        ks = kp[order]
        ws = wsp[order]
        newkey = np.ones(mp, bool)
        newkey[1:] = ks[1:] != ks[:-1]
        gstart = newkey.copy()
        gstart[1:] |= ws[:-1]
        first_pos = np.nonzero(newkey)[0]
        ukeys = ks[first_pos]               # sorted distinct segment keys
        # epoch-0 runs may continue a coalescing point the open window
        # already holds (earlier offers, or a previous chunk of this run)
        prior_at = np.full(mp, -1, np.int64)
        prior_at[first_pos] = self._prior_slots(ukeys)
        # fresh slots go to writes and to run-leading searches without a
        # prior point
        newslot_p = np.empty(mp, bool)
        newslot_p[order] = ws | (gstart & ~ws & (prior_at < 0))
        newslot = np.empty(m, bool)
        if pure_points:
            newslot[:] = newslot_p
        else:
            # --- range class: group by the exact (lo, hi) pair -------------
            ridx = np.nonzero(is_r)[0]
            rlo, rhi = k[ridx], k2[ridx]
            mr = ridx.shape[0]
            ror = np.lexsort((np.arange(mr), rhi, rlo))
            rls, rhs = rlo[ror], rhi[ror]
            newgrp = np.ones(mr, bool)
            newgrp[1:] = (rls[1:] != rls[:-1]) | (rhs[1:] != rhs[:-1])
            gpos = np.nonzero(newgrp)[0]
            prior_r = np.fromiter(
                (self._range_slot.get((int(rls[p]), int(rhs[p])), -1)
                 for p in gpos), np.int64, gpos.shape[0])
            nr_sorted = np.zeros(mr, bool)
            nr_sorted[gpos] = prior_r < 0
            newslot_r = np.empty(mr, bool)
            newslot_r[ror] = nr_sorted
            newslot[pidx] = newslot_p
            newslot[ridx] = newslot_r
        # --- global fresh numbering, arrival order across classes ----------
        fresh = cur + np.cumsum(newslot) - newslot
        fresh_sorted = (fresh if pure_points else fresh[pidx])[order]
        # searches inherit their run start's slot (prior or leader's
        # fresh); writes keep their own — a write is always its run's tail
        run_start = np.nonzero(gstart)[0]
        start_slot = np.where(prior_at[run_start] >= 0,
                              prior_at[run_start], fresh_sorted[run_start])
        run_id = np.cumsum(gstart) - 1
        slot_sorted = np.where(ws, fresh_sorted, start_slot[run_id])
        slots = np.empty(m, np.int64)
        if pure_points:
            slots[order] = slot_sorted
        else:
            slots_p = np.empty(mp, np.int64)
            slots_p[order] = slot_sorted
            slots[pidx] = slots_p
            # ranges inherit their group's slot: the open window's prior
            # point for the pair, or the group leader's fresh slot
            fresh_r_sorted = fresh[ridx][ror]
            grp_slot = np.where(prior_r >= 0, prior_r,
                                fresh_r_sorted[gpos])
            grp_id = np.cumsum(newgrp) - 1
            slots_r = np.empty(mr, np.int64)
            slots_r[ror] = grp_slot[grp_id]
            slots[ridx] = slots_r
        # per-key carry: the key's last segment op decides — a trailing
        # SEARCH leaves its slot as the coalescing point, a write clears
        last_pos = np.empty(mp, bool)
        last_pos[:-1] = newkey[1:]
        if mp:
            last_pos[-1] = True
        lp = np.nonzero(last_pos)[0]
        carry = np.where(ws[lp], -1, slot_sorted[lp])
        if pure_points:
            rpairs, rslots = (), ()
        else:
            rpairs = [(int(rls[p]), int(rhs[p])) for p in gpos]
            rslots = grp_slot.tolist()
        return newslot, slots, ukeys, carry, rpairs, rslots

    # -- coalescing carry (bulk <-> scalar interop) ------------------------

    def _prior_slots(self, ukeys: np.ndarray) -> np.ndarray:
        """Coalescing point per (sorted) key: lazy arrays shadow the dict,
        -1 = none.  Vectorized so bulk admission never walks the dict
        unless scalar offers actually populated it."""
        if self._search_slot:
            prior = np.fromiter(
                (self._search_slot.get(int(kk), -1) for kk in ukeys),
                np.int64, ukeys.shape[0])
        else:
            prior = np.full(ukeys.shape[0], -1, np.int64)
        lk = self._lazy_keys
        if lk is not None and lk.size:
            pos = np.searchsorted(lk, ukeys)
            pos_c = np.minimum(pos, lk.size - 1)
            hit = lk[pos_c] == ukeys
            prior[hit] = self._lazy_slots[pos_c[hit]]
        return prior

    def _merge_carry(self, ckeys: np.ndarray, cslots: np.ndarray):
        """Fold a segment's per-key carry into the lazy arrays (last wins)."""
        lk = self._lazy_keys
        if lk is None or lk.size == 0:
            self._lazy_keys, self._lazy_slots = ckeys, cslots
            return
        kcat = np.concatenate([lk, ckeys])
        scat = np.concatenate([self._lazy_slots, cslots])
        order = np.argsort(kcat, kind="stable")  # newer entries sort later
        ks = kcat[order]
        last = np.empty(ks.shape[0], bool)
        last[:-1] = ks[1:] != ks[:-1]
        last[-1] = True
        self._lazy_keys = ks[last]
        self._lazy_slots = scat[order][last]

    def _merge_range_carry(self, rpairs, rslots):
        """Fold a segment's distinct (lo, hi) → slot map into the window's
        range coalescing points (idempotent for pairs already present —
        the segment resolved those to the same slot)."""
        if rpairs:
            self._range_slot.update(zip(rpairs, rslots))

    def _sync_search_slot(self):
        """Materialize the lazy carry into the dict before a scalar offer."""
        d = self._search_slot
        for kk, ss in zip(self._lazy_keys.tolist(),
                          self._lazy_slots.tolist()):
            if ss < 0:
                d.pop(kk, None)
            else:
                d[kk] = ss
        self._lazy_keys = self._lazy_slots = None

    # -- sealing -----------------------------------------------------------

    @property
    def pending(self) -> int:
        """Arrivals admitted into the currently-open window."""
        return self._n_arr

    def take(self, now: Optional[float] = None) -> Optional[Window]:
        """Seal and return the open window (None when empty).

        ``trigger`` records why the window closed — size, deadline, or an
        explicit flush — so metrics can attribute short batches.
        """
        with tracing.span(tracing.ADMIT):
            return self._take(now)

    def _take(self, now: Optional[float]) -> Optional[Window]:
        if not self._n_arr:
            return None
        if self._n >= self._batch:
            trigger = TRIGGER_SIZE
        elif now is not None and self._expired(now):
            trigger = TRIGGER_DEADLINE
        else:
            trigger = TRIGGER_FLUSH
        return self._seal(trigger)

    def _flush_tail(self):
        """Close the scalar tail lists into arrival segments."""
        if self._tail_qids:
            self._seg_qids.append(self._tail_qids)
            self._seg_slots.append(np.asarray(self._tail_slots, np.int32))
            self._seg_tenq.append(np.asarray(self._tail_tenq, np.float64))
            self._tail_qids = []
            self._tail_slots = []
            self._tail_tenq = []

    def _seal(self, trigger: str) -> Window:
        """Pad the slot buffers, concatenate arrival segments, hand off."""
        with tracing.span(tracing.ADMIT_SEAL):
            n = self._n
            ops, keys, vals = self._buf_ops, self._buf_keys, self._buf_vals
            keys2 = self._buf_keys2
            ops[n:] = SEARCH
            keys[n:] = self._sent
            keys2[n:] = 0
            vals[n:] = 0
            self._flush_tail()
            qids: List[int] = []
            for seg in self._seg_qids:
                qids.extend(seg.tolist() if isinstance(seg, np.ndarray)
                            else seg)
            win = Window(ops=ops, keys=keys, vals=vals, occupancy=n,
                         qids=qids,
                         slots=np.concatenate(self._seg_slots),
                         t_open=float(self._t_open),
                         t_enq=np.concatenate(self._seg_tenq),
                         trigger=trigger, keys2=keys2)
        self._reset()
        if self.on_seal is not None:
            self.on_seal(win)
        return win
