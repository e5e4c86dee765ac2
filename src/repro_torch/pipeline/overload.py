"""Overload control: shed, retune, recover — instead of refuse and poison.

Counterpart of ``repro.pipeline.overload``, host-side numpy code: the same
config, arrivals and seed give the same shed plans, the same retry
delays (drawn from the same numpy generator in the same order) and so the
same ``RunReport``, field for field.  Three cooperating mechanisms behind
one ``OverloadConfig``:

* **Adaptive admission control** (``AdmissionController``): a pressure
  signal derived from the pending-buffer fill high-water of retired
  windows drives a shed ladder ordered by information loss — subsumed
  RANGEs first (a queued range already scans their keys), then duplicate
  SEARCHes (their result is already being computed for another arrival),
  then all RANGEs (each costs a span walk, not one probe), then all
  SEARCHes, and writes only at the top of the ladder.  Shedding happens
  strictly at admission time, *before* the window seals, so an op whose
  window already sealed to the WAL is never shed.  Shed arrivals get a
  retry-after hint; ``workload.RetryPolicy`` turns it into bounded
  exponential backoff with jitter.

* **Adaptive deadline controller** (``DeadlineController``): watches the
  retired-window telemetry (occupancy fill, seal-trigger mix, p99) and
  retunes the collector's *deadline* online within
  ``[deadline_min, deadline_max]``, with a consecutive-interval
  hysteresis so trigger noise cannot make it flap.  ``batch`` is never
  touched: it is the window's fixed shape.

* **Circuit-breaker policy** (the ``BREAKER_*`` state machine): the
  dispatcher consumes this config to replace permanent poisoning with
  quarantine → rollback → repack → replay (see
  ``dispatcher.Dispatcher._breaker_recover``), escalating
  ``closed → recovering → read_only → poisoned``.  This module holds the
  states and the read-only rejection type so the dispatcher can import
  them without a cycle.

``OverloadController`` is the facade the serving and test harnesses
drive: ``run()`` replays an arrival stream through a collector+dispatcher
pair with shedding, retries, and deadline retuning all engaged.
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
import math
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.batch import RANGE, SEARCH
from repro_torch.pipeline.collector import TRIGGER_DEADLINE
from repro_torch.pipeline.workload import RetryPolicy

# breaker state machine (DESIGN.md §8) — escalation is strictly left to
# right; only `poisoned` latches
BREAKER_CLOSED = "closed"
BREAKER_RECOVERING = "recovering"
BREAKER_READ_ONLY = "read_only"
BREAKER_POISONED = "poisoned"

# shed classes, cheapest information loss first
SHED_RANGE_SUB = "range_sub"     # RANGE subsumed by a queued RANGE
SHED_SEARCH_DUP = "search_dup"   # SEARCH duplicating a result already queued
SHED_RANGE = "range"             # any RANGE (a span of work, not one probe)
SHED_SEARCH = "search"           # any SEARCH
SHED_WRITE = "write"             # INSERT/DELETE — shed last, and in read-only


class ReadOnlyModeError(RuntimeError):
    """The breaker degraded to read-only mode: windows carrying writes are
    rejected (typed, non-poisoning — the window stays with the caller for
    resubmission after the breaker closes) while pure-SEARCH windows keep
    serving.  Raised *before* dispatch, so the rejected window never
    touches the index."""


@dataclasses.dataclass(frozen=True)
class OverloadConfig:
    """One policy surface for all three overload mechanisms.

    The shed thresholds are pressure levels in [0, 1] (pending-buffer fill
    high-water, EWMA-smoothed) and must be ordered
    ``shed_range_sub_at <= shed_dup_at <= shed_range_at <=
    shed_search_at <= shed_write_at`` — the ladder sheds cheaper classes
    first.  Subsumed ranges go cheapest of all (a queued range already
    scans their keys, so the marginal information kept by serving them is
    lowest per unit of span work); all ranges shed ahead of point
    SEARCHes because each range slot costs a ``max_span`` walk where a
    SEARCH costs one probe.  The two range rungs default to ``None`` =
    derived — ``min(0.4, shed_dup_at)`` and ``min(0.7, shed_search_at)``
    respectively — so a pre-range config that only tunes the point
    thresholds keeps a valid ladder (ranges clamp to their neighbours);
    explicit values are validated as given.  Breaker counters use the
    dispatcher's clock;
    ``recovery_interval`` is both the rolling window for counting
    recoveries and the quiet period after which read-only mode closes.
    """

    # -- adaptive admission (shedding) --
    shed: bool = True
    # None = derive from the neighbouring point thresholds (see docstring)
    shed_range_sub_at: "float | None" = None  # ≥ this → shed subsumed RANGEs
    shed_dup_at: float = 0.5       # pressure ≥ this → shed duplicate SEARCHes
    shed_range_at: "float | None" = None      # ≥ this → shed all RANGEs
    shed_search_at: float = 0.8    # pressure ≥ this → shed all SEARCHes
    shed_write_at: float = 0.95    # pressure ≥ this → shed writes too
    pressure_ewma: float = 0.3     # weight of the newest fill sample
    retry_after: float = 0.05      # base retry-after hint (stream time units)

    # -- adaptive deadline controller --
    adapt_deadline: bool = True
    deadline_min: float = 1e-4
    deadline_max: float = 1.0
    adjust_every: int = 8          # retired windows per control interval
    fill_low: float = 0.5          # mean occupancy/batch below this → grow
    deadline_step: float = 1.5     # multiplicative retune step
    hysteresis: int = 2            # consecutive agreeing intervals to act
    latency_slo: float = math.inf  # p99 target on the stream's time axis

    # -- circuit breaker --
    breaker: bool = True
    max_recoveries: int = 3        # recoveries tolerated per rolling interval
    recovery_interval: float = 60.0

    def __post_init__(self):
        if self.shed_range_sub_at is None:
            object.__setattr__(self, "shed_range_sub_at",
                               min(0.4, self.shed_dup_at))
        if self.shed_range_at is None:
            object.__setattr__(self, "shed_range_at",
                               min(0.7, self.shed_search_at))
        if not (0.0 <= self.shed_range_sub_at <= self.shed_dup_at
                <= self.shed_range_at <= self.shed_search_at
                <= self.shed_write_at):
            raise ValueError(
                f"shed thresholds must satisfy 0 <= range_sub <= dup <= "
                f"range <= search <= write, got {self.shed_range_sub_at}"
                f"/{self.shed_dup_at}/{self.shed_range_at}"
                f"/{self.shed_search_at}/{self.shed_write_at}")
        if not 0.0 < self.pressure_ewma <= 1.0:
            raise ValueError(
                f"pressure_ewma must be in (0, 1], got {self.pressure_ewma}")
        if not 0.0 < self.deadline_min <= self.deadline_max:
            raise ValueError(
                f"need 0 < deadline_min <= deadline_max, got "
                f"{self.deadline_min}/{self.deadline_max}")
        if self.deadline_step <= 1.0:
            raise ValueError(
                f"deadline_step must be > 1, got {self.deadline_step}")
        if self.adjust_every < 1 or self.hysteresis < 1:
            raise ValueError("adjust_every and hysteresis must be >= 1")
        if self.max_recoveries < 0 or self.recovery_interval <= 0.0:
            raise ValueError(
                f"need max_recoveries >= 0 and recovery_interval > 0, got "
                f"{self.max_recoveries}/{self.recovery_interval}")


class AdmissionController:
    """Pressure-driven load shedding at the admission boundary.

    Pressure is the pending-buffer fill high-water of retired windows
    (``WindowResult.pending_fill``): the instant sample catches a spike
    the same window it lands, the EWMA keeps pressure up across the
    rebuild sawtooth (each rebuild empties the pending buffer, so the
    instant signal alone would oscillate at the rebuild period).  The
    effective pressure is the max of the two.
    """

    def __init__(self, cfg: OverloadConfig, metrics=None):
        self.cfg = cfg
        self.metrics = metrics
        self._inst = 0.0
        self._ewma: Optional[float] = None

    @property
    def pressure(self) -> float:
        return max(self._inst, self._ewma or 0.0)

    @property
    def retry_after(self) -> float:
        """Hint handed to shed clients: base, stretched under pressure so
        retries of a sustained flood spread out instead of re-arriving as
        the same flood."""
        return self.cfg.retry_after * (1.0 + self.pressure)

    def observe(self, res):
        """Fold one retired window's pending fill into the pressure."""
        fill = getattr(res, "pending_fill", None)
        if fill is None or np.isnan(fill):
            return
        fill = float(fill)
        self._inst = fill
        a = self.cfg.pressure_ewma
        self._ewma = fill if self._ewma is None \
            else a * fill + (1.0 - a) * self._ewma

    def plan(self, ops: np.ndarray, dup: np.ndarray, *,
             covered: Optional[np.ndarray] = None,
             read_only: bool = False
             ) -> Tuple[np.ndarray, Dict[str, np.ndarray]]:
        """Shed plan for a run of candidate arrivals.

        Returns ``(keep, shed_masks)`` — ``keep`` is the admission mask,
        ``shed_masks`` maps shed class → mask (disjoint; union is
        ``~keep``).  ``dup`` flags SEARCHes whose result is already queued
        (open-window coalescing point, or an earlier SEARCH on the same
        key in this same run); ``covered`` flags RANGEs contained in a
        range already queued (``Collector.range_covered``) — both are
        *policy* signals: a dup/covered op may stop being one if the
        window seals mid-run, which costs an unnecessary shed, never a
        wrong result.  ``read_only`` sheds every write regardless of
        pressure (the breaker's degraded mode); RANGEs are reads and keep
        serving there.
        """
        ops = np.asarray(ops)
        is_search = ops == SEARCH
        is_range = ops == RANGE
        is_write = ~is_search & ~is_range
        if covered is None:
            covered = np.zeros(ops.shape, bool)
        shed_rsub = np.zeros(ops.shape, bool)
        shed_dup = np.zeros(ops.shape, bool)
        shed_range = np.zeros(ops.shape, bool)
        shed_search = np.zeros(ops.shape, bool)
        shed_write = np.zeros(ops.shape, bool)
        if self.cfg.shed:
            p = self.pressure
            if p >= self.cfg.shed_write_at:
                shed_write = is_write
            if p >= self.cfg.shed_search_at:
                shed_search = is_search
            elif p >= self.cfg.shed_dup_at:
                shed_dup = is_search & np.asarray(dup, bool)
            if p >= self.cfg.shed_range_at:
                shed_range = is_range
            elif p >= self.cfg.shed_range_sub_at:
                shed_rsub = is_range & np.asarray(covered, bool)
        if read_only:
            shed_write = is_write
        keep = ~(shed_rsub | shed_dup | shed_range | shed_search
                 | shed_write)
        masks = {SHED_RANGE_SUB: shed_rsub, SHED_SEARCH_DUP: shed_dup,
                 SHED_RANGE: shed_range, SHED_SEARCH: shed_search,
                 SHED_WRITE: shed_write}
        if self.metrics is not None:
            for cls, m in masks.items():
                self.metrics.on_shed(cls, int(np.count_nonzero(m)))
        return keep, masks


class DeadlineController:
    """Online deadline retuning from retired-window telemetry.

    Every ``adjust_every`` retired windows it evaluates one control
    interval:

    * p99 latency above ``latency_slo`` → want *shrink* (windows are held
      open too long; sealing earlier bounds queueing delay);
    * mean occupancy below ``fill_low`` **and** a majority of seals by
      deadline → want *grow* (the deadline is sealing windows the size
      trigger would have filled; longer windows amortize dispatch and
      feed coalescing).

    A direction must hold for ``hysteresis`` consecutive intervals before
    the deadline moves one multiplicative ``deadline_step``, clamped to
    ``[deadline_min, deadline_max]``.  An infinite starting deadline
    (the default ``WindowConfig``) can only shrink — the first shrink
    lands on ``deadline_max``.
    """

    def __init__(self, cfg: OverloadConfig, collector, metrics=None):
        self.cfg = cfg
        self._col = collector
        self.metrics = metrics
        # (retired-window index, deadline) — the BENCH trajectory
        self.trajectory: List[Tuple[int, float]] = [(0, collector.deadline)]
        self._n_total = 0
        self._streak = 0  # signed run length: >0 grow votes, <0 shrink votes
        self._reset_interval()
        if metrics is not None:
            metrics.deadline_current = collector.deadline

    def _reset_interval(self):
        self._n = 0
        self._occ = 0
        self._deadline_seals = 0
        self._lats: List[np.ndarray] = []

    def observe(self, res):
        """Fold one retired WindowResult; retune at interval boundaries."""
        self._n_total += 1
        self._n += 1
        w = res.window
        self._occ += w.occupancy
        self._deadline_seals += int(w.trigger == TRIGGER_DEADLINE)
        self._lats.append(res.latencies())
        if self._n >= self.cfg.adjust_every:
            self._evaluate()

    def _evaluate(self):
        cfg = self.cfg
        batch = self._col.cfg.batch
        fill = self._occ / (self._n * batch)
        frac_deadline = self._deadline_seals / self._n
        p99 = float(np.percentile(np.concatenate(self._lats), 99)) \
            if self._lats else 0.0
        self._reset_interval()
        if p99 > cfg.latency_slo:
            want = -1
        elif fill < cfg.fill_low and frac_deadline >= 0.5:
            want = +1
        else:
            want = 0
        self._streak = self._streak + want \
            if want and (self._streak * want >= 0) else want
        if not want or abs(self._streak) < cfg.hysteresis:
            return
        self._streak = 0
        cur = self._col.deadline
        if want > 0:
            if math.isinf(cur):
                return  # already unbounded; nothing to grow
            new = min(cur * cfg.deadline_step, cfg.deadline_max)
        else:
            new = cfg.deadline_max if math.isinf(cur) \
                else max(cur / cfg.deadline_step, cfg.deadline_min)
        if new == cur:
            return
        self._col.set_deadline(new)
        self.trajectory.append((self._n_total, new))
        if self.metrics is not None:
            self.metrics.deadline_current = new
            self.metrics.deadline_updates += 1


@dataclasses.dataclass
class RunReport:
    """What one overload-controlled replay did, for oracles and benches."""

    results: Dict[int, Tuple[bool, int]] = dataclasses.field(
        default_factory=dict)       # qid → (found, val), acked arrivals only
    range_results: Dict[int, Tuple[int, int]] = dataclasses.field(
        default_factory=dict)       # qid → (count, sum), acked RANGEs only
    admitted: List[int] = dataclasses.field(default_factory=list)
    # qids admitted+executed, in admission order — the oracle subsequence
    dropped: List[int] = dataclasses.field(default_factory=list)
    # qids shed for good (retries exhausted / no retry budget)
    retries: int = 0                # re-enqueues performed
    window_results: List = dataclasses.field(default_factory=list)

    @property
    def goodput(self) -> int:
        """Arrivals that produced an acknowledged result."""
        return len(self.results) + len(self.range_results)


class OverloadController:
    """Facade wiring shedding + retries + deadline retuning into a replay.

    ``run(dispatcher, collector, stream)`` is ``Dispatcher.run`` with the
    overload tier engaged: chunked bulk admission, a shed plan per chunk,
    a backoff heap re-offering shed arrivals (stamped at current time, so
    the collector's nondecreasing-times contract holds), and read-only
    windows bounced by the breaker rescheduled rather than lost.  Every
    admitted op is executed exactly once; ``RunReport.admitted`` is the
    exact subsequence an oracle must replay.
    """

    def __init__(self, cfg: Optional[OverloadConfig] = None, *,
                 metrics=None, retry: Optional[RetryPolicy] = None,
                 seed: int = 0):
        self.cfg = cfg if cfg is not None else OverloadConfig()
        self.metrics = metrics
        self.retry = retry if retry is not None else RetryPolicy()
        self.admission = AdmissionController(self.cfg, metrics=metrics)
        self.deadline_controller: Optional[DeadlineController] = None
        self._rng = np.random.default_rng(seed)

    def observe(self, res):
        self.admission.observe(res)
        if self.deadline_controller is not None:
            self.deadline_controller.observe(res)

    # -- the replay loop -----------------------------------------------------

    def run(self, dispatcher, collector, stream, *,
            chunk: Optional[int] = None, clock=None) -> RunReport:
        if self.cfg.adapt_deadline and self.deadline_controller is None:
            self.deadline_controller = DeadlineController(
                self.cfg, collector, metrics=self.metrics)
        rep = RunReport()
        step = chunk or collector.cfg.batch
        n = len(stream.t)
        attempts: Dict[int, int] = {}         # qid → retries consumed
        heap: List[Tuple[float, int, int]] = []  # (due, tiebreak, qid)
        tick = itertools.count()
        t_now = 0.0

        for s in range(0, n, step):
            e = min(n, s + step)
            if clock is not None:
                t_now = clock()
                t_chunk = np.full(e - s, t_now)
            else:
                t_now = float(stream.t[s])
                t_chunk = stream.t[s:e]
            self._drain_retries(dispatcher, collector, stream, heap,
                                attempts, tick, t_now, rep)
            k2 = getattr(stream, "keys2", None)
            self._admit(dispatcher, collector, t_chunk, stream.ops[s:e],
                        stream.keys[s:e],
                        k2[s:e] if k2 is not None else None,
                        stream.vals[s:e], np.arange(s, e), stream,
                        attempts, heap, tick, t_now, rep)
        # drain the backoff heap past the end of the stream: time advances
        # to each due point (never backwards — the max keeps the
        # collector's nondecreasing-times contract in both time modes).
        # The tail flush loops with the drain because submitting the tail
        # can itself refill the heap (a read-only bounce reschedules the
        # whole window) — a single drain-then-take would strand those
        # retries.  Bounded: every arrival has a finite retry budget.
        while True:
            if heap:
                t_now = max(clock(), heap[0][0]) if clock is not None \
                    else max(t_now, heap[0][0])
                self._drain_retries(dispatcher, collector, stream, heap,
                                    attempts, tick, t_now, rep)
                continue
            tail = collector.take(clock() if clock is not None else t_now)
            if tail is None:
                break
            self._submit(dispatcher, tail, stream, attempts, heap, tick,
                         t_now, rep)
        self._retired(dispatcher.flush(), rep)
        return rep

    # -- internals -----------------------------------------------------------

    def _drain_retries(self, disp, col, stream, heap, attempts, tick,
                       t_now: float, rep: RunReport):
        """Re-offer every due retry as one mini-chunk stamped at t_now."""
        qids = []
        while heap and heap[0][0] <= t_now:
            _, _, qid = heapq.heappop(heap)
            qids.append(qid)
        if not qids:
            return
        q = np.asarray(qids)
        k2 = getattr(stream, "keys2", None)
        self._admit(disp, col, np.full(q.shape, t_now), stream.ops[q],
                    stream.keys[q], k2[q] if k2 is not None else None,
                    stream.vals[q], q, stream, attempts, heap, tick,
                    t_now, rep)

    def _admit(self, disp, col, t_arr, ops, keys, keys2, vals, qids,
               stream, attempts, heap, tick, t_now: float, rep: RunReport):
        """Shed-plan one run of arrivals, offer the keepers, submit seals."""
        ops = np.asarray(ops)
        keys = np.asarray(keys)
        if keys2 is None:
            keys2 = np.zeros(ops.shape, keys.dtype)
        keys2 = np.asarray(keys2)
        is_search = ops == SEARCH
        dup = np.zeros(ops.shape, bool)
        if is_search.any():
            # duplicate = coalescing point already in the open window, or an
            # earlier SEARCH on the same key in this very run
            dup[is_search] = col.coalesce_hits(keys[is_search])
            sk = keys[is_search]
            _, first = np.unique(sk, return_index=True)
            later = np.ones(sk.shape, bool)
            later[first] = False
            dup[is_search] |= later
        is_range = ops == RANGE
        covered = np.zeros(ops.shape, bool)
        if is_range.any():
            # covered = contained in a range already queued in the open
            # window, or an exact repeat of an earlier range in this run
            # (same policy-signal caveats as dup)
            covered[is_range] = col.range_covered(keys[is_range],
                                                  keys2[is_range])
            rp = np.stack([keys[is_range], keys2[is_range]], axis=1)
            _, first = np.unique(rp, axis=0, return_index=True)
            later = np.ones(rp.shape[0], bool)
            later[np.sort(first)] = False
            covered[is_range] |= later
        read_only = getattr(disp, "breaker_state",
                            BREAKER_CLOSED) == BREAKER_READ_ONLY
        keep, masks = self.admission.plan(ops, dup, covered=covered,
                                          read_only=read_only)
        for m in masks.values():
            for qid in np.asarray(qids)[m]:
                self._backoff(int(qid), attempts, heap, tick, t_now, rep)
        if not keep.any():
            return
        _, sealed = col.offer_many(np.asarray(t_arr)[keep], ops[keep],
                                   keys[keep], np.asarray(vals)[keep],
                                   np.asarray(qids)[keep],
                                   keys2=keys2[keep])
        for w in sealed:
            self._submit(disp, w, stream, attempts, heap, tick, t_now, rep)

    def _submit(self, disp, window, stream, attempts, heap, tick,
                t_now: float, rep: RunReport):
        try:
            retired = disp.submit(window)
        except ReadOnlyModeError:
            # the breaker degraded between this window's admission and its
            # dispatch; nothing executed — reschedule every arrival
            for qid in window.qids:
                self._backoff(int(qid), attempts, heap, tick, t_now, rep)
            return
        rep.admitted.extend(window.qids)
        self._retired(retired, rep)

    def _retired(self, retired, rep: RunReport):
        for res in retired:
            self.observe(res)
            rep.window_results.append(res)
            rep.results.update(res.per_arrival())
            rep.range_results.update(res.per_arrival_ranges())

    def _backoff(self, qid: int, attempts, heap, tick, t_now: float,
                 rep: RunReport):
        """Schedule a shed arrival's retry, or drop it when exhausted."""
        a = attempts.get(qid, 0)
        if a >= self.retry.max_retries:
            rep.dropped.append(qid)
            if self.metrics is not None:
                self.metrics.retry_exhausted += 1
            return
        attempts[qid] = a + 1
        delay = self.retry.next_delay(a, self.admission.retry_after,
                                      self._rng)
        heapq.heappush(heap, (t_now + delay, next(tick), qid))
        rep.retries += 1
        if self.metrics is not None:
            self.metrics.retry_scheduled += 1
