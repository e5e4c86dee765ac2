"""Pipeline observability: latency histograms, occupancy, qps.

Per-query latency is enqueue→result: the time axis is whatever the caller
fed the collector (wall-clock in the benchmark and server, virtual time in
tests), and retirement stamps come from the dispatcher's clock on the same
axis.  Latencies land in a log-bucketed histogram — memory-bounded no
matter how long the pipeline runs, with percentile error bounded by the
bucket ratio (~7% with 48 buckets per 1e6 span), which is far below the
run-to-run noise of any wall-clock measurement on a shared host.

A copy of ``repro.pipeline.metrics``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

from repro_torch.core.batch import RANGE


class LatencyHistogram:
    """Log-bucketed latency histogram with percentile readout.

    Buckets span [lo, hi) geometrically; under/overflow clamp to the edge
    buckets.  ``percentile`` interpolates within the winning bucket.
    """

    def __init__(self, lo: float = 1e-6, hi: float = 1e2,
                 n_buckets: int = 96):
        self.lo = lo
        self.hi = hi
        self.edges = np.geomspace(lo, hi, n_buckets + 1)
        self.counts = np.zeros(n_buckets, np.int64)

    def record(self, latencies: np.ndarray):
        x = np.clip(np.asarray(latencies, np.float64), self.lo,
                    np.nextafter(self.hi, 0))
        idx = np.searchsorted(self.edges, x, side="right") - 1
        np.add.at(self.counts, np.clip(idx, 0, len(self.counts) - 1), 1)

    @property
    def count(self) -> int:
        return int(self.counts.sum())

    def percentile(self, q: float) -> float:
        """q in [0, 100] → latency estimate (geometric mid-interpolation)."""
        total = self.counts.sum()
        if total == 0:
            return float("nan")
        target = total * (q / 100.0)
        cum = np.cumsum(self.counts)
        i = int(np.searchsorted(cum, target, side="left"))
        i = min(i, len(self.counts) - 1)
        prev = cum[i - 1] if i > 0 else 0
        in_bucket = self.counts[i]
        frac = 0.5 if in_bucket == 0 else (target - prev) / in_bucket
        lo, hi = self.edges[i], self.edges[i + 1]
        return float(lo * (hi / lo) ** np.clip(frac, 0.0, 1.0))


@dataclasses.dataclass
class PipelineMetrics:
    """Rolling counters the dispatcher feeds at each window retirement."""

    hist: LatencyHistogram = dataclasses.field(
        default_factory=LatencyHistogram)
    n_windows: int = 0
    n_arrivals: int = 0
    n_slots: int = 0            # distinct executed queries (post-coalescing)
    n_rebuilds: int = 0
    n_rebuilds_incremental: int = 0  # rebuilds that took the segmented tier
    wal_appends: int = 0        # sealed windows written ahead to the WAL
    wal_fsyncs: int = 0         # fsyncs the policy actually issued
    recovery_replayed: int = 0  # WAL windows replayed by recover()
    occupancy_sum: int = 0
    triggers: Dict[str, int] = dataclasses.field(default_factory=dict)
    # overload tier (DESIGN.md §8) — fed by the admission/deadline
    # controllers and the dispatcher's circuit breaker
    shed_by_class: Dict[str, int] = dataclasses.field(default_factory=dict)
    retry_scheduled: int = 0    # shed arrivals re-enqueued with backoff
    retry_exhausted: int = 0    # shed arrivals that ran out of retries
    breaker_trips: int = 0      # pending overflows the breaker caught
    breaker_recoveries: int = 0  # trips recovered via rollback+repack+replay
    read_only_rejections: int = 0  # arrivals in windows refused read-only
    deadline_current: float = float("nan")  # deadline in force (controller)
    deadline_updates: int = 0   # times the controller retuned the deadline
    pending_fill_peak: float = 0.0  # high-water pending fill across windows
    # range serving tier (DESIGN.md §9) — derived from the retired window
    range_admitted: int = 0     # RANGE arrivals admitted (pre-coalescing)
    range_slots: int = 0        # distinct RANGE result slots executed
    range_coalesce_hits: int = 0  # RANGE arrivals that shared a queued slot
    range_span_hist: LatencyHistogram = dataclasses.field(
        default_factory=lambda: LatencyHistogram(1.0, 1e9, 96))
    #   inclusive span (hi - lo + 1, key units) per distinct RANGE slot
    t_start: Optional[float] = None
    t_stop: Optional[float] = None

    def on_shed(self, cls: str, n: int = 1):
        """Count ``n`` arrivals shed under class ``cls`` (admission-time)."""
        if n:
            self.shed_by_class[cls] = self.shed_by_class.get(cls, 0) + n

    def start(self, now: float):
        self.t_start = now

    def stop(self, now: float):
        self.t_stop = now

    def on_retire(self, res):
        """Fold one retired WindowResult into the counters."""
        w = res.window
        self.n_windows += 1
        self.n_arrivals += w.n_arrivals
        self.n_slots += w.occupancy
        self.occupancy_sum += w.occupancy
        self.n_rebuilds += int(res.rebuilt)
        self.n_rebuilds_incremental += int(
            getattr(res, "rebuilt_incremental", False))
        self.triggers[w.trigger] = self.triggers.get(w.trigger, 0) + 1
        fill = getattr(res, "pending_fill", None)
        if fill is not None and not np.isnan(fill):
            self.pending_fill_peak = max(self.pending_fill_peak, float(fill))
        keys2 = getattr(w, "keys2", None)
        if keys2 is not None:
            ops = np.asarray(w.ops)
            is_r = ops[:w.occupancy] == RANGE
            nr_slots = int(np.count_nonzero(is_r))
            if nr_slots:
                slots = np.asarray(w.slots)
                nr_arr = int(np.count_nonzero(ops[slots] == RANGE))
                self.range_admitted += nr_arr
                self.range_slots += nr_slots
                self.range_coalesce_hits += nr_arr - nr_slots
                lo = np.asarray(w.keys)[:w.occupancy][is_r]
                hi = np.asarray(keys2)[:w.occupancy][is_r]
                self.range_span_hist.record(
                    hi.astype(np.int64) - lo.astype(np.int64) + 1)
        self.hist.record(res.latencies())

    # -- readout -----------------------------------------------------------

    @property
    def wall(self) -> Optional[float]:
        if self.t_start is None or self.t_stop is None:
            return None
        return self.t_stop - self.t_start

    def summary(self) -> dict:
        wall = self.wall
        occ = (self.occupancy_sum / self.n_windows) if self.n_windows else 0.0
        coalesced = self.n_arrivals - self.n_slots
        return {
            "windows": self.n_windows,
            "arrivals": self.n_arrivals,
            "executed_queries": self.n_slots,
            "coalesced": coalesced,
            "mean_occupancy": occ,
            "rebuilds": self.n_rebuilds,
            "rebuilds_incremental": self.n_rebuilds_incremental,
            "wal_appends": self.wal_appends,
            "wal_fsyncs": self.wal_fsyncs,
            "recovery_replayed": self.recovery_replayed,
            "triggers": dict(self.triggers),
            "shed_by_class": dict(self.shed_by_class),
            "shed_total": sum(self.shed_by_class.values()),
            "retry_scheduled": self.retry_scheduled,
            "retry_exhausted": self.retry_exhausted,
            "breaker_trips": self.breaker_trips,
            "breaker_recoveries": self.breaker_recoveries,
            "read_only_rejections": self.read_only_rejections,
            "deadline_current": self.deadline_current,
            "deadline_updates": self.deadline_updates,
            "pending_fill_peak": self.pending_fill_peak,
            "range_admitted": self.range_admitted,
            "range_slots": self.range_slots,
            "range_coalesce_hits": self.range_coalesce_hits,
            "range_span_p50": self.range_span_hist.percentile(50),
            "range_span_p99": self.range_span_hist.percentile(99),
            "qps": (self.n_arrivals / wall) if wall else None,
            "p50_ms": self.hist.percentile(50) * 1e3,
            "p95_ms": self.hist.percentile(95) * 1e3,
            "p99_ms": self.hist.percentile(99) * 1e3,
        }
