"""Overload control, breaker part: the policy config, the breaker's states
and the read-only rejection type.

Counterpart of the breaker part of ``repro.pipeline.overload``.  The
dispatcher consumes ``OverloadConfig`` to replace permanent poisoning on
a pending overflow with quarantine → rollback → repack → replay (see
``dispatcher.Dispatcher._breaker_recover``), escalating ``closed →
recovering → read_only → poisoned``.  ``OverloadConfig`` keeps every
field of the JAX package's, with the same validation, because the
serving ``Server`` arms the breaker with its defaults.  Only the
breaker's fields take effect: the shed and deadline fields must keep
their defaults, and any other value raises ``NotImplementedError``
until their controllers are ported, so that no setting is silently
ignored.

Not ported yet (ROADMAP A8): ``AdmissionController`` (the shed ladder),
``DeadlineController``, ``OverloadController`` and
``workload.RetryPolicy``.  The ``SHED_*`` class names are kept so that
metrics and callers can name them.
"""
from __future__ import annotations

import dataclasses
import math

# breaker state machine (DESIGN.md §8) — escalation is strictly left to
# right; only `poisoned` latches
BREAKER_CLOSED = "closed"
BREAKER_RECOVERING = "recovering"
BREAKER_READ_ONLY = "read_only"
BREAKER_POISONED = "poisoned"

# the fields the port reads; the rest must keep their defaults
BREAKER_FIELDS = ("breaker", "max_recoveries", "recovery_interval")

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
        derived = dict(shed_range_sub_at=min(0.4, self.shed_dup_at),
                       shed_range_at=min(0.7, self.shed_search_at))
        changed = [f.name for f in dataclasses.fields(self)
                   if f.name not in BREAKER_FIELDS
                   and getattr(self, f.name) not in (
                       f.default, derived.get(f.name))]
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
        if changed:
            raise NotImplementedError(
                f"OverloadConfig fields {changed} drive the shed ladder and "
                f"the deadline controller, which are not ported yet (ROADMAP "
                f"A8); only {', '.join(BREAKER_FIELDS)} take effect")
