"""Open-loop arrival generation for the query pipeline.

The paper's first pipeline stage collects *incoming* queries before
distributing them (Alg. 1, §4.3) — queries arrive one at a time from the
outside world, not as pre-formed batches.  This module synthesizes that
outside world: timestamped arrival streams whose *op mix* comes from the
existing YCSB generator (``repro_torch.data``) and whose *timing* comes from an
open-loop arrival process.  Open-loop means arrival times do not depend on
service times, so the stream can expose queueing behaviour (bursts,
deadline-triggered short batches, backpressure) that a closed replay loop
never would.

Processes:

``poisson``   memoryless arrivals at a constant mean rate — the classic
              open-loop baseline.
``bursty``    on/off modulated Poisson: rate multiplied by ``burst_factor``
              during a duty-cycled on-phase, throttled between bursts so
              the long-run mean rate is preserved.  Stresses the size
              trigger (bursts) *and* the deadline trigger (gaps).
``diurnal``   sinusoidally modulated rate (a compressed day/night cycle).
``hotkey``    adversarial skew: ``hot_frac`` of arrivals hit ``hot_keys``
              specific keys (Poisson timing).  Worst case for coalescing
              off, best case for coalescing on — used to bound both.

Times are *virtual* seconds starting at 0.  Replay harnesses are free to
reinterpret the axis (the benchmark replays in wall-clock, tests replay in
virtual time); only monotonicity is relied upon downstream.

A copy of ``repro.pipeline.workload``: the same seed gives the same
stream in both packages.  The client retry policy moves with the
overload tier.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch import data as data_mod
from repro_torch.core.batch import RANGE
from repro_torch.kernels.pi_search import sentinel_for

PROCESSES = ("poisson", "bursty", "diurnal", "hotkey")


@dataclasses.dataclass(frozen=True)
class ArrivalConfig:
    """Shape of one open-loop arrival stream."""

    process: str = "poisson"
    rate: float = 1e5          # mean arrivals per (virtual) second
    n_arrivals: int = 1 << 15
    # bursty
    burst_factor: float = 8.0  # on-phase rate multiplier
    burst_len: float = 0.02    # seconds each on-phase lasts
    duty: float = 0.25         # fraction of time spent in the on-phase
    # diurnal
    period: float = 1.0        # seconds per "day"
    swing: float = 0.9         # rate swings in [rate*(1-swing), rate*(1+swing)]
    # hotkey
    hot_keys: int = 4          # size of the adversarial hot set
    hot_frac: float = 0.8      # fraction of arrivals hitting the hot set
    # scan mix (YCSB-E): range_frac of arrivals become RANGE(key, key+span-1)
    range_frac: float = 0.0    # fraction of arrivals converted to scans
    span_min: int = 1          # inclusive key-span bounds of each scan,
    span_max: int = 64         #   drawn uniformly (YCSB-E's scan-length draw)
    seed: int = 0

    def __post_init__(self):
        if self.process not in PROCESSES:
            raise ValueError(
                f"unknown arrival process {self.process!r}; "
                f"pick one of {PROCESSES}")
        if self.hot_keys < 1:
            raise ValueError(
                f"hot_keys must be >= 1, got {self.hot_keys}")
        # a fraction: out-of-range values are intent ("everything hot" /
        # "nothing hot"), not errors — clamp instead of raising
        if not 0.0 <= self.hot_frac <= 1.0:
            object.__setattr__(self, "hot_frac",
                               min(1.0, max(0.0, self.hot_frac)))
        if not 0.0 <= self.range_frac <= 1.0:
            object.__setattr__(self, "range_frac",
                               min(1.0, max(0.0, self.range_frac)))
        # span bounds are geometry, not intent: a scan of zero keys (or an
        # inverted draw interval) is a config bug — raise like hot_keys
        if not 1 <= self.span_min <= self.span_max:
            raise ValueError(
                f"need 1 <= span_min <= span_max, got "
                f"{self.span_min}/{self.span_max}")


@dataclasses.dataclass
class ArrivalStream:
    """A materialized stream: arrival i is (t[i], ops[i], keys[i], vals[i]).

    The query id of arrival i is its position i — collector windows carry
    qids so per-query results can be matched back to arrivals after
    coalescing and reordering.
    """

    t: np.ndarray      # (N,) float64, nondecreasing virtual seconds
    ops: np.ndarray    # (N,) int32 SEARCH/INSERT/DELETE/RANGE
    keys: np.ndarray   # (N,) int32 (RANGE: inclusive lower bound)
    vals: np.ndarray   # (N,) int32
    keys2: "np.ndarray | None" = None  # (N,) int32 RANGE upper bounds
    #   (0 at non-RANGE positions; None == a point-only stream)

    def __len__(self) -> int:
        return self.t.shape[0]

    def __iter__(self):
        for i in range(len(self)):
            yield (float(self.t[i]), int(self.ops[i]), int(self.keys[i]),
                   int(self.vals[i]), i,
                   0 if self.keys2 is None else int(self.keys2[i]))


def _rate_factor(acfg: ArrivalConfig, t: np.ndarray) -> np.ndarray:
    """Instantaneous rate multiplier at virtual times ``t``."""
    if acfg.process == "bursty":
        cycle = acfg.burst_len / acfg.duty
        on = (t % cycle) < acfg.burst_len
        # off-phase rate chosen so the duty-weighted mean multiplier is ~1
        off_factor = max(0.05, (1.0 - acfg.duty * acfg.burst_factor)
                         / max(1e-9, 1.0 - acfg.duty))
        return np.where(on, acfg.burst_factor, off_factor)
    if acfg.process == "diurnal":
        return 1.0 + acfg.swing * np.sin(2.0 * np.pi * t / acfg.period)
    return np.ones_like(t)


def arrival_times(acfg: ArrivalConfig) -> np.ndarray:
    """Nondecreasing arrival times for the configured process.

    Modulated processes use a two-pass approximation: draw unit-rate
    exponential gaps, place provisional times at the mean rate, then
    rescale each gap by the rate multiplier at its provisional time.  Exact
    thinning is not worth a sequential loop here — the triggers under test
    only care that bursts and lulls exist at the configured scale.
    """
    rng = np.random.default_rng((acfg.seed, 0xA221))
    gaps = rng.exponential(1.0 / acfg.rate, acfg.n_arrivals)
    t0 = np.cumsum(gaps)
    factor = _rate_factor(acfg, t0)
    t = np.cumsum(gaps / np.maximum(factor, 1e-9))
    if acfg.process in ("bursty", "diurnal"):
        # renormalize so the long-run mean rate is exactly `rate` — the
        # provisional-time approximation skews the duty-weighted mean,
        # especially for extreme burst factors
        t = t * ((acfg.n_arrivals / acfg.rate) / t[-1])
    return t


def make_arrivals(acfg: ArrivalConfig, ycfg: data_mod.YCSBConfig,
                  keys: np.ndarray) -> ArrivalStream:
    """Arrival stream = open-loop timing × the YCSB zipf op mix.

    ``keys`` is the dataset the zipf generator draws from (as in
    ``data.ycsb_batch``); ``ycfg.theta`` / ``ycfg.write_ratio`` set skew
    and op mix.  For the ``hotkey`` process, ``hot_frac`` of the arrivals
    are redirected onto a tiny fixed hot set after the mix is drawn, so the
    op mix is preserved while the key distribution becomes adversarial.

    ``range_frac`` converts that fraction of arrivals into YCSB-E style
    scans *after* the redirect: the arrival's key becomes the scan start
    and its upper bound is ``key + span - 1`` for a span drawn uniformly
    from ``[span_min, span_max]`` (clamped below the key sentinel).  Skew
    and hot sets therefore shape scan *starts* exactly as they shape point
    lookups — a hotkey flood of scans lands on the same few (lo, hi) pairs,
    the coalescer's best case.
    """
    n = acfg.n_arrivals
    ops, qkeys, vals = data_mod.ycsb_batch(
        dataclasses.replace(ycfg, batch=n), np.asarray(keys),
        step=acfg.seed)
    if acfg.process == "hotkey":
        if acfg.hot_keys > len(keys):
            raise ValueError(
                f"hotkey process needs hot_keys <= len(keys): asked for a "
                f"hot set of {acfg.hot_keys} distinct keys but the dataset "
                f"has only {len(keys)}")
        rng = np.random.default_rng((acfg.seed, 0x1407))
        hot = rng.choice(np.asarray(keys), size=acfg.hot_keys, replace=False)
        mask = rng.random(n) < acfg.hot_frac
        qkeys = np.where(mask, hot[rng.integers(0, acfg.hot_keys, n)], qkeys)
    ops = ops.astype(np.int32)
    qkeys = qkeys.astype(np.int32)
    keys2 = None
    if acfg.range_frac > 0.0:
        rng = np.random.default_rng((acfg.seed, 0x3A6E))
        scan = rng.random(n) < acfg.range_frac
        span = rng.integers(acfg.span_min, acfg.span_max + 1, n)
        sent = int(sentinel_for(qkeys.dtype))   # pad key: never a valid hi
        hi = np.minimum(qkeys.astype(np.int64) + span - 1,
                        sent - 1).astype(qkeys.dtype)
        ops = np.where(scan, np.int32(RANGE), ops)
        keys2 = np.where(scan, hi, 0).astype(qkeys.dtype)
    return ArrivalStream(t=arrival_times(acfg), ops=ops,
                         keys=qkeys, vals=vals.astype(np.int32),
                         keys2=keys2)
