"""Serving path above the PI core, for one shard.

  workload    open-loop arrival streams (poisson/bursty/diurnal/hotkey
              timing × the YCSB zipf op mix, with a YCSB-E scan mix)
  collector   fixed-capacity window: size/deadline seal triggers, SEARCH
              and exact-pair RANGE coalescing, backpressure; scalar
              ``offer`` and bulk ``offer_many`` (identical windows)
  dispatcher  ``Dispatcher``: windows in order against one ``PIIndex``,
              ranges against the pre-window state, then ``step_single``
              (execute, rebuild if due), ``depth`` windows in flight
  ranges      ``execute_ranges``: a window's RANGE lanes, one ``pi_range``
              launch on the card
  metrics     enqueue→result latency histograms, occupancy, rebuild,
              range and durability counters
  wal         segmented CRC-framed write-ahead log, one record per sealed
              window (byte-identical to the JAX package's)
  recovery    ``Durability`` (WAL append at seal, periodic snapshots) and
              ``recover`` (latest snapshot + WAL tail replay)
  overload    the breaker part: ``OverloadConfig``, the ``BREAKER_*``
              states, ``ReadOnlyModeError`` (the dispatcher's rollback →
              repack → replay)

Not ported yet: the rest of overload control — the shed ladder,
``DeadlineController``, ``OverloadController``, ``RetryPolicy`` (ROADMAP
A8) — and the sharded path (A9).
"""
from repro_torch.pipeline.collector import (
    Collector, TRIGGER_DEADLINE, TRIGGER_FLUSH, TRIGGER_SIZE, Window,
    WindowConfig,
)
from repro_torch.pipeline.dispatcher import (
    DispatchOverflowError, Dispatcher, PendingOverflowError, WindowResult,
    step_recover, step_single,
)
from repro_torch.pipeline.metrics import LatencyHistogram, PipelineMetrics
from repro_torch.pipeline.overload import (
    BREAKER_CLOSED, BREAKER_POISONED, BREAKER_READ_ONLY, BREAKER_RECOVERING,
    OverloadConfig, ReadOnlyModeError,
)
from repro_torch.pipeline.ranges import execute_ranges
from repro_torch.pipeline.recovery import Durability, RecoveryError, recover
from repro_torch.pipeline.wal import (
    FSYNC_POLICIES, WalCorruptionError, WalRecord, WalWriter, read_wal,
    record_window,
)
from repro_torch.pipeline.workload import (
    PROCESSES, ArrivalConfig, ArrivalStream, arrival_times, make_arrivals,
)

__all__ = [
    "ArrivalConfig", "ArrivalStream", "PROCESSES", "arrival_times",
    "make_arrivals",
    "Collector", "Window", "WindowConfig",
    "TRIGGER_SIZE", "TRIGGER_DEADLINE", "TRIGGER_FLUSH",
    "Dispatcher", "DispatchOverflowError", "PendingOverflowError",
    "WindowResult", "step_single", "step_recover",
    "BREAKER_CLOSED", "BREAKER_RECOVERING", "BREAKER_READ_ONLY",
    "BREAKER_POISONED", "OverloadConfig", "ReadOnlyModeError",
    "LatencyHistogram", "PipelineMetrics",
    "execute_ranges",
    "Durability", "RecoveryError", "recover",
    "FSYNC_POLICIES", "WalCorruptionError", "WalRecord", "WalWriter",
    "read_wal", "record_window",
]
