"""Serving path above the PI core, for one shard or fence-routed shards
(on one card, or over the ranks of a mesh: every rank runs the same
collector and dispatcher).

  workload    open-loop arrival streams (poisson/bursty/diurnal/hotkey
              timing × the YCSB zipf op mix, with a YCSB-E scan mix)
  collector   fixed-capacity window: size/deadline seal triggers, SEARCH
              and exact-pair RANGE coalescing, backpressure; scalar
              ``offer`` and bulk ``offer_many`` (identical windows)
  dispatcher  ``Dispatcher``: windows in order against a ``PIIndex``
              (``step_single``: execute, rebuild if due) or a
              ``ShardedPIIndex`` with its mesh (fence routing, the due
              shards rebuilt), ranges against the pre-window state,
              ``depth`` windows in flight
  ranges      ``execute_ranges``: a window's RANGE lanes, one ``pi_range``
              launch on the card; ``execute_ranges_sharded``: one a shard,
              the partials summed
  metrics     enqueue→result latency histograms, occupancy, rebuild,
              range and durability counters
  wal         segmented CRC-framed write-ahead log, one record per sealed
              window (byte-identical to the JAX package's)
  recovery    ``Durability`` (WAL append at seal, periodic snapshots) and
              ``recover`` (latest snapshot + WAL tail replay)
  overload    ``OverloadController``: the shed ladder
              (``AdmissionController``), retries (``RetryPolicy``) and
              deadline retuning (``DeadlineController``) around a
              collector and a dispatcher; the breaker's states and
              ``ReadOnlyModeError`` (the dispatcher's rollback → repack →
              replay)
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
    AdmissionController, BREAKER_CLOSED, BREAKER_POISONED, BREAKER_READ_ONLY,
    BREAKER_RECOVERING, DeadlineController, OverloadConfig,
    OverloadController, ReadOnlyModeError, RunReport, SHED_RANGE,
    SHED_RANGE_SUB, SHED_SEARCH, SHED_SEARCH_DUP, SHED_WRITE,
)
from repro_torch.pipeline.ranges import (
    execute_ranges, execute_ranges_sharded, range_launch_count,
)
from repro_torch.pipeline.recovery import Durability, RecoveryError, recover
from repro_torch.pipeline.wal import (
    FSYNC_POLICIES, WalCorruptionError, WalRecord, WalWriter, read_wal,
    record_window,
)
from repro_torch.pipeline.workload import (
    PROCESSES, ArrivalConfig, ArrivalStream, RetryPolicy, arrival_times,
    make_arrivals,
)

__all__ = [
    "ArrivalConfig", "ArrivalStream", "PROCESSES", "arrival_times",
    "make_arrivals", "RetryPolicy",
    "Collector", "Window", "WindowConfig",
    "TRIGGER_SIZE", "TRIGGER_DEADLINE", "TRIGGER_FLUSH",
    "Dispatcher", "DispatchOverflowError", "PendingOverflowError",
    "WindowResult", "step_single", "step_recover",
    "BREAKER_CLOSED", "BREAKER_RECOVERING", "BREAKER_READ_ONLY",
    "BREAKER_POISONED", "OverloadConfig", "ReadOnlyModeError",
    "OverloadController", "AdmissionController", "DeadlineController",
    "RunReport",
    "SHED_RANGE_SUB", "SHED_SEARCH_DUP", "SHED_RANGE", "SHED_SEARCH",
    "SHED_WRITE",
    "LatencyHistogram", "PipelineMetrics",
    "execute_ranges", "execute_ranges_sharded", "range_launch_count",
    "Durability", "RecoveryError", "recover",
    "FSYNC_POLICIES", "WalCorruptionError", "WalRecord", "WalWriter",
    "read_wal", "record_window",
]
