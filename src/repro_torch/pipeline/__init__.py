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

Not ported yet: overload control (ROADMAP A8), the sharded path (A9).
"""
from repro_torch.pipeline.collector import (
    Collector, TRIGGER_DEADLINE, TRIGGER_FLUSH, TRIGGER_SIZE, Window,
    WindowConfig,
)
from repro_torch.pipeline.dispatcher import (
    DispatchOverflowError, Dispatcher, PendingOverflowError, WindowResult,
    step_single,
)
from repro_torch.pipeline.metrics import LatencyHistogram, PipelineMetrics
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
    "WindowResult", "step_single",
    "LatencyHistogram", "PipelineMetrics",
    "execute_ranges",
    "Durability", "RecoveryError", "recover",
    "FSYNC_POLICIES", "WalCorruptionError", "WalRecord", "WalWriter",
    "read_wal", "record_window",
]
