"""Open-loop ingestion end to end: arrivals → windows → index → latency.

The port's counterpart of ``examples/open_loop_pipeline.py``: a bursty
zipfian arrival stream (the same numpy seeds) is replayed in wall-clock
through the query pipeline: the collector admits arrivals in bulk (one
vectorized ``offer_many`` per chunk), seals size/deadline-triggered
windows, the dispatcher runs them against the index on the card
(``pi_probe`` and ``bitonic_sort`` once a window), and the metrics report
what a serving operator would watch — qps, enqueue→result percentiles,
window occupancy, coalescing, rebuilds.

  PYTHONPATH=src python examples_torch/open_loop_pipeline.py [--device cpu]
"""
import argparse
import time

from repro_torch import data as data_mod
from repro_torch.core import PIConfig, build
from repro_torch.pipeline import (ArrivalConfig, Collector, Dispatcher,
                                  PipelineMetrics, WindowConfig,
                                  make_arrivals)


def main(argv=None):
    """Runs the example; returns the metrics' summary."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--keys", type=int, default=1 << 15)
    ap.add_argument("--arrivals", type=int, default=1 << 14)
    args = ap.parse_args(argv)
    n_keys = args.keys
    ycfg = data_mod.YCSBConfig(n_keys=n_keys, theta=0.9, write_ratio=0.05)
    keys, vals = data_mod.ycsb_dataset(ycfg)
    index = build(PIConfig(capacity=n_keys * 2, pending_capacity=1 << 13),
                  keys, vals, device=args.device)

    stream = make_arrivals(
        ArrivalConfig(process="bursty", n_arrivals=args.arrivals), ycfg,
        keys)
    mets = PipelineMetrics()
    col = Collector(WindowConfig(batch=2048, deadline=0.005))
    disp = Dispatcher(index, depth=1)

    now = time.perf_counter
    # warm the first-call costs so latencies measure serving
    warm = Collector(WindowConfig(batch=2048))
    warm.offer(now(), 0, int(keys[0]), 0, 0)
    disp.submit(warm.take())
    disp.flush()
    disp.metrics = mets
    mets.start(now())
    # bulk admission fused with double-buffered submit: window k+1 is
    # formed (one vectorized offer_many per window) while the device
    # still executes window k
    disp.run(stream, collector=col, clock=now)
    mets.stop(now())

    s = mets.summary()
    print(f"served {s['arrivals']} arrivals in {s['windows']} windows "
          f"({s['coalesced']} coalesced into shared slots)")
    print(f"qps={s['qps']:.0f}  p50={s['p50_ms']:.2f}ms  "
          f"p95={s['p95_ms']:.2f}ms  p99={s['p99_ms']:.2f}ms")
    print(f"mean occupancy {s['mean_occupancy']:.0f}/{2048}, "
          f"rebuilds {s['rebuilds']}, triggers {s['triggers']}")
    return s


if __name__ == "__main__":
    main()
