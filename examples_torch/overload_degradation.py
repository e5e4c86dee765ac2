"""Graceful degradation under overload: shed, recover, retune — not crash.

The port's counterpart of ``examples/overload_degradation.py``: three
short scenarios against the same PI index, on the card, show the
overload tier (DESIGN.md §8) absorbing conditions that used to be fatal:

1. **Circuit breaker**: a burst of distinct inserts at 4x the pending
   buffer's capacity.  Without an ``OverloadConfig`` the first overflow
   poisons the dispatcher permanently; with the breaker armed, each
   overflow is quarantined, the index rolls back and repacks, the
   in-flight windows replay, and the stream completes with every result
   intact.
2. **Adaptive shedding**: a write-heavy hotkey flood drives pending-fill
   pressure up; the admission controller sheds duplicate SEARCHes first,
   then all SEARCHes, and clients retry with bounded exponential backoff.
   Everything acknowledged is exact; everything shed is counted per class.
3. **Adaptive deadline**: a diurnal stream whose lulls seal windows
   nearly empty by deadline; the controller grows the deadline until
   windows fill, then reports the retune trajectory.

  PYTHONPATH=src python examples_torch/overload_degradation.py [--device cpu]
"""
import argparse
import time
import types

import numpy as np

from repro_torch import data as data_mod
from repro_torch.core import (INSERT, PIConfig, build, flat_leaves,
                              from_flat_leaves)
from repro_torch.pipeline import (ArrivalConfig, Collector, Dispatcher,
                                  OverloadConfig, OverloadController,
                                  PendingOverflowError, PipelineMetrics,
                                  RetryPolicy, WindowConfig, make_arrivals)


def fresh_index(pc, device):
    """Seed large enough that the churn-rebuild trigger stays quiet, so
    pending fill can accumulate across windows (the overflow geometry)."""
    rng = np.random.default_rng(7)
    keys0 = np.unique(rng.integers(1, 1 << 20, 4096).astype(np.int32))
    vals0 = rng.integers(0, 1000, keys0.size).astype(np.int32)
    idx = build(PIConfig(capacity=1 << 14, pending_capacity=pc, fanout=8),
                keys0, vals0, device=device)
    return idx, keys0


def breaker_demo(device):
    pc, batch = 128, 80   # batch <= 3/4*pc: fill accumulates, then spills
    n = 4 * pc
    burst = types.SimpleNamespace(
        t=np.arange(n, dtype=np.float64),
        ops=np.full(n, INSERT, np.int32),
        keys=(2_000_000 + np.arange(n)).astype(np.int32),
        vals=np.arange(n, dtype=np.int32))
    idx, _ = fresh_index(pc, device)

    # legacy contract: the first pending overflow is permanent
    legacy = Dispatcher(from_flat_leaves(
        idx.config, [x.clone() for x in flat_leaves(idx)]), depth=1)
    try:
        legacy.run(burst, collector=Collector(WindowConfig(batch=batch)),
                   chunk=batch)
        raise AssertionError("burst should have overflowed")
    except PendingOverflowError:
        print(f"[breaker] legacy dispatcher: poisoned at 4x pending "
              f"capacity (as designed, but fatal)")

    m = PipelineMetrics()
    disp = Dispatcher(idx, depth=1, metrics=m, overload=OverloadConfig())
    res = disp.run(burst, collector=Collector(WindowConfig(batch=batch)),
                   chunk=batch)
    acked = {}
    for r in res:
        acked.update(r.per_arrival())
    print(f"[breaker] armed dispatcher: {m.breaker_trips} overflow(s) "
          f"quarantined + replayed, state={disp.breaker_state}, "
          f"{len(acked)}/{n} ops acked")
    return {"trips": m.breaker_trips, "state": disp.breaker_state,
            "acked": len(acked), "n": n}


def shedding_demo(device):
    idx, keys0 = fresh_index(128, device)
    n = 4096
    flood = make_arrivals(
        ArrivalConfig(process="hotkey", rate=1e4, n_arrivals=n,
                      hot_keys=4, hot_frac=0.8, seed=3),
        data_mod.YCSBConfig(write_ratio=0.6, theta=0.9), keys0)
    m = PipelineMetrics()
    ctl = OverloadController(
        OverloadConfig(shed_dup_at=0.15, shed_search_at=0.3,
                       adapt_deadline=False, max_recoveries=10_000),
        metrics=m, retry=RetryPolicy(max_retries=3))
    disp = Dispatcher(idx, depth=1, metrics=m, overload=ctl.cfg)
    rep = ctl.run(disp, Collector(WindowConfig(batch=80)), flood,
                  chunk=80, clock=time.perf_counter)
    s = m.summary()
    print(f"[shed] goodput {rep.goodput}/{n} "
          f"({rep.goodput / n:.0%}), shed by class {s['shed_by_class']}, "
          f"{rep.retries} retries, {len(rep.dropped)} dropped after "
          f"exhausting backoff")
    print(f"[shed] pending-fill peak {s['pending_fill_peak']:.2f}, "
          f"breaker trips {s['breaker_trips']}")
    return {"goodput": rep.goodput, "n": n, "dropped": len(rep.dropped),
            "retries": rep.retries}


def deadline_demo(device):
    idx, keys0 = fresh_index(1024, device)
    diurnal = make_arrivals(
        ArrivalConfig(process="diurnal", rate=2e3, n_arrivals=6000,
                      period=0.5, swing=0.95, seed=5),
        data_mod.YCSBConfig(write_ratio=0.2), keys0)
    m = PipelineMetrics()
    ctl = OverloadController(
        OverloadConfig(shed=False, breaker=False, adjust_every=4,
                       hysteresis=2, deadline_min=1e-3, deadline_max=0.5,
                       deadline_step=2.0),
        metrics=m)
    # virtual time: the stream's own stamps drive the deadline seals
    disp = Dispatcher(idx, depth=1, metrics=m, clock=lambda: 0.0)
    col = Collector(WindowConfig(batch=64, deadline=0.002))
    ctl.run(disp, col, diurnal, chunk=64)
    s = m.summary()
    traj = " -> ".join(f"{d * 1e3:.0f}ms"
                       for _, d in ctl.deadline_controller.trajectory)
    print(f"[deadline] {s['deadline_updates']} retunes: {traj}")
    print(f"[deadline] {s['windows']} windows, mean occupancy "
          f"{s['mean_occupancy']:.0f}/64 (static 2ms deadline seals "
          f"lull windows nearly empty; the controller grows it)")
    return {"retunes": s["deadline_updates"], "windows": s["windows"]}


def main(argv=None):
    """Runs the three scenarios; returns what each reports."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    out = {"breaker": breaker_demo(args.device),
           "shed": shedding_demo(args.device),
           "deadline": deadline_demo(args.device)}
    b = out["breaker"]
    assert b["acked"] == b["n"], "the armed breaker lost acknowledged ops"
    return out


if __name__ == "__main__":
    main()
