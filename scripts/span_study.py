"""The program's spans in one traced run of a benchmark cell.

    PYTHONPATH=src python scripts/span_study.py --workload pi1.ycsb-e \
        --seed 3300000001 [--seconds 30] [--spans 0] [--small --device cpu]

Runs the benchmark's traced run of the cell (``pibench.harness.run_cell``,
as ``pibench/run.py --trace 1`` does) with the program's spans
(``repro_torch.tracing``) on, or with ``--spans 0`` off, so that two runs
of one seed give the spans' cost.  Prints one JSON line: the result
line's metrics and checks, the card, the five span readings of
``pibench.spans.READERS``, the busy device ms a window, device ms a window
by the span that launched each op and the top ops of each, host ms a
window by span and of the CUDA runtime calls made inside each span (a
call that blocks the host shows there), and idle device seconds by span.
``--small`` cuts the cell to the CPU tests' size (``pibench.smallcells``).
"""
import argparse
import json
import os
import sys
from unittest import mock

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from pibench import harness, run, smallcells, spans, trace  # noqa: E402
from repro_torch import tracing  # noqa: E402


def top_ops(tl, n: int = 3):
    """Device seconds in the window of each span's top ``n`` ops."""
    by = {}
    for (name, a, b), s in zip(tl.device, tl.span_of):
        ops = by.setdefault(s or "none", {})
        ops[name] = ops.get(name, 0.0) + (b - a) * 1e-9
    return {s: trace.top(ops, n, 80) for s, ops in by.items()}


def host_ms(tl, n: int):
    """Host ms a window of each span name, children included."""
    by = {}
    for name, a, b in tl.program:
        by[name] = by.get(name, 0.0) + (b - a) * 1e-6 / n
    return by


def runtime_ms(evs, tl, n: int, top: int = 3):
    """Host ms a window of the CUDA runtime calls in the window, by the
    innermost program span they were made in: each span's ``top``."""
    lo, hi = tl.window
    calls = [e for e in evs if not e.on_device and not e.annotation
             and e.name.startswith(spans.RUNTIME) and lo <= e.start < hi]
    by = {}
    for e, s in zip(calls, spans.innermost(tl.program,
                                           [e.start for e in calls])):
        c = by.setdefault(s or "none", {})
        c[e.name] = c.get(e.name, 0.0) + (e.end - e.start) * 1e-6 / n
    return {s: trace.top(c, top, 60) for s, c in by.items()}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=30.0)
    p.add_argument("--spans", type=int, choices=(0, 1), default=1)
    p.add_argument("--device", default="cuda")
    p.add_argument("--small", action="store_true")
    args = p.parse_args(argv)
    torch.set_num_threads(1)
    cell = smallcells.small_cell(args.workload) if args.small else \
        harness.load_cell(run.ROOT, args.workload)
    evs = []

    def events(prof):
        evs[:] = real_events(prof)
        return evs

    real_events = spans.events
    with mock.patch.object(spans, "events", events):
        out, tl = spans.traced_run(
            cell, args.seed, args.seconds, args.device, run.STARTED,
            switch=tracing.enable if args.spans else None)
    line = {"workload": args.workload, "seed": args.seed,
            "spans": args.spans, "correct": out["correct"],
            "metrics": {k: m["value"] for k, m in out["metrics"].items()},
            "device": out["device"],
            "card": run.card_line() if args.device == "cuda" else "cpu"}
    if tl is not None:
        n = spans.windows(tl)
        line.update(
            windows=n,
            program={k: f(tl) for k, f in spans.READERS.items()},
            busy_ms=1e-6 * trace.busy_ns(tl) / n if n else None,
            by_annotation=tl.by_annotation,
            device_ms_by_span=spans.device_ms_by_span(tl),
            top_ops=top_ops(tl),
            host_ms_by_span=host_ms(tl, n) if n else {},
            runtime_ms_by_span=runtime_ms(evs, tl, n) if n else {},
            idle_by_span=out["breakdown"]["idle_by_span"],
            idle_gaps=out["breakdown"]["idle_gaps"])
    line["checks"] = {k: c["value"] for k, c in out["checks"].items()}
    print(json.dumps(line), flush=True)
    return 0 if out["correct"] else 1


if __name__ == "__main__":
    sys.exit(main())
