"""One run of one cell: set-up, a closed loop of clients through the served
path, the check against the plain reference, and the result line.

Everything a cell is made of is found by name from ``BENCHMARK.json``:
the configuration at its entry's ``file``, the traffic mix at
``pibench/traffic/<traffic>.json``, and each metric's reader at
``pibench/metrics/<metric>.py`` (a module with ``read(run)`` that returns
a number, or None when it finds nothing to read).

The loop.  ``clients`` clients each issue one op and wait for its answer
before issuing the next, so the load follows the system's speed and the
ops run in an order fixed by the seed.  Each turn offers the ops issued
since the last turn to ``Collector.offer_many``; the windows it seals go
to ``Dispatcher.submit`` (depth 1), or, when none sealed, the open window
is sealed and submitted (the clients that could still add to it are all
waiting).  Every window ``submit`` retires answers its clients, who issue
their next ops at once.  An op's latency runs from its issue to the
retirement that answers it.  The loop first retires ``WARMUP_WINDOWS``
windows (every kernel built and loaded, counted in set-up), then measures
for ``--seconds``, then stops issuing and drains.

A cell with an end-to-end metric read from the device trace traces the
device (and nothing on the host) in its untraced runs too, and marks the
measured window on the device's timeline (``trace.mark``).

The run keeps to one process with few threads: ``run.py`` holds the
CPU's thread pools to one thread, and the objects made in set-up are
frozen out of the garbage collector's passes over the window.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import math
import sys
import time
from contextlib import nullcontext
from pathlib import Path
from typing import List, Optional

import numpy as np
import torch

from pibench import reference, trace, ycsb

BENCH_DIR = "pibench"
WARMUP_WINDOWS = 16
STOP_MARGIN_S = 0.5
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    chips: int
    end_to_end: List[dict]
    per_layer: List[dict]
    root: Path


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(root, name: str) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` with its files."""
    root = Path(root)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = json.loads((root / entry["file"]).read_text())
    traffic = json.loads(
        (root / BENCH_DIR / "traffic" / f"{w['traffic']}.json").read_text())
    return Cell(name, config, traffic, w["chips"],
                [m for m in bench["end_to_end"] if _applies(m, name)],
                [m for m in bench["per_layer"] if _applies(m, name)], root)


def reader(root, metric: str):
    """The ``read`` function of ``pibench/metrics/<metric>.py``."""
    path = Path(root) / BENCH_DIR / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "pibench_metric_" + metric.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> List[str]:
    """Modules of JAX or of the JAX package loaded in this process, by
    whole top-level name."""
    return sorted({m.split(".")[0] for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


def log(msg: str):
    print(f"pibench: {msg}", file=sys.stderr, flush=True)


@dataclasses.dataclass
class Retired:
    window: object          # the collector's Window
    result: object          # the dispatcher's WindowResult
    t_answer: float         # when its clients got their answers


@dataclasses.dataclass
class Run:
    """What a metric reader reads."""

    cell: Cell
    seconds: float
    setup_s: float
    t0: float
    t_end: float
    issue_t: np.ndarray
    retired: List[Retired]
    spans: list              # (kind, start, end) on the host clock
    submitted: list          # (Window, t_submit) in submit order
    marks: Optional[tuple] = None      # host clock at the device marks
    timeline: Optional[trace.Timeline] = None
    card: Optional[trace.Timeline] = None   # the device between the marks
    fences: Optional[np.ndarray] = None
    expected: Optional[tuple] = None   # the reference's answer words by op

    def answered_in_window(self):
        """(op ids, latencies in s) of the ops answered in the window."""
        ids, lat = [], []
        for r in self.retired:
            if self.t0 < r.t_answer <= self.t_end:
                q = np.asarray(r.window.qids)
                ids.append(q)
                lat.append(r.t_answer - self.issue_t[q])
        if not ids:
            return np.zeros(0, np.int64), np.zeros(0)
        return np.concatenate(ids), np.concatenate(lat)

    def in_window(self, t: float) -> bool:
        return self.t0 <= t <= self.t_end


def drive(system, arr: dict, clients: int, seconds: float, started: float,
          traced: bool, errors=(), clock=time.perf_counter, mark=None):
    """The closed loop (see the module docstring) → (Run fields, error):
    ``errors`` are the program's exceptions that end a run as a reported
    failure; ``started`` is the process's start on ``clock``; ``mark``,
    when given, marks the device's timeline where the window opens and
    where the loop ends, before the drain."""
    col, disp = system.collector, system.dispatcher
    total = arr["ops"].shape[0]
    qids = np.arange(total)
    issue_t = np.zeros(total)
    retired: List[Retired] = []
    spans, submitted = [], []
    span = (lambda k: torch.profiler.record_function(trace.SPAN + k)) \
        if traced else (lambda k: nullcontext())
    window_span = None
    marks = None
    t0 = t_end = math.inf
    setup_s = math.nan
    issue_t[:clients] = clock()
    s, e = 0, clients
    error = None
    try:
        while True:
            ta = clock()
            with span("admit"):
                sealed = col.offer_many(
                    issue_t[s:e], arr["ops"][s:e], arr["keys"][s:e],
                    arr["vals"][s:e], qids[s:e], arr["keys2"][s:e])[1] \
                    if e > s else []
                if not sealed:
                    w = col.take()
                    sealed = [w] if w is not None else []
            spans.append(("admit", ta, clock()))
            got = []
            for w in sealed:
                ts = clock()
                with span("submit"):
                    got += disp.submit(w)
                submitted.append((w, ts))
                spans.append(("submit", ts, clock()))
            if not sealed:
                ts = clock()
                with span("submit"):
                    got = disp.flush()
                spans.append(("submit", ts, clock()))
                if not got:
                    raise RuntimeError("the closed loop stalled: no window "
                                       "open, none in flight")
            now = clock()
            retired += [Retired(r.window, r, now) for r in got]
            if t0 == math.inf and len(retired) >= WARMUP_WINDOWS:
                t0, t_end = now, now + seconds
                setup_s = now - started
                if traced:
                    window_span = span("window")
                    window_span.__enter__()
                if mark is not None:
                    mark()
                    marks = (clock(),)
            if now >= t_end:
                break
            n = sum(len(r.window.qids) for r in got)
            if e + n > total:
                raise RuntimeError(
                    f"the {total} ops made in set-up ran out: raise the "
                    f"traffic's max_ops_per_s")
            s, e = e, e + n
            issue_t[s:e] = now
    except errors as exc:          # a failure the program reports
        error = exc
    if window_span is not None:
        window_span.__exit__(None, None, None)
    if marks is not None:
        mark()
        marks += (clock(),)
    if error is None:
        # drain: the clients stop issuing; every issued op is answered
        try:
            w = col.take()
            if w is not None:
                submitted.append((w, clock()))
                retired += [Retired(r.window, r, clock())
                            for r in disp.submit(w)]
            retired += [Retired(r.window, r, clock()) for r in disp.flush()]
        except errors as exc:
            error = exc
    return dict(seconds=seconds, setup_s=setup_s, t0=t0, t_end=t_end,
                issue_t=issue_t[:e], retired=retired, spans=spans,
                submitted=submitted, marks=marks), error


def program_answers(retired: List[Retired], n: int):
    """The answers the clients received, by op id: two int64 words (a point
    op's found and value, a RANGE's count and sum), the window number of
    each op (-1: none answered it), and the op ids in the order the
    windows held them."""
    a1 = np.zeros(n, np.int64)
    a2 = np.zeros(n, np.int64)
    window = np.full(n, -1, np.int64)
    order = []
    for k, r in enumerate(retired):
        res, w = r.result, r.window
        q = np.asarray(w.qids, np.int64)
        slots = np.asarray(w.slots, np.int64)
        is_r = np.asarray(w.ops)[slots] == ycsb.RANGE
        f = res.found[slots].astype(np.int64)
        v = res.val[slots].astype(np.int64)
        if res.rcnt is not None:
            f = np.where(is_r, res.rcnt[slots], f)
            v = np.where(is_r, res.rsum[slots], v)
        a1[q], a2[q], window[q] = f, v, k
        order.append(q)
    order = np.concatenate(order) if order else np.zeros(0, np.int64)
    return a1, a2, window, order


def _f32(x: torch.Tensor) -> torch.Tensor:
    """Keys as float32 holds them, back as integers."""
    return x.to(torch.float32).to(torch.int64)


def check(config: dict, seed: int, arr: dict, n: int, retired, live, error,
          device, control: bool = False):
    """Every answer and the live set against the plain reference →
    (ordered checks {name: (value, limit)}, the reference's answer words
    by op or None).  With ``control`` the reference computed on float32
    keys stands in the program's place: its answers and live set are
    judged instead of the program's."""
    a1, a2, window, order = program_answers(retired, n)
    n_ans = order.size
    breaks = int(np.count_nonzero(order != np.arange(n_ans)))
    checks = {"unanswered": n - n_ans, "schedule_breaks": breaks}
    expected = None
    if breaks:
        # the windows do not cut the issued order: nothing is comparable
        checks["wrong_answers"] = n_ans
        checks["live_set_diff"] = n
    else:
        dev = torch.device(device)
        keys, vals = ycsb.base_records(config, seed, dev)

        def t(x):
            return torch.from_numpy(np.ascontiguousarray(x[:n_ans])).to(dev)

        ops, qk, qk2, qv, win = (t(arr["ops"]), t(arr["keys"]),
                                 t(arr["keys2"]), t(arr["vals"]), t(window))
        ref = reference.Reference(keys, vals, ops, qk, qv)
        e1, e2 = reference.expected(ref, ops, qk, qk2, win)
        e1, e2 = e1.cpu().numpy(), e2.cpu().numpy()
        if control:
            cref = reference.Reference(_f32(keys), vals, ops, _f32(qk), qv)
            c1, c2 = reference.expected(cref, ops, _f32(qk), _f32(qk2), win)
            a1, a2 = c1.cpu().numpy(), c2.cpu().numpy()
            live = cref.live_set()
            del cref
        del keys, vals
        wrong = (a1[:n_ans] != e1) | (a2[:n_ans] != e2)
        checks["wrong_answers"] = int(np.count_nonzero(wrong))
        rk, rv = ref.live_set()
        pk, pv = live
        checks["live_set_diff"] = reference.set_difference(
            pk.to(dev), pv.to(dev), rk, rv)
        expected = (e1, e2)
    checks["program_errors"] = int(error is not None)
    return {k: (v, 0) for k, v in checks.items()}, expected


def run_cell(cell: Cell, seed: int, seconds: float, traced: bool,
             device, started: float, control: bool = False) -> dict:
    """One run → the result line's object (``checks`` last); ``control``
    judges the float32 reference in the program's place (see ``check``)."""
    from pibench import system as sut
    config, traffic = cell.config, cell.traffic
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    log(f"set-up: imports done {time.perf_counter() - started:.3f} s in")
    keys, vals = ycsb.base_records(config, seed, dev)
    system = sut.build(config, keys, vals)
    del keys, vals
    log(f"set-up: records and index built "
        f"{time.perf_counter() - started:.3f} s in")
    clients = traffic["clients"]
    count = clients * (WARMUP_WINDOWS + 2) + \
        int(math.ceil(traffic["max_ops_per_s"] * seconds))
    arr = {k: v.cpu().numpy()
           for k, v in ycsb.make_ops(traffic, config, seed, count,
                                     dev).items()}
    log(f"set-up: {count} ops made {time.perf_counter() - started:.3f} s in")
    card = cuda and not traced and any(
        m["source"] == "device_trace" for m in cell.end_to_end)
    prof = None
    if traced or card:
        acts = ([torch.profiler.ProfilerActivity.CPU] if traced else []) + (
            [torch.profiler.ProfilerActivity.CUDA] if cuda else [])
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()
    gc.collect()
    gc.freeze()
    fields, error = drive(system, arr, clients, seconds, started, traced,
                          sut.PROGRAM_ERRORS,
                          mark=trace.mark if card else None)
    gc.unfreeze()
    if cuda:
        torch.cuda.synchronize(dev)
    if prof is not None:
        # the profiler keeps only the device ops that end before it stops,
        # by a clock the device's timestamps are converted to: leave the
        # last of them room
        time.sleep(STOP_MARGIN_S)
        prof.__exit__(None, None, None)
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    fences = sut.fences(system)
    live = sut.live_set(system)
    del system
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    n = fields["issue_t"].shape[0]
    per_s = np.zeros(max(1, int(math.ceil(seconds))), np.int64)
    for r in fields["retired"]:
        if fields["t0"] < r.t_answer <= fields["t_end"]:
            per_s[min(per_s.size - 1, int(r.t_answer - fields["t0"]))] += \
                len(r.window.qids)
    log(f"window: {len(fields['retired'])} windows retired, {n} ops issued, "
        f"answered a second {per_s.tolist()}; the check starts "
        f"{time.perf_counter() - started:.3f} s in")
    checks, expected = check(config, seed, arr, n, fields["retired"], live,
                             error, dev, control)
    log(f"check: done {time.perf_counter() - started:.3f} s in")
    marked = None
    if card:
        ops = trace.device_ops(prof)
        marked = trace.between_marks(ops)
        log(f"card trace: {len(ops)} device ops, "
            f"{sum(trace.MARK in o[0] for o in ops)} marks")
    run = Run(cell=cell,
              timeline=trace.from_profiler(prof) if traced and prof else None,
              card=marked, fences=fences, expected=expected, **fields)
    metrics = {}
    for m in (cell.per_layer if traced else cell.end_to_end):
        value = reader(cell.root, m["name"])(run)
        if value is not None and math.isfinite(value):
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev_info = {"platform": "gpu" if cuda else dev.type,
                "kind": torch.cuda.get_device_name(dev) if cuda else dev.type,
                "count": 1, "memory_peak_bytes": int(peak)}
    out = {"correct": all(v <= lim for v, lim in checks.values()),
           "attempted": n,
           "failed": checks["wrong_answers"][0] + checks["unanswered"][0],
           "metrics": metrics, "device": dev_info}
    if run.timeline is not None:
        tl = run.timeline
        dev_info["busy_s"] = trace.busy_ns(tl) * 1e-9
        dev_info["window_s"] = tl.window_s
        out["breakdown"] = {
            "device_ops": trace.top(trace.device_time(tl)),
            "idle_gaps": trace.top(trace.idle_by_host(tl))}
    if error is not None:
        out["error"] = repr(error)[:500]
    out["checks"] = {k: {"value": v, "limit": lim}
                     for k, (v, lim) in checks.items()}
    return out


def emit(out: dict, file_out=None, file_err=None):
    """The compared numbers beside their limits as the last lines of
    standard error, then the result as the last line of standard output."""
    file_out = file_out or sys.stdout
    file_err = file_err or sys.stderr
    checks = out.pop("checks")
    out["checks"] = checks                       # last key
    for k, c in checks.items():
        print(f"check {k} {c['value']} limit {c['limit']}", file=file_err)
    file_err.flush()
    print(json.dumps(out), file=file_out, flush=True)
