"""The program's own spans on the profiler's timeline, the device ops tied to
them by launch, and the per-window readings taken from them.

``repro_torch.tracing`` marks the phases of the served path with
``record_function`` ranges named ``pi.<phase>`` while its switch is on.
The profiler records each range twice: on the host, where it opens and
closes, and as an annotation on the device's timeline.  An annotation is
no device op: ``timeline`` leaves the ``pi.*`` ones out of the device
ops, as ``trace.from_profiler`` leaves out the harness's ``pibench.*``
ones, so busy and idle time read the same with the program's spans on or
off.

A device op is tied to the span that launched it, not to the span its
timestamps overlap (at depth 1 the card runs window k while the host
admits k + 1).  The profiler gives a device op the correlation id of the
runtime call that enqueued it (``cudaLaunchKernel``, ``cudaMemcpyAsync``,
...); the op belongs to the innermost ``pi.*`` host span open when that
call began, or to none.  Where the trace lacks the runtime call, it falls
back to the device-side annotations: the op belongs to the innermost
``pi.*`` annotation that holds its start (``ProgramTimeline``'s
``by_annotation`` counts such ops).

The readings are per window: over the ``pi.submit`` spans (one a window)
in the traced window.  Everything but ``events`` and ``traced_run`` works
on plain tuples, so a timeline can be built by hand.
"""
from __future__ import annotations

import dataclasses
from contextlib import ExitStack
from typing import Callable, Dict, Iterable, List, NamedTuple, Optional
from unittest import mock

from pibench import harness, trace
from pibench.trace import Interval

PREFIX = "pi."
SUBMIT = PREFIX + "submit"
RANGES = PREFIX + "submit.ranges"
WRITES = PREFIX + "execute.writes"
MERGE = PREFIX + "execute.merge"
COALESCE = PREFIX + "admit.coalesce"
WAIT = PREFIX + "wait."
RUNTIME = "cu"       # CUDA API calls: cudaLaunchKernel, cuLaunchKernel, ...


class Event(NamedTuple):
    """One profiler event, as this module reads it."""
    name: str
    on_device: bool
    start: int               # ns
    end: int                 # ns
    correlation: int         # a device op's and its launch's are equal
    annotation: bool         # a record_function range (host or device)


@dataclasses.dataclass
class ProgramTimeline(trace.Timeline):
    """``trace.Timeline`` with the program's host spans in the window and,
    for each device op, the innermost span that launched it (None: no
    span did)."""
    program: List[Interval] = dataclasses.field(default_factory=list)
    span_of: List[Optional[str]] = dataclasses.field(default_factory=list)
    by_annotation: int = 0    # ops whose launch the trace lacks


def events(prof) -> List[Event]:
    """The events of a finished ``torch.profiler.profile``."""
    return [Event(e.name(), str(e.device_type()).endswith("CUDA"),
                  e.start_ns(), e.end_ns(), e.correlation_id(),
                  e.is_user_annotation())
            for e in prof.profiler.kineto_results.events()]


def innermost(spans: Iterable[Interval], points: List[int]) \
        -> List[Optional[str]]:
    """For each time in ``points``, the name of the innermost of ``spans``
    that holds it, or None.  The spans nest, as one thread's do."""
    spans = sorted(spans, key=lambda s: (s[1], -s[2]))
    out: List[Optional[str]] = [None] * len(points)
    stack: List[Interval] = []
    i = 0
    for j in sorted(range(len(points)), key=points.__getitem__):
        t = points[j]
        while i < len(spans) and spans[i][1] <= t:
            while stack and stack[-1][2] < spans[i][1]:
                stack.pop()
            stack.append(spans[i])
            i += 1
        while stack and stack[-1][2] < t:
            stack.pop()
        out[j] = stack[-1][0] if stack else None
    return out


def timeline(evs: List[Event]) -> Optional[ProgramTimeline]:
    """What ``trace.from_profiler`` gives, with the program's spans and the
    device ops tied to them; None when no traced window is there."""
    window = None
    host, program, device, marks = [], [], [], []
    launch_at: Dict[int, int] = {}
    for e in evs:
        if e.on_device:
            if e.name.startswith(PREFIX):
                marks.append((e.name, e.start, e.end))
            elif not e.name.startswith(trace.SPAN):
                device.append(e)
        elif e.name == trace.WINDOW:
            window = (e.start, e.end)
        elif e.name.startswith(trace.SPAN):
            host.append((e.name[len(trace.SPAN):], e.start, e.end))
        elif e.name.startswith(PREFIX):
            program.append((e.name, e.start, e.end))
        elif e.name.startswith(RUNTIME) and not e.annotation:
            launch_at[e.correlation] = e.start
    if window is None:
        return None
    # by launch where the runtime call is in the trace, else by annotation
    launched = [launch_at.get(d.correlation) for d in device]
    span_of: List[Optional[str]] = [None] * len(device)
    via = {True: [], False: []}
    for i, t in enumerate(launched):
        via[t is not None].append(i)
    for i, name in zip(via[True], innermost(
            program, [launched[i] for i in via[True]])):
        span_of[i] = name
    for i, name in zip(via[False], innermost(
            marks, [device[i].start for i in via[False]])):
        span_of[i] = name
    lo, hi = window
    kept, kept_span, by_annotation = [], [], 0
    for d, name, t in zip(device, span_of, launched):
        a, b = max(d.start, lo), min(d.end, hi)
        if b > a:
            kept.append((d.name, a, b))
            kept_span.append(name)
            by_annotation += t is None
    return ProgramTimeline(window, kept, trace.clip(host, lo, hi),
                           program=trace.clip(program, lo, hi),
                           span_of=kept_span, by_annotation=by_annotation)


def windows(tl) -> int:
    """The ``pi.submit`` spans in the traced window: one a window."""
    return sum(1 for name, _, _ in getattr(tl, "program", ())
               if name == SUBMIT)


def device_ms(tl, span: str) -> Optional[float]:
    """Busy device ms a window of the ops launched under ``span`` (its own,
    not its children's); None without windows, device ops or the span."""
    n = windows(tl)
    if not n or not tl.device or all(s[0] != span for s in tl.program):
        return None
    ops = [d for d, s in zip(tl.device, tl.span_of) if s == span]
    return 1e-6 * sum(b - a for a, b in trace.union(ops)) / n


def host_ms(tl, prefix: str) -> Optional[float]:
    """Summed ms a window of the program's spans whose names start with
    ``prefix``; None without windows or such spans."""
    n = windows(tl)
    spent = [b - a for name, a, b in getattr(tl, "program", ())
             if name.startswith(prefix)]
    return 1e-6 * sum(spent) / n if n and spent else None


def device_ms_by_span(tl) -> Dict[str, float]:
    """Busy device ms a window by the span that launched each op
    (``none``: no span did)."""
    n = windows(tl)
    by: Dict[str, list] = {}
    for d, s in zip(tl.device, tl.span_of):
        by.setdefault(s or "none", []).append(d)
    return {s: 1e-6 * sum(b - a for a, b in trace.union(ops)) / n
            for s, ops in by.items()} if n else {}


READERS: Dict[str, Callable] = {
    "merge.device_ms": lambda tl: device_ms(tl, MERGE),
    "writes.device_ms": lambda tl: device_ms(tl, WRITES),
    "ranges.device_ms": lambda tl: device_ms(tl, RANGES),
    "coalesce_ms": lambda tl: host_ms(tl, COALESCE),
    "host_wait_ms": lambda tl: host_ms(tl, WAIT),
}


def idle_by_span(tl) -> Dict[str, float]:
    """Idle device seconds by span: each gap of ``trace.idle_gaps`` goes to
    the innermost span name, the program's or the harness's
    (``pibench.<kind>``), whose spans cover at least half of it
    (``clients`` where none does), as ``trace.idle_by_host`` gives it to
    the harness's kind.  The spans nest, on one host thread: the
    innermost of those names covers the least, and is the deepest where
    two cover alike."""
    spans = sorted([(trace.SPAN + k, a, b) for k, a, b in tl.host] +
                   list(getattr(tl, "program", ())),
                   key=lambda s: (s[1], -s[2]))
    depth, ends = [], []
    for _, a, b in spans:
        while ends and ends[-1] <= a:
            ends.pop()
        depth.append(len(ends))
        ends.append(b)
    out: Dict[str, float] = {}
    live: List[int] = []
    i = 0
    for a, b in trace.idle_gaps(tl):
        while i < len(spans) and spans[i][1] <= a:
            live.append(i)
            i += 1
        live = [k for k in live if spans[k][2] > a]
        j = i
        while j < len(spans) and spans[j][1] < b:
            j += 1
        cover: Dict[str, tuple] = {}
        for k in live + list(range(i, j)):
            name, sa, sb = spans[k]
            o = min(b, sb) - max(a, sa)
            c, d = cover.get(name, (0, 0))
            cover[name] = (c + o, max(d, depth[k]))
        held = [(c, -d, name) for name, (c, d) in cover.items()
                if 2 * c >= b - a]
        label = min(held)[2] if held else "clients"
        out[label] = out.get(label, 0.0) + (b - a) * 1e-9
    return out


def traced_run(cell, seed: int, seconds: float, device: str, started: float,
               switch: Optional[Callable[[bool], None]] = None):
    """A traced ``harness.run_cell`` whose timeline is this module's →
    (result, ProgramTimeline), with ``idle_by_span`` in the result's
    ``breakdown``.  ``switch`` (the program's ``tracing.enable``) turns
    the program's spans on around ``drive`` and off after it; without it
    they stay off, for the same run's cost.  The harness itself neither
    turns them on nor reads this timeline (PERF.md, section 7): this run
    puts both in place of its own for the call."""
    real_drive = harness.drive
    got = []

    def from_profiler(prof):
        got.append(timeline(events(prof)))
        return got[-1]

    def drive(*args, **kw):
        switch(True)
        try:
            return real_drive(*args, **kw)
        finally:
            switch(False)

    with ExitStack() as stack:
        stack.enter_context(mock.patch.object(trace, "from_profiler",
                                              from_profiler))
        if switch is not None:
            stack.enter_context(mock.patch.object(harness, "drive", drive))
        out = harness.run_cell(cell, seed, seconds, True, device, started)
    tl = got[-1] if got else None
    if tl is not None:
        out.setdefault("breakdown", {})["idle_by_span"] = \
            trace.top(idle_by_span(tl), 20)
    return out, tl
