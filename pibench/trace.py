"""Reading the profiler's timeline: device busy and idle time, kernel time
by name, and what the host was doing while the device sat idle.

The harness marks its own host spans with ``torch.profiler``'s
``record_function`` under names that start with ``SPAN`` (the traced
window, each admission call, each dispatch call), so the device's
kernels and the host's spans share one clock.  A run that traces the
device alone has no host spans: the harness marks the measured window on
the device's own timeline instead, with a spin kernel at its start and
one at its end (``mark``).  Everything else here works on plain
``(name, start_ns, end_ns)`` tuples.
"""
from __future__ import annotations

import bisect
import dataclasses
from typing import Dict, List, Optional, Tuple

SPAN = "pibench."
WINDOW = SPAN + "window"
MARK = "spin_kernel"         # torch.cuda._sleep's kernel; the program has none
MARK_CYCLES = 1000

Interval = Tuple[str, int, int]


@dataclasses.dataclass
class Timeline:
    window: Tuple[int, int]          # the traced window, ns
    device: List[Interval]           # device ops, clipped to the window
    host: List[Interval]             # the harness's host spans in it

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-9


def clip(intervals, lo: int, hi: int) -> List[Interval]:
    out = []
    for name, a, b in intervals:
        a, b = max(a, lo), min(b, hi)
        if b > a:
            out.append((name, a, b))
    return out


def union(intervals) -> List[Tuple[int, int]]:
    """The union of intervals, as sorted disjoint (start, end) pairs."""
    merged: List[List[int]] = []
    for _, a, b in sorted(intervals, key=lambda x: x[1]):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def busy_ns(tl: Timeline) -> int:
    """Time in which at least one device op ran: overlapping ops once."""
    return sum(b - a for a, b in union(tl.device))


def idle_gaps(tl: Timeline) -> List[Tuple[int, int]]:
    """The window's stretches with no device op running."""
    gaps, t = [], tl.window[0]
    for a, b in union(tl.device):
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if tl.window[1] > t:
        gaps.append((t, tl.window[1]))
    return gaps


def idle_pct(tl: Timeline) -> float:
    return 100.0 * (1.0 - busy_ns(tl) / (tl.window[1] - tl.window[0]))


def idle_by_host(tl: Timeline) -> Dict[str, float]:
    """Idle device seconds by the host span that covers most of each gap
    (``clients`` where none covers half of it: the harness answering and
    issuing).  The host spans come from one thread, so they are disjoint;
    each gap looks only at the spans that can reach it."""
    host = sorted(tl.host, key=lambda x: x[1])
    starts = [a for _, a, _ in host]
    out: Dict[str, float] = {}
    for a, b in idle_gaps(tl):
        cover: Dict[str, int] = {}
        i = max(0, bisect.bisect_right(starts, a) - 1)
        while i < len(host) and host[i][1] < b:
            name, ha, hb = host[i]
            o = min(b, hb) - max(a, ha)
            if o > 0:
                cover[name] = cover.get(name, 0) + o
            i += 1
        label = max(cover, key=cover.get) if cover and \
            max(cover.values()) * 2 >= b - a else "clients"
        out[label] = out.get(label, 0.0) + (b - a) * 1e-9
    return out


def device_time(tl: Timeline, part: str = "") -> Dict[str, float]:
    """Device seconds by op name, for ops whose name holds ``part``."""
    out: Dict[str, float] = {}
    for name, a, b in tl.device:
        if part in name:
            out[name] = out.get(name, 0.0) + (b - a) * 1e-9
    return out


def top(d: Dict[str, float], n: int = 10, width: int = 160):
    return [[k[:width], v] for k, v in
            sorted(d.items(), key=lambda kv: -kv[1])[:n]]


def mark():
    """A mark on the device's timeline, behind the work launched so far."""
    import torch
    torch.cuda._sleep(MARK_CYCLES)


def between_marks(device: List[Interval]) -> Optional[Timeline]:
    """The device ops between the end of the first mark and the start of
    the last one, or None without two marks."""
    marks = sorted((a, b) for name, a, b in device if MARK in name)
    if len(marks) < 2:
        return None
    lo, hi = marks[0][1], marks[-1][0]
    return Timeline((lo, hi), clip([d for d in device if MARK not in d[0]],
                                   lo, hi), [])


def device_ops(prof) -> List[Interval]:
    """Every device op of a finished ``torch.profiler.profile``."""
    return [(e.name(), e.start_ns(), e.end_ns())
            for e in prof.profiler.kineto_results.events()
            if str(e.device_type()).endswith("CUDA")]


def from_profiler(prof) -> Optional[Timeline]:
    """The timeline of a finished ``torch.profiler.profile``, or None when
    it holds no traced window."""
    window = None
    device, host = [], []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        a, b = e.start_ns(), e.end_ns()
        if str(e.device_type()).endswith("CUDA"):
            if not name.startswith(SPAN):
                device.append((name, a, b))
        elif name == WINDOW:
            window = (a, b)
        elif name.startswith(SPAN):
            host.append((name[len(SPAN):], a, b))
    if window is None:
        return None
    return Timeline(window, clip(device, *window), clip(host, *window))
