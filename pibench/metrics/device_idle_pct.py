"""The share of the traced window in which no device op runs: the union of
the op intervals on the profiler's timeline, overlapping ops once."""
from pibench import trace


def read(run):
    tl = run.timeline
    if tl is None or not tl.device:
        return None
    return trace.idle_pct(tl)
