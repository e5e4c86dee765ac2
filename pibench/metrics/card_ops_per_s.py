"""The card's rate: the ops of the windows dispatched between the two marks
that open and close the measured window on the device's timeline, over
the seconds in which a device op ran between the marks (the device trace;
overlapping ops once).  What the card sustains on this mix: the card time
each op costs, whatever the host's speed."""
from pibench import trace


def read(run):
    tl = run.card
    if tl is None or not tl.device or run.marks is None:
        return None
    lo, hi = run.marks
    ops = sum(len(w.qids) for w, t in run.submitted if lo <= t <= hi)
    return ops / (trace.busy_ns(tl) * 1e-9)
