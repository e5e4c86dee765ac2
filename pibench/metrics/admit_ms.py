"""Admission: the host clock around ``Collector.offer_many`` (and the seal
of a window the clients left open), summed over the window, per window
sealed in it."""


def read(run):
    spent = sum(b - a for kind, a, b in run.spans
                if kind == "admit" and run.in_window(a))
    n = sum(1 for _, t in run.submitted if run.in_window(t))
    return 1e3 * spent / n if n else None
