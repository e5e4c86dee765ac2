"""Dispatch and the window step: the host clock around
``Dispatcher.submit`` and the retirement it returns (ranges, the execute,
the rebuild when due, the sharded routing), per window submitted in the
window."""


def read(run):
    spent = sum(b - a for kind, a, b in run.spans
                if kind == "submit" and run.in_window(a))
    n = sum(1 for _, t in run.submitted if run.in_window(t))
    return 1e3 * spent / n if n else None
