"""Spans of the served path: the phases of admission, dispatch and the
window step, marked on ``torch.profiler``'s timeline.  Off by default.

``span(name)`` is a ``torch.profiler.record_function`` range named
``"pi." + name`` while the switch is on (``enable(True)``), and one shared
no-op context while it is off, so a run that does not trace pays a global
read a span.  There is no exporter and no buffer: a profiler running in
the process keeps the ranges in memory and hands them over when it stops.

The names are the closed set below.  A span's parent is the span that
encloses it on the host thread; the window it serves is fixed by its order
among the ``submit`` spans, except ``retire`` (and the wait inside it),
which serves the window retired: ``Dispatcher.depth`` windows behind.
A span launches no kernel and reads no device value; the device ops a
profiler records are tied to the span open when their launch was issued.
"""
from __future__ import annotations

import contextlib

import torch

PREFIX = "pi."

# admission (pipeline/collector.py)
ADMIT = "admit"                      # Collector.offer_many, Collector.take
ADMIT_COALESCE = "admit.coalesce"    # point and RANGE coalescing of a chunk
ADMIT_SEAL = "admit.seal"            # building the sealed Window
# dispatch and the window step (pipeline/dispatcher.py, core/index.py)
SUBMIT = "submit"                    # Dispatcher.submit: one a window
SUBMIT_RANGES = "submit.ranges"      # range_tables and pi_range
EXECUTE_SORT = "execute.sort"        # the query sort and segment scan
EXECUTE_PROBE = "execute.probe"      # the probe and the per-query results
EXECUTE_WRITES = "execute.writes"    # net effects over C and PC slots
EXECUTE_MERGE = "execute.merge"      # the pending merge
WAIT_REBUILD_CHECK = "wait.rebuild_check"  # the host blocked on due
RETIRE = "retire"                    # Dispatcher._retire
WAIT_RETIRE = "wait.retire"          # the host blocked on a window's reads

NAMES = (ADMIT, ADMIT_COALESCE, ADMIT_SEAL, SUBMIT, SUBMIT_RANGES,
         EXECUTE_SORT, EXECUTE_PROBE, EXECUTE_WRITES, EXECUTE_MERGE,
         WAIT_REBUILD_CHECK, RETIRE, WAIT_RETIRE)

_OFF = contextlib.nullcontext()
_on = False


def enable(on: bool) -> None:
    """Switch the spans on or off for the whole process."""
    global _on
    _on = bool(on)


def span(name: str):
    """A context that marks ``name`` (one of ``NAMES``) while tracing is
    on; the one shared no-op context while it is off."""
    if _on:
        return torch.profiler.record_function(PREFIX + name)
    return _OFF
