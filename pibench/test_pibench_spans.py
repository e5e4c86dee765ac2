"""The program's spans as the benchmark reads them (``pibench/spans.py``):
annotations kept out of the device ops, device ops tied to the span that
launched them, the five per-window readings and idle time by span, on
hand-made events; then a small traced run on the CPU."""
import math

import pytest

from pibench import spans, trace
from pibench.smallcells import small_cell
from pibench.spans import Event, ProgramTimeline
from repro_torch import tracing

MS = 1_000_000


def host(name, a, b, corr=0, annotation=True):
    return Event(name, False, a * MS, b * MS, corr, annotation)


def dev(name, a, b, corr=0, annotation=False):
    return Event(name, True, a * MS, b * MS, corr, annotation)


def _kernels():
    """The harness's window, a few kernels and their launches."""
    return [host(trace.WINDOW, 0, 100),
            dev("sort_kernel", 10, 20, corr=501),
            dev("copy_kernel", 30, 45, corr=502),
            dev("scatter_kernel", 40, 60, corr=503),
            host("cudaLaunchKernel", 5, 6, corr=501, annotation=False),
            host("cudaMemcpyAsync", 6, 7, corr=502, annotation=False),
            host("cudaLaunchKernel", 7, 8, corr=503, annotation=False)]


def _annotations():
    """What the profiler adds for the spans: host ranges and their
    device-side annotations, the harness's and the program's."""
    return [host("pibench.submit", 4, 9), host("pi.submit", 4, 9),
            host("pi.execute.sort", 5, 6), dev("pi.submit", 10, 60),
            dev("pi.execute.sort", 10, 20, annotation=True),
            dev("pibench.submit", 10, 60)]


def test_annotations_leave_busy_idle_and_marks_alone():
    plain = spans.timeline(_kernels())
    annotated = spans.timeline(_kernels() + _annotations())
    assert annotated.device == plain.device
    assert trace.busy_ns(annotated) == trace.busy_ns(plain) == 40 * MS
    assert trace.idle_pct(annotated) == trace.idle_pct(plain) == 60.0
    marks = [dev(trace.MARK, 1, 2), dev(trace.MARK, 95, 96)]
    marked = trace.between_marks(spans.timeline(_kernels() + marks).device)
    assert trace.between_marks(spans.timeline(
        _kernels() + marks + _annotations()).device) == marked
    assert trace.busy_ns(marked) == 40 * MS


def test_device_ops_land_in_the_innermost_span_that_launched_them():
    """Launched inside nested spans, run later under other spans: each op
    goes to the innermost span open at its launch."""
    evs = [host("pi.submit", 4, 9), host("pi.execute.merge", 6.5, 7.5),
           host("pi.admit", 9, 70), host("pi.admit.coalesce", 10, 65)]
    tl = spans.timeline(_kernels() + evs)
    assert tl.span_of == ["pi.submit", "pi.submit", "pi.execute.merge"]
    assert tl.by_annotation == 0
    # a launch under no span maps to none
    tl = spans.timeline(_kernels())
    assert tl.span_of == [None, None, None]


def test_without_launches_ops_fall_back_to_the_annotations():
    evs = [e for e in _kernels() if e.name[:2] != "cu"] + [
        dev("pi.submit", 9, 61, annotation=True),
        dev("pi.execute.merge", 29, 46, annotation=True)]
    tl = spans.timeline(evs)
    assert tl.span_of == ["pi.submit", "pi.execute.merge",
                          "pi.execute.merge"]
    assert tl.by_annotation == 3


def _hand_made():
    """Two windows: 3 ms of merge ops, 2 of writes ops of which 0.5 ms
    overlap, coalescing 4 ms, waits 6 ms."""
    program = [("pi.submit", 0, 10), ("pi.execute.writes", 1.5, 2),
               ("pi.execute.merge", 2, 3), ("pi.wait.rebuild_check", 3, 5),
               ("pi.submit", 20, 30), ("pi.execute.writes", 21.5, 22),
               ("pi.execute.merge", 22, 23), ("pi.retire", 24, 29),
               ("pi.wait.retire", 24, 28), ("pi.admit", 30, 40),
               ("pi.admit.coalesce", 31, 33), ("pi.admit.coalesce", 34, 36)]
    device = [("merge_a", 2, 4), ("writes_a", 4, 5), ("writes_b", 4.5, 5.5),
              ("probe", 10, 12), ("k", 18, 20), ("merge_b", 22, 23),
              ("k", 23, 24), ("k", 29, 30)]
    span_of = ["pi.execute.merge", "pi.execute.writes", "pi.execute.writes",
               None, None, "pi.execute.merge", None, None]
    return ProgramTimeline(
        (0, 40 * MS), [(n, a * MS, b * MS) for n, a, b in device],
        [("submit", 0, 10 * MS), ("submit", 20 * MS, 30 * MS),
         ("admit", 30 * MS, 40 * MS)],
        program=[(n, a * MS, b * MS) for n, a, b in program],
        span_of=span_of)


@pytest.mark.parametrize("metric,want", [
    ("merge.device_ms", 1.5), ("writes.device_ms", 0.75),
    ("ranges.device_ms", None), ("coalesce_ms", 2.0),
    ("host_wait_ms", 3.0)])
def test_the_readers_on_a_hand_made_timeline(metric, want):
    got = spans.READERS[metric](_hand_made())
    assert got == pytest.approx(want) if want is not None else got is None
    # no program span at all: nothing to read
    bare = trace.Timeline((0, 40 * MS), [("k", 0, MS)], [])
    assert spans.READERS[metric](bare) is None
    assert spans.READERS[metric](None) is None


def test_idle_by_span_goes_to_the_innermost_and_sums_to_idle_gaps():
    tl = _hand_made()
    by_span = spans.idle_by_span(tl)
    assert sum(by_span.values()) == pytest.approx(
        sum(trace.idle_by_host(tl).values()))
    assert sum(by_span.values()) == pytest.approx(
        sum(b - a for a, b in trace.idle_gaps(tl)) * 1e-9)
    got = {k: round(v * 1e3, 6) for k, v in by_span.items()}
    # 0-2, 5.5-10 and 20-22: pi.submit, the deeper of it and
    # pibench.submit (the writes cover under half of 0-2 and 20-22);
    # 12-18 under no span; 24-29: the wait inside pi.retire covers 4 of
    # it; 30-40: two coalescing spans cover 4 of 10, so pi.admit's
    assert got == {"pi.submit": 8.5, "clients": 6.0,
                   "pi.wait.retire": 5.0, "pi.admit": 10.0}


@pytest.fixture
def small_e():
    return small_cell("pi1.ycsb-e")


def test_a_small_traced_run_reads_the_host_spans(small_e):
    try:
        out, tl = spans.traced_run(small_e, 2 ** 31 + 11, 0.3, "cpu", 0.0,
                                   switch=tracing.enable)
    finally:
        tracing.enable(False)
    assert out["correct"], out["checks"]
    assert tracing.span(tracing.SUBMIT) is tracing.span(tracing.ADMIT)
    assert spans.windows(tl) > 0
    coalesce = spans.READERS["coalesce_ms"](tl)
    wait = spans.READERS["host_wait_ms"](tl)
    assert 0 < coalesce <= out["metrics"]["admit_ms"]["value"]
    assert 0 < wait <= out["metrics"]["submit_ms"]["value"]
    # the CPU has no device ops to tie
    assert spans.READERS["merge.device_ms"](tl) is None
    idle = out["breakdown"]["idle_by_span"]
    assert math.isclose(sum(v for _, v in idle),
                        sum(v for _, v in out["breakdown"]["idle_gaps"]))
    # the same run with the spans off reads none of them
    out, tl = spans.traced_run(small_e, 2 ** 31 + 11, 0.3, "cpu", 0.0)
    assert out["correct"] and tl.program == []
    assert spans.READERS["coalesce_ms"](tl) is None
