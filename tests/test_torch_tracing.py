"""The port's spans (``repro_torch.tracing``) on the CPU: off, a served run
records none of them and every span is one shared no-op; on, every span
of the table a stream reaches is recorded once a window under its parent;
either way the results are the same, bit for bit."""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import data as tdata
from repro_torch import pipeline as tpipe
from repro_torch import tracing
from repro_torch.core import index as tpi
from repro_torch.core.batch import RANGE

YCSB = dict(n_keys=300, key_space=1 << 16, write_ratio=0.5, theta=0.9,
            seed=4)
P = tracing.PREFIX


@pytest.fixture
def switch():
    """``tracing.enable``, switched off again whatever the test did."""
    try:
        yield tracing.enable
    finally:
        tracing.enable(False)


def _run(range_frac: float, backend: str = "cuda", depth: int = 1):
    keys, vals = tdata.ycsb_dataset(tdata.YCSBConfig(**YCSB))
    stream = tpipe.make_arrivals(
        tpipe.ArrivalConfig(process="hotkey", rate=1e5, n_arrivals=600,
                            range_frac=range_frac, span_min=1, span_max=2000,
                            hot_keys=6, seed=1),
        tdata.YCSBConfig(**YCSB), keys)
    cfg = tpi.PIConfig(capacity=1024, pending_capacity=64, fanout=4,
                       seg_width=16, backend=backend)
    disp = tpipe.Dispatcher(tpi.build(cfg, keys, vals, device="cpu"),
                            depth=depth, max_span=4096, clock=lambda: 0.0)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        retired = disp.run(stream, tpipe.WindowConfig(batch=32,
                                                      deadline=2e-4))
    spans = sorted(((e.name(), e.start_ns(), e.end_ns())
                    for e in prof.profiler.kineto_results.events()
                    if e.name().startswith(P)),
                   key=lambda s: (s[1], -s[2]))
    return disp, retired, spans


def _parents(spans):
    """Each span's innermost enclosing span on the (one) host thread."""
    out, stack = [], []
    for name, a, b in spans:
        while stack and stack[-1][2] < b:
            stack.pop()
        out.append((name, stack[-1][0] if stack else None))
        stack.append((name, a, b))
    return out


def test_off_records_nothing_and_shares_one_noop():
    assert len({id(tracing.span(n)) for n in tracing.NAMES}) == 1
    _, retired, spans = _run(0.3)
    assert retired and spans == []


@pytest.mark.parametrize("range_frac", [0.0, 0.3])
def test_on_records_each_span_once_a_window_under_its_parent(switch,
                                                             range_frac):
    switch(True)
    depth = 1
    _, retired, spans = _run(range_frac, depth=depth)
    n = len(retired)
    ranged = sum(bool((r.window.ops == RANGE).any()) for r in retired)
    assert (ranged > 0) == (range_frac > 0)
    assert {s[0] for s in spans} <= {P + k for k in tracing.NAMES}
    counts = {}
    for name, parent in _parents(spans):
        counts[name, parent] = counts.get((name, parent), 0) + 1
    once = {
        (P + tracing.SUBMIT, None): n,
        (P + tracing.EXECUTE_SORT, P + tracing.SUBMIT): n,
        (P + tracing.EXECUTE_PROBE, P + tracing.SUBMIT): n,
        (P + tracing.EXECUTE_WRITES, P + tracing.SUBMIT): n,
        (P + tracing.EXECUTE_MERGE, P + tracing.SUBMIT): n,
        (P + tracing.WAIT_REBUILD_CHECK, P + tracing.SUBMIT): n,
        # the last ``depth`` windows retire in flush, outside any submit
        (P + tracing.RETIRE, P + tracing.SUBMIT): n - depth,
        (P + tracing.RETIRE, None): depth,
        (P + tracing.WAIT_RETIRE, P + tracing.RETIRE): n,
        (P + tracing.ADMIT_SEAL, P + tracing.ADMIT): n,
    }
    if ranged:
        once[P + tracing.SUBMIT_RANGES, P + tracing.SUBMIT] = ranged
    for key, want in once.items():
        assert counts.pop(key, 0) == want, key
    # one a call into admission: ``run`` offers 600 arrivals 32 at a time,
    # then takes the tail; coalescing runs once or more a window
    assert counts.pop((P + tracing.ADMIT, None)) == -(-600 // 32) + 1
    assert counts.pop((P + tracing.ADMIT_COALESCE, P + tracing.ADMIT)) >= n
    assert counts == {}


@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_results_are_the_same_on_and_off(switch, backend):
    runs = []
    for on in (False, True):
        switch(on)
        disp, retired, spans = _run(0.3, backend)
        assert bool(spans) == on
        runs.append((disp, retired))
    (d0, r0), (d1, r1) = runs
    assert len(r0) == len(r1)
    for a, b in zip(r0, r1):
        for name in ("found", "val", "rcnt", "rsum"):
            np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
        assert (a.rebuilt, a.pending_fill) == (b.rebuilt, b.pending_fill)
    for a, b in zip(tpi.flat_leaves(d0.index), tpi.flat_leaves(d1.index)):
        assert torch.equal(a, b)
