"""The port's serving path for one shard against the JAX package.

Arrival streams, collector windows (``offer`` and ``offer_many``, with
ranges), and whole runs through ``Dispatcher.run`` — per-arrival point
and range results, the metrics and the final state leaves — must equal
the JAX package's, bit for bit, under all four arrival processes and
across rebuilds.  Plus the port's own contracts: depth changes no result,
ranges see the pre-window state, ``submit`` leaves its input index
untouched, one range launch per range-bearing window, and a lost insert
poisons the dispatcher.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from repro import data as jdata
from repro.core import index as jpi
from repro import pipeline as jpipe
from repro_torch import data as tdata
from repro_torch.core import index as tpi
from repro_torch.core import engine as tengine
from repro_torch.core.batch import INSERT, RANGE, SEARCH
from repro_torch import pipeline as tpipe
from torch_parity import assert_same_state, configs

YCSB = dict(n_keys=300, key_space=1 << 16, write_ratio=0.5, theta=0.9,
            seed=4)
GEOMETRY = dict(capacity=1024, pending_capacity=64, fanout=4, seg_width=16,
                tile_q=32)


def _arrival_cfg(pkg, process, n=600, seed=1):
    return pkg.ArrivalConfig(process=process, rate=1e5, n_arrivals=n,
                             range_frac=0.3, span_min=1, span_max=2000,
                             hot_keys=6, seed=seed)


def _streams(process, n=600):
    """The same stream from both packages, and the dataset's keys/vals."""
    keys, vals = tdata.ycsb_dataset(tdata.YCSBConfig(**YCSB))
    ts = tpipe.make_arrivals(_arrival_cfg(tpipe, process, n),
                             tdata.YCSBConfig(**YCSB), keys)
    js = jpipe.make_arrivals(_arrival_cfg(jpipe, process, n),
                             jdata.YCSBConfig(**YCSB), keys)
    return ts, js, keys, vals


def _window_fields(w):
    return (w.ops, w.keys, w.keys2, w.vals, w.occupancy, list(w.qids),
            w.slots, w.t_open, w.t_enq, w.trigger)


def _results(retired):
    points, ranges = {}, {}
    for res in retired:
        points.update(res.per_arrival())
        ranges.update(res.per_arrival_ranges())
    return points, ranges


@pytest.mark.parametrize("process", ["poisson", "bursty", "diurnal",
                                     "hotkey"])
def test_arrival_streams_match_jax(process):
    ts, js, _, _ = _streams(process)
    assert np.count_nonzero(ts.ops == RANGE) > 100
    for name in ("t", "ops", "keys", "vals", "keys2"):
        a, b = getattr(ts, name), getattr(js, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("bulk", [False, True])
@pytest.mark.parametrize("deadline", [float("inf"), 2e-4])
def test_collector_windows_match_jax(bulk, deadline):
    """Sealed windows equal the JAX collector's, array for array, with
    RANGE coalescing, size and deadline seals."""
    ts, _, _, _ = _streams("hotkey")
    # one span for every scan, so that hot scan starts repeat exact pairs
    ts.keys2 = np.where(ts.ops == RANGE, ts.keys + 100, 0).astype(np.int32)
    n = len(ts)
    windows = []
    for pkg in (tpipe, jpipe):
        col = pkg.Collector(pkg.WindowConfig(batch=32, deadline=deadline))
        out = []
        if bulk:
            for s in range(0, n, 50):
                out += col.offer_many(ts.t[s:s + 50], ts.ops[s:s + 50],
                                      ts.keys[s:s + 50], ts.vals[s:s + 50],
                                      np.arange(s, min(n, s + 50)),
                                      ts.keys2[s:s + 50])[1]
        else:
            for i in range(n):
                while not col.offer(float(ts.t[i]), int(ts.ops[i]),
                                    int(ts.keys[i]), int(ts.vals[i]), i,
                                    key2=int(ts.keys2[i])):
                    out.append(col.take(float(ts.t[i])))
        out.append(col.take(float(ts.t[-1])))
        windows.append(out)
    assert len(windows[0]) == len(windows[1]) > 10
    assert any(w.trigger == "deadline" for w in windows[0]) == \
        (deadline < 1)
    for k, (a, b) in enumerate(zip(*windows)):
        for x, y in zip(_window_fields(a), _window_fields(b)):
            np.testing.assert_array_equal(x, y, err_msg=f"window {k}")
    hits = sum(int(np.count_nonzero(w.ops[w.slots] == RANGE))
               - int(np.count_nonzero(w.ops[:w.occupancy] == RANGE))
               for w in windows[0])
    assert hits > 0, "no RANGE arrival shared a slot"


def _run_port(process, backend, depth, ts, keys, vals, wcfg):
    _, tcfg = configs(backend="xla", **GEOMETRY)
    tcfg = dataclasses.replace(tcfg, backend=backend)
    idx = tpi.build(tcfg, keys, vals, device="cpu")
    met = tpipe.PipelineMetrics()
    disp = tpipe.Dispatcher(idx, depth=depth, max_span=4096, metrics=met,
                            clock=lambda: 0.0)
    retired = disp.run(ts, wcfg)
    return disp, met, retired


@pytest.mark.parametrize("process", ["poisson", "bursty", "diurnal",
                                     "hotkey"])
def test_dispatcher_run_matches_jax(process):
    """Per-arrival point and range results, the metrics and the final
    state equal the JAX dispatcher's (``xla``), for both port backends,
    across rebuilds."""
    ts, js, keys, vals = _streams(process)
    jcfg, _ = configs(backend="xla", **GEOMETRY)
    jdisp = jpipe.Dispatcher(jpi.build(jcfg, jnp.asarray(keys),
                                       jnp.asarray(vals)),
                             depth=1, max_span=4096,
                             metrics=jpipe.PipelineMetrics(),
                             clock=lambda: 0.0)
    jwin = jpipe.WindowConfig(batch=32, deadline=2e-4)
    want = _results(jdisp.run(js, jwin))
    for backend in ("cuda", "torch"):
        disp, met, retired = _run_port(
            process, backend, 1, ts, keys, vals,
            tpipe.WindowConfig(batch=32, deadline=2e-4))
        assert met.n_rebuilds >= 1, "no rebuild inside the run"
        got = _results(retired)
        assert got[0] == want[0], f"{backend}: point results"
        assert got[1] == want[1], f"{backend}: range results"
        assert len(got[0]) + len(got[1]) == len(ts)
        assert_same_state(jdisp.index, disp.index, backend)
        np.testing.assert_equal(met.summary(), jdisp.metrics.summary())


def test_depth_is_semantics_free():
    ts, _, keys, vals = _streams("bursty")
    wcfg = tpipe.WindowConfig(batch=32)
    runs = [_run_port("bursty", "cuda", d, ts, keys, vals, wcfg)
            for d in (0, 1, 2)]
    base = _results(runs[0][2])
    for disp, met, retired in runs[1:]:
        assert _results(retired) == base
        for a, b in zip(tpi.to_numpy_leaves(disp.index),
                        tpi.to_numpy_leaves(runs[0][0].index)):
            np.testing.assert_equal(a, b)
    assert runs[0][1].n_rebuilds >= 1


def test_range_launches_once_per_range_bearing_window(monkeypatch):
    """The engine's range call (one ``pi_range`` launch on the card) runs
    once for each window that holds a RANGE, and never for the others."""
    calls = []
    real = tengine.pi_range

    def counting(*args, **kw):
        calls.append(args[-2].shape[0])
        return real(*args, **kw)

    monkeypatch.setattr(tengine, "pi_range", counting)
    ts, _, keys, vals = _streams("poisson")
    ts.ops[:64] = SEARCH     # the first two windows hold no RANGE
    _, _, retired = _run_port("poisson", "cuda", 1, ts, keys, vals,
                              tpipe.WindowConfig(batch=32, coalesce=False))
    with_ranges = [r for r in retired if r.rcnt is not None]
    assert len(calls) == len(with_ranges) == len(retired) - 2
    assert all((r.window.ops == RANGE).any() for r in with_ranges)
    assert set(calls) == {32}


def _submit(disp, ops, keys, keys2, vals, t):
    col = tpipe.Collector(tpipe.WindowConfig(batch=8))
    n = len(ops)
    _, sealed = col.offer_many(np.full(n, t), np.array(ops, np.int32),
                               np.array(keys, np.int32),
                               np.array(vals, np.int32), np.arange(n),
                               keys2=np.array(keys2, np.int32))
    assert not sealed
    (res,) = disp.submit(col.take(t))
    return res


@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_pre_window_semantics_writes_in_same_window_invisible(backend):
    """A RANGE sealed into the same window as a covering INSERT does not
    see it; the next window does."""
    cfg = tpi.PIConfig(capacity=256, pending_capacity=32, fanout=4,
                       seg_width=16, backend=backend)
    idx = tpi.build(cfg, np.array([10, 20], np.int32),
                    np.array([1, 2], np.int32), device="cpu")
    disp = tpipe.Dispatcher(idx, depth=0, max_span=256)
    res = _submit(disp, [INSERT, RANGE], [15, 0], [0, 100], [7, 0], 0.0)
    assert res.per_arrival_ranges()[1] == (2, 3)   # {10: 1, 20: 2}
    res = _submit(disp, [RANGE], [0], [100], [0], 1.0)
    assert res.per_arrival_ranges()[0] == (3, 10)


def test_submit_leaves_the_pre_window_index_bit_identical():
    ts, _, keys, vals = _streams("poisson", n=64)
    _, tcfg = configs(backend="xla", **GEOMETRY)
    idx = tpi.build(dataclasses.replace(tcfg, backend="cuda"), keys, vals,
                    device="cpu")
    disp = tpipe.Dispatcher(idx, depth=1, max_span=64)
    col = tpipe.Collector(tpipe.WindowConfig(batch=32))
    _, sealed = col.offer_many(ts.t, ts.ops, ts.keys, ts.vals,
                               np.arange(64), ts.keys2)
    def leaves(index):
        return [np.array(x, copy=True) for leaf in tpi.to_numpy_leaves(index)
                for x in (leaf if isinstance(leaf, tuple) else (leaf,))]

    for w in sealed + [col.take()]:
        pre = disp.index
        before = leaves(pre)
        disp.submit(w)
        assert disp.index is not pre
        after = leaves(pre)
        assert len(before) == len(after) == 10 + len(pre.levels)
        for a, b in zip(before, after):
            np.testing.assert_array_equal(a, b)
    assert len(disp.flush()) == 1


def test_dispatcher_refuses_unported_tiers():
    """The sharded path is refused (ROADMAP A9); the overload breaker is
    ported and its config accepted."""
    idx = tpi.build(tpi.PIConfig(capacity=64, pending_capacity=8),
                    np.arange(4, dtype=np.int32),
                    np.arange(4, dtype=np.int32), device="cpu")
    with pytest.raises(NotImplementedError, match="A9"):
        tpipe.Dispatcher(idx, mesh=object())
    with pytest.raises(NotImplementedError, match="A9"):
        tpipe.Dispatcher(object())
    disp = tpipe.Dispatcher(idx, overload=tpipe.OverloadConfig())
    assert disp.breaker_state == tpipe.BREAKER_CLOSED


def _overflowing_window():
    """Pending capacity 8 and one window of 32 distinct net inserts."""
    cfg = tpi.PIConfig(capacity=64, pending_capacity=8, fanout=4)
    idx = tpi.empty(cfg, device="cpu")
    col = tpipe.Collector(tpipe.WindowConfig(batch=32))
    for i in range(32):
        assert col.offer(float(i), INSERT, 100 + i, i, i)
    return idx, col.take()


def test_failed_retirement_poisons_dispatcher():
    idx, window = _overflowing_window()
    (res,) = tpipe.Dispatcher(idx, depth=0, check_overflow=False) \
        .submit(window)
    assert res.found.shape == (32,)
    disp = tpipe.Dispatcher(idx, depth=2)
    assert disp.submit(window) == []
    col = tpipe.Collector(tpipe.WindowConfig(batch=32))
    assert col.offer(0.0, SEARCH, 5, 0, 0)
    second = col.take()
    assert disp.submit(second) == []
    with pytest.raises(tpipe.PendingOverflowError) as exc:
        disp.flush()
    assert exc.value.windows == [window, second]
    assert disp.poisoned is exc.value
    with pytest.raises(tpipe.PendingOverflowError):
        disp.submit(second)
    with pytest.raises(tpipe.PendingOverflowError):
        disp.flush()


def test_window_predicates_match_jax():
    """Which windows hold writes and ranges, and their point views, as the
    JAX dispatcher sees them."""
    ts, js, keys, vals = _streams("poisson", n=200)
    jcfg, tcfg = configs(backend="xla", **GEOMETRY)
    disps = (tpipe.Dispatcher(tpi.build(tcfg, keys, vals, device="cpu")),
             jpipe.Dispatcher(jpi.build(jcfg, jnp.asarray(keys),
                                        jnp.asarray(vals))))
    seen = []
    for pkg, s, disp in zip((tpipe, jpipe), (ts, js), disps):
        s.ops[:40] = np.where(s.ops[:40] == RANGE, SEARCH, s.ops[:40])
        s.ops[40:80] = RANGE
        s.keys2[40:80] = s.keys[40:80] + 10
        col = pkg.Collector(pkg.WindowConfig(batch=16))
        sealed = col.offer_many(s.t, s.ops, s.keys, s.vals, np.arange(200),
                                s.keys2)[1]
        seen.append([(disp._window_has_writes(w), disp._window_has_ranges(w),
                      *disp._point_view(w)) for w in sealed])
    assert len(seen[0]) == len(seen[1]) > 5
    for a, b in zip(*seen):
        assert a[:2] == b[:2]
        np.testing.assert_array_equal(a[2], b[2])
        np.testing.assert_array_equal(a[3], b[3])
    preds = [x[:2] for x in seen[0]]
    assert (True, False) in preds and (False, True) in preds
