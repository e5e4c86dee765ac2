"""The port's overload control against the JAX package's, on the CPU.

* The breaker cases of ``tests/test_overload.py`` — recovery at 2x the
  pending capacity, the poisoning contract with the breaker off, the
  geometry error, escalation to read-only and its decay, ``reset_breaker``
  — each run the same windows through the JAX ``Dispatcher`` and the
  port's, with the same ``OverloadConfig`` and clock: the per-arrival
  results, the breaker's counters and state, the errors raised and every
  leaf of the final index must be equal, bit for bit.  ``recover`` with
  an ``overload`` config replays a durability directory behind the
  breaker.
* The shed, deadline and retry cases: the same stream through the JAX
  ``OverloadController`` and the port's, with the same config, retry
  policy and seed, must give equal ``RunReport``s (results, admission
  order, drops, retries, every retired window) and equal
  ``PipelineMetrics.summary()``s; the admitted subsequence replays
  exactly against ``RefIndex``.  The controllers' unit cases compare
  shed plans, pressures and deadline trajectories.
The port runs the ``torch`` backend here, the JAX package ``xla``; the
``cuda`` backend is held to the same results on its plain versions.
"""
import dataclasses
import itertools
import math
import os
import types

import jax.numpy as jnp
import numpy as np
import pytest

from repro import data as jdata
from repro import pipeline as jp
from repro.core import build as jbuild
from repro.pipeline import overload as jov
from repro_torch import pipeline as tp
from repro_torch.core import DELETE, INSERT, RANGE, SEARCH, RefIndex
from repro_torch.core import index as tpi
from repro_torch import data as tdata
from repro_torch.pipeline import overload as tov
from test_overload import check_admitted_against_oracle
from torch_parity import assert_same_state, configs, to_torch


def fresh_pair(pc=96, capacity=4096, key_space=1 << 20, n0=64, seed=1,
               backend="torch"):
    """The same seeded index in both packages (JAX ``xla``, the port on
    ``backend``), and its ``RefIndex``."""
    jcfg, tcfg = configs("xla", capacity=capacity, pending_capacity=pc,
                         fanout=4)
    rng = np.random.default_rng(seed)
    keys0 = np.unique(rng.integers(1, key_space, n0).astype(np.int32))
    vals0 = rng.integers(0, 1000, keys0.size).astype(np.int32)
    jidx = jbuild(jcfg, jnp.asarray(keys0), jnp.asarray(vals0))
    tidx = to_torch(jidx, tcfg)
    return jidx, tpi.with_backend(tidx, backend), RefIndex.build(keys0, vals0)


def insert_stream(n, start=2_000_000):
    """n distinct inserts above every seeded key: each nets a pending slot."""
    return types.SimpleNamespace(
        t=np.arange(n, dtype=np.float64),
        ops=np.full(n, INSERT, np.int32),
        keys=(start + np.arange(n)).astype(np.int32),
        vals=np.arange(n, dtype=np.int32))


def mk_window(pkg, triples, batch=16):
    """Seal a window of (op, key, val) triples with ``pkg``'s collector."""
    col = pkg.Collector(pkg.WindowConfig(batch=batch))
    for i, (op, k, v) in enumerate(triples):
        assert col.offer(i * 1e-6, op, k, v, i)
    return col.take()


def insert_windows(pkg, s, los, width):
    return [mk_window(pkg, [(INSERT, int(s.keys[i]), int(s.vals[i]))
                            for i in range(lo, lo + width)], batch=width)
            for lo in los]


def per_arrival(results):
    out = {}
    for r in results:
        out.update(r.per_arrival())
    return out


def assert_same_breaker(jd, td):
    assert (td.breaker_trips, td.breaker_recoveries, td.breaker_state) == \
        (jd.breaker_trips, jd.breaker_recoveries, jd.breaker_state)
    assert (td.poisoned is None) == (jd.poisoned is None)


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_breaker_recovers_2x_pending_capacity_bit_identical(backend):
    pc = 64
    stream = insert_stream(2 * pc + 32)
    jidx, tidx, _ = fresh_pair(pc=pc, n0=1024, backend=backend)
    ocfg = dict(max_recoveries=50)
    jm, tm = jp.PipelineMetrics(), tp.PipelineMetrics()
    jd = jp.Dispatcher(jidx, depth=1, metrics=jm,
                       overload=jp.OverloadConfig(**ocfg))
    td = tp.Dispatcher(tidx, depth=1, metrics=tm,
                       overload=tp.OverloadConfig(**ocfg))
    jres = jd.run(stream, collector=jp.Collector(jp.WindowConfig(batch=40)),
                  chunk=40)
    tres = td.run(stream, collector=tp.Collector(tp.WindowConfig(batch=40)),
                  chunk=40)
    assert td.breaker_trips >= 1, "the stream never overflowed"
    assert_same_breaker(jd, td)
    assert td.breaker_state == tp.BREAKER_CLOSED
    assert tm.summary()["breaker_trips"] == jm.summary()["breaker_trips"]
    assert per_arrival(tres) == per_arrival(jres)
    assert len(per_arrival(tres)) == len(stream.t)
    assert [r.rebuilt for r in tres] == [r.rebuilt for r in jres]
    assert_same_state(jd.index, td.index, "after the recovered stream")


def test_breaker_off_still_poisons():
    pc = 64
    stream = insert_stream(2 * pc + 32)
    jidx, tidx, _ = fresh_pair(pc=pc, n0=1024)
    jd, td = jp.Dispatcher(jidx, depth=1), tp.Dispatcher(tidx, depth=1)
    for pkg, d in ((jp, jd), (tp, td)):
        with pytest.raises(pkg.PendingOverflowError) as e:
            d.run(stream, collector=pkg.Collector(pkg.WindowConfig(batch=40)),
                  chunk=40)
        d.exc = e.value
    assert [w.seq for w in td.exc.windows] == [w.seq for w in jd.exc.windows]
    assert td.breaker_state == tp.BREAKER_POISONED
    assert_same_breaker(jd, td)
    # breaker disarmed by config: the same contract
    jidx, tidx, _ = fresh_pair(pc=pc, n0=1024)
    td = tp.Dispatcher(tidx, depth=1,
                       overload=tp.OverloadConfig(breaker=False))
    with pytest.raises(tp.PendingOverflowError):
        td.run(stream, collector=tp.Collector(tp.WindowConfig(batch=40)),
               chunk=40)
    assert td.breaker_trips == 0 and td.breaker_state == tp.BREAKER_POISONED


def test_breaker_geometry_error_still_poisons():
    jcfg, tcfg = configs("xla", capacity=64, pending_capacity=8, fanout=4)
    jd = jp.Dispatcher(jbuild(jcfg, jnp.zeros((0,), jnp.int32),
                              jnp.zeros((0,), jnp.int32)), depth=0,
                       overload=jp.OverloadConfig(max_recoveries=50))
    td = tp.Dispatcher(tpi.empty(tcfg, device="cpu"), depth=0,
                       overload=tp.OverloadConfig(max_recoveries=50))
    triples = [(INSERT, 100 + i, i) for i in range(32)]
    for pkg, d in ((jp, jd), (tp, td)):
        with pytest.raises(pkg.PendingOverflowError, match="geometry"):
            d.submit(mk_window(pkg, triples, batch=32))
    assert td.breaker_state == tp.BREAKER_POISONED
    assert td.breaker_trips == 1 and td.breaker_recoveries == 0
    assert_same_breaker(jd, td)


def test_breaker_escalates_to_read_only_then_decays():
    now = [0.0]
    jidx, tidx, ref = fresh_pair(pc=64, n0=1024)
    kw = dict(max_recoveries=0, recovery_interval=10.0)
    jd = jp.Dispatcher(jidx, depth=0, clock=lambda: now[0],
                       overload=jp.OverloadConfig(**kw))
    td = tp.Dispatcher(tidx, depth=0, clock=lambda: now[0],
                       overload=tp.OverloadConfig(**kw))
    s = insert_stream(80)
    got = {}
    for pkg, d in ((jp, jd), (tp, td)):
        res = [r for w in insert_windows(pkg, s, (0, 40), 40)
               for r in d.submit(w)] + d.flush()
        got[pkg] = per_arrival(res)
    assert got[tp] == got[jp]
    assert td.breaker_trips == 1 and td.breaker_recoveries == 1
    assert td.breaker_state == tp.BREAKER_READ_ONLY
    assert_same_breaker(jd, td)
    assert_same_state(jd.index, td.index, "after the trip")

    some_key = int(next(iter(ref.data)))
    for pkg, d in ((jp, jd), (tp, td)):
        with pytest.raises(pkg.ReadOnlyModeError):
            d.submit(mk_window(pkg, [(INSERT, 2_500_000, 5)], batch=4))
        (r,) = d.submit(mk_window(pkg, [(SEARCH, some_key, 0)], batch=4))
        got[pkg] = r.per_arrival()
    assert got[tp] == got[jp] == {0: (True, ref.data[some_key])}

    now[0] = 11.0   # a quiet interval: the breaker closes
    for pkg, d in ((jp, jd), (tp, td)):
        d.submit(mk_window(pkg, [(INSERT, 2_500_000, 5),
                                 (DELETE, some_key, 0)], batch=4))
        d.flush()
    assert td.breaker_state == tp.BREAKER_CLOSED
    assert_same_breaker(jd, td)
    assert_same_state(jd.index, td.index, "after the decay")


def test_reset_breaker_overrides_read_only_but_not_poisoned():
    jidx, tidx, _ = fresh_pair(pc=64, n0=1024)
    jd = jp.Dispatcher(jidx, depth=0, clock=lambda: 0.0,
                       overload=jp.OverloadConfig(max_recoveries=0))
    td = tp.Dispatcher(tidx, depth=0, clock=lambda: 0.0,
                       overload=tp.OverloadConfig(max_recoveries=0))
    s = insert_stream(80)
    for pkg, d in ((jp, jd), (tp, td)):
        for w in insert_windows(pkg, s, (0, 40), 40):
            d.submit(w)
        d.flush()
        assert d.breaker_state == pkg.BREAKER_READ_ONLY
        d.reset_breaker()
        assert d.breaker_state == pkg.BREAKER_CLOSED
        d.submit(mk_window(pkg, [(INSERT, 2_500_001, 7)], batch=4))
        d.flush()
    assert_same_breaker(jd, td)
    assert_same_state(jd.index, td.index, "after the reset")

    _, tcfg = configs("xla", capacity=64, pending_capacity=8, fanout=4)
    bad = tp.Dispatcher(tpi.empty(tcfg, device="cpu"), depth=0,
                        overload=tp.OverloadConfig())
    with pytest.raises(tp.PendingOverflowError):
        bad.submit(mk_window(tp, [(INSERT, 100 + i, i) for i in range(32)],
                             batch=32))
    with pytest.raises(RuntimeError, match="poisoned"):
        bad.reset_breaker()


def test_overload_config_validation_matches_jax():
    assert tov.OverloadConfig() == tov.OverloadConfig(
        shed_range_sub_at=0.4, shed_range_at=0.7)
    for bad in (dict(shed_dup_at=0.9, shed_search_at=0.8),
                dict(pressure_ewma=0.0), dict(deadline_min=2.0),
                dict(deadline_step=1.0), dict(adjust_every=0),
                dict(max_recoveries=-1), dict(recovery_interval=0.0)):
        for pkg in (jp, tp):
            with pytest.raises(ValueError):
                pkg.OverloadConfig(**bad)
    assert (tov.SHED_RANGE_SUB, tov.SHED_SEARCH_DUP, tov.SHED_RANGE,
            tov.SHED_SEARCH, tov.SHED_WRITE) == \
        ("range_sub", "search_dup", "range", "search", "write")


@pytest.mark.parametrize("field", [
    dict(shed=False), dict(shed_dup_at=0.3), dict(shed_range_at=0.6),
    dict(pressure_ewma=0.5), dict(adapt_deadline=False),
    dict(latency_slo=0.01), dict(hysteresis=3)])
def test_overload_config_takes_shed_and_deadline_fields(field):
    """A shed or deadline setting is taken as the JAX package takes it,
    field for field (the derived range rungs included), beside the
    breaker's own fields."""
    assert dataclasses.asdict(tov.OverloadConfig(**field)) == \
        dataclasses.asdict(jp.OverloadConfig(**field))
    cfg = tov.OverloadConfig(breaker=False, max_recoveries=9,
                             recovery_interval=5.0, **field)
    assert dataclasses.replace(cfg, breaker=True).max_recoveries == 9


def test_recover_behind_the_breaker(tmp_path):
    """A durable stream that trips the breaker recovers, through
    ``recover(overload=...)``, to the live state of both packages."""
    pc = 64
    stream = insert_stream(2 * pc + 32)
    jidx, tidx, _ = fresh_pair(pc=pc, n0=1024)
    ocfg = dict(max_recoveries=50)
    live = {}
    for pkg, idx in ((jp, jidx), (tp, tidx)):
        d_dir = str(tmp_path / pkg.__name__)
        dur = pkg.Durability(d_dir, idx, snapshot_every=2)
        d = pkg.Dispatcher(idx, depth=1, durability=dur,
                           overload=pkg.OverloadConfig(**ocfg))
        d.run(stream, collector=pkg.Collector(pkg.WindowConfig(batch=40),
                                              on_seal=dur.on_seal), chunk=40)
        assert d.breaker_trips >= 1
        dur.close()
        live[pkg] = d.index
    assert_same_state(live[jp], live[tp], "live states")
    for pkg in (jp, tp):
        got, _ = tp.recover(str(tmp_path / pkg.__name__), device="cpu",
                            overload=tp.OverloadConfig(**ocfg))
        assert_same_state(live[jp], got, f"port recovers {pkg.__name__}")


# ---------------------------------------------------------------------------
# shedding, retries and deadline retuning: OverloadController parity
# ---------------------------------------------------------------------------

def assert_same_report(jrep, trep):
    """Two ``RunReport``s equal field for field, window by window."""
    assert trep.results == jrep.results
    assert trep.range_results == jrep.range_results
    assert [int(q) for q in trep.admitted] == [int(q) for q in jrep.admitted]
    assert trep.dropped == jrep.dropped
    assert trep.retries == jrep.retries
    assert len(trep.window_results) == len(jrep.window_results)
    for a, b in zip(jrep.window_results, trep.window_results):
        assert [int(q) for q in a.window.qids] == \
            [int(q) for q in b.window.qids]
        for name in ("found", "val", "rcnt", "rsum"):
            x, y = getattr(a, name), getattr(b, name)
            assert (x is None) == (y is None), name
            if x is not None:
                np.testing.assert_array_equal(np.asarray(x), y)
        assert (a.rebuilt, a.rebuilt_incremental, a.t_retired) == \
            (b.rebuilt, b.rebuilt_incremental, b.t_retired)
        assert a.pending_fill == b.pending_fill or \
            (math.isnan(a.pending_fill) and math.isnan(b.pending_fill))


def assert_same_summary(jm, tm):
    a, b = jm.summary(), tm.summary()
    assert a.keys() == b.keys()
    for k in a:
        assert a[k] == b[k] or (a[k] != a[k] and b[k] != b[k]), k


def control(pkg, idx, stream, ocfg, *, wcfg, chunk, retry=None, seed=0,
            clock=lambda: 0.0, durability=None, breaker=True, depth=1):
    """One ``OverloadController.run`` of ``stream`` through ``pkg``."""
    m = pkg.PipelineMetrics()
    disp = pkg.Dispatcher(idx, depth=depth, metrics=m,
                          overload=ocfg if breaker else None, clock=clock,
                          durability=durability)
    col = pkg.Collector(pkg.WindowConfig(**wcfg),
                        on_seal=durability.on_seal if durability else None)
    ctl = pkg.OverloadController(ocfg, metrics=m, seed=seed,
                                 retry=None if retry is None
                                 else pkg.RetryPolicy(**retry))
    return ctl.run(disp, col, stream, chunk=chunk), m, disp, ctl, col


def ycsb_stream(pkg, process, n, write_ratio, theta=0.0, seed=3,
                key_space=2048, **acfg):
    keys = np.unique(np.random.default_rng(7)
                     .integers(1, key_space, 512).astype(np.int32))
    data = jdata if pkg is jp else tdata
    return pkg.make_arrivals(
        pkg.ArrivalConfig(process=process, rate=1e4, n_arrivals=n, seed=seed,
                          **acfg),
        data.YCSBConfig(write_ratio=write_ratio, theta=theta), keys)


def final_live(index):
    k, v = tpi.live_items(tpi.rebuild(index))
    return dict(zip(k.tolist(), v.tolist()))


@pytest.mark.parametrize("process,backend", [
    ("poisson", "torch"), ("bursty", "torch"), ("diurnal", "torch"),
    ("hotkey", "torch"), ("bursty", "cuda")])
def test_overload_sheds_then_recovers_like_jax(process, backend):
    """``test_overload_sheds_then_recovers_zero_acked_loss`` on both
    packages: the same shed plan, retries, admissions and results, the
    same metrics; zero acknowledged loss against ``RefIndex``."""
    jidx, tidx, ref = fresh_pair(pc=96, key_space=2048, n0=64,
                                 backend=backend)
    kw = dict(shed_dup_at=0.15, shed_search_at=0.3, shed_write_at=0.95,
              max_recoveries=10_000, adapt_deadline=False)
    run = dict(wcfg=dict(batch=48, deadline=5.0), chunk=48,
               retry=dict(max_retries=2), seed=9)
    acfg = dict(hot_keys=4, hot_frac=0.8)
    jrep, jm, jd, _, _ = control(
        jp, jidx, ycsb_stream(jp, process, 3000, 0.6, 0.9, **acfg),
        jp.OverloadConfig(**kw), **run)
    stream = ycsb_stream(tp, process, 3000, 0.6, 0.9, **acfg)
    trep, tm, td, _, _ = control(tp, tidx, stream, tp.OverloadConfig(**kw),
                                 **run)
    assert tm.summary()["shed_total"] > 0, "the burst never drove shedding"
    assert tm.summary()["shed_total"] == len(trep.dropped) + trep.retries
    assert td.breaker_state == tp.BREAKER_CLOSED
    assert_same_report(jrep, trep)
    assert_same_summary(jm, tm)
    assert_same_state(jd.index, td.index, process)
    check_admitted_against_oracle(trep, ref, stream)
    assert final_live(td.index) == ref.data
    assert trep.goodput == len(trep.admitted) > 0


def test_overload_with_ranges_sheds_range_rungs_like_jax():
    """A scan mix under pressure: the two range rungs (subsumed ranges,
    then all ranges) shed as in JAX, and range results match."""
    jidx, tidx, _ = fresh_pair(pc=96, key_space=2048, n0=64)
    kw = dict(shed_range_sub_at=0.05, shed_dup_at=0.1, shed_range_at=0.2,
              shed_search_at=0.6, max_recoveries=10_000,
              adapt_deadline=False)
    run = dict(wcfg=dict(batch=48, deadline=5.0), chunk=48,
               retry=dict(max_retries=1), seed=4)
    acfg = dict(range_frac=0.3, span_min=1, span_max=200)
    jrep, jm, jd, _, _ = control(
        jp, jidx, ycsb_stream(jp, "bursty", 2000, 0.6, **acfg),
        jp.OverloadConfig(**kw), **run)
    trep, tm, td, _, _ = control(
        tp, tidx, ycsb_stream(tp, "bursty", 2000, 0.6, **acfg),
        tp.OverloadConfig(**kw), **run)
    shed = tm.summary()["shed_by_class"]
    assert shed.get(tp.SHED_RANGE, 0) + shed.get(tp.SHED_RANGE_SUB, 0) > 0
    assert trep.range_results
    assert_same_report(jrep, trep)
    assert_same_summary(jm, tm)
    assert_same_state(jd.index, td.index, "ranges")


@pytest.mark.parametrize("pressure", [0.1, 0.3, 0.6, 0.9])
def test_shed_ladder_matches_jax(pressure):
    """``AdmissionController.plan`` at each rung of the ladder: the same
    keep mask, class masks and shed counts as JAX; read-only sheds every
    write."""
    kw = dict(shed_dup_at=0.2, shed_search_at=0.5, shed_write_at=0.8)
    ops = np.array([SEARCH, SEARCH, INSERT, DELETE, RANGE, RANGE], np.int32)
    dup = np.array([True, False, False, False, False, False])
    covered = np.array([False, False, False, False, True, False])
    for read_only in (False, True):
        out = []
        for pkg, ov in ((jp, jov), (tp, tov)):
            m = pkg.PipelineMetrics()
            adm = ov.AdmissionController(pkg.OverloadConfig(**kw), metrics=m)
            adm.observe(types.SimpleNamespace(pending_fill=pressure))
            keep, masks = adm.plan(ops, dup, covered=covered,
                                   read_only=read_only)
            out.append((keep.tolist(), {k: v.tolist()
                                        for k, v in masks.items()},
                        m.shed_by_class, adm.pressure, adm.retry_after))
        assert out[0] == out[1]
        want = {0.1: [1, 1, 1, 1, 1, 1], 0.3: [0, 1, 1, 1, 0, 1],
                0.6: [0, 0, 1, 1, 0, 0], 0.9: [0, 0, 0, 0, 0, 0]}[pressure]
        if read_only:
            want[2] = want[3] = 0
        assert out[1][0] == [bool(x) for x in want]


def test_pressure_ewma_matches_jax():
    fills = [1.0, 0.0, float("nan"), 0.2] + [0.0] * 30
    out = []
    for ov, pkg in ((jov, jp), (tov, tp)):
        adm = ov.AdmissionController(pkg.OverloadConfig(pressure_ewma=0.3))
        seen = []
        for f in fills:
            adm.observe(types.SimpleNamespace(pending_fill=f))
            seen.append(adm.pressure)
        out.append(seen)
    assert out[0] == out[1]
    assert 0.3 < out[1][1] < 1.0 and out[1][-1] < 0.05


def _res(occ, trigger, lat=0.001):
    return types.SimpleNamespace(
        window=types.SimpleNamespace(occupancy=occ, trigger=trigger),
        latencies=lambda: np.full(max(occ, 1), lat), pending_fill=0.0)


DEADLINE_CASES = {
    # name: (config, starting deadline, [(n, occupancy, trigger, latency)])
    "grows": (dict(adjust_every=4, hysteresis=2, deadline_step=2.0,
                   deadline_max=1.0, fill_low=0.5), 0.01,
              [(8, 4, "deadline", 0.001)]),
    "shrinks": (dict(adjust_every=4, hysteresis=2, deadline_step=2.0,
                     latency_slo=0.05, deadline_min=0.001), 0.08,
                [(8, 32, "size", 0.2)]),
    "hysteresis": (dict(adjust_every=4, hysteresis=2, deadline_step=2.0),
                   0.01, [(4, 4, "deadline", 0.001), (4, 32, "size", 0.001),
                          (4, 4, "deadline", 0.001)]),
    "clamps": (dict(adjust_every=1, hysteresis=1, deadline_step=10.0,
                    deadline_min=0.004, deadline_max=0.05,
                    latency_slo=0.05), 0.01,
               [(5, 1, "deadline", 0.001), (5, 32, "size", 1.0)]),
    "infinite": (dict(adjust_every=1, hysteresis=1, deadline_max=0.5,
                      latency_slo=0.01), math.inf,
                 [(1, 4, "deadline", 0.001), (1, 32, "size", 1.0)]),
}


@pytest.mark.parametrize("case", sorted(DEADLINE_CASES))
def test_deadline_controller_matches_jax(case):
    """The five ``DeadlineController`` cases of ``test_overload``: the
    same deadline after every observation, the same trajectory and
    metrics."""
    cfg, deadline, script = DEADLINE_CASES[case]
    runs = []
    for pkg, ov in ((jp, jov), (tp, tov)):
        trig = {"deadline": pkg.TRIGGER_DEADLINE, "size": pkg.TRIGGER_SIZE}
        col = pkg.Collector(pkg.WindowConfig(batch=32, deadline=deadline))
        m = pkg.PipelineMetrics()
        ctl = ov.DeadlineController(pkg.OverloadConfig(**cfg), col,
                                    metrics=m)
        seen = []
        for n, occ, t, lat in script:
            for _ in range(n):
                ctl.observe(_res(occ, trig[t], lat))
                seen.append(col.deadline)
        runs.append((seen, ctl.trajectory, m.deadline_current,
                     m.deadline_updates))
    assert runs[0] == runs[1]
    want = {"grows": 0.02, "shrinks": 0.04, "hysteresis": 0.01,
            "clamps": 0.004, "infinite": 0.5}[case]
    assert runs[1][0][-1] == pytest.approx(want)


def test_deadline_retunes_on_diurnal_workload_like_jax():
    """The diurnal retune of ``test_overload`` on both packages: the same
    deadline trajectory, report and metrics."""
    out = []
    for pkg in (jp, tp):
        jidx, tidx, _ = fresh_pair(pc=1024, key_space=1 << 14, n0=256)
        keys = np.unique(np.random.default_rng(3)
                         .integers(1, 1 << 14, 4096).astype(np.int32))
        data = jdata if pkg is jp else tdata
        stream = pkg.make_arrivals(
            pkg.ArrivalConfig(process="diurnal", rate=2e3, n_arrivals=4000,
                              period=0.5, swing=0.95, seed=5),
            data.YCSBConfig(write_ratio=0.2), keys)
        ocfg = pkg.OverloadConfig(shed=False, breaker=False, adjust_every=4,
                                  hysteresis=2, deadline_min=1e-3,
                                  deadline_max=0.5, deadline_step=2.0,
                                  fill_low=0.5)
        out.append(control(pkg, jidx if pkg is jp else tidx, stream, ocfg,
                           wcfg=dict(batch=64, deadline=0.002), chunk=64,
                           breaker=False))
    (jrep, jm, jd, jctl, jcol), (trep, tm, td, tctl, tcol) = out
    assert tm.deadline_updates >= 1
    traj = tctl.deadline_controller.trajectory
    assert traj == jctl.deadline_controller.trajectory
    assert len(traj) >= 2 and traj[-1][1] != traj[0][1]
    assert tcol.deadline == jcol.deadline == tm.deadline_current
    assert_same_report(jrep, trep)
    assert_same_summary(jm, tm)
    assert_same_state(jd.index, td.index, "diurnal")


def test_collector_set_deadline_validates_and_applies():
    col = tp.Collector(tp.WindowConfig(batch=4, deadline=1.0))
    with pytest.raises(ValueError):
        col.set_deadline(0.0)
    assert col.offer(0.0, INSERT, 1, 1, 0)
    col.set_deadline(0.25)
    assert col.deadline == 0.25
    assert not col.offer(0.5, INSERT, 2, 2, 1)
    assert col.take(0.5).trigger == tp.TRIGGER_DEADLINE


def test_retry_policy_matches_jax():
    """``next_delay`` draws the same jitter from the same generator;
    bounds and validation as in JAX."""
    kw = dict(max_retries=3, backoff_base=0.01, backoff_factor=2.0,
              jitter=0.2)
    jrng, trng = np.random.default_rng(0), np.random.default_rng(0)
    jpol, tpol = jp.RetryPolicy(**kw), tp.RetryPolicy(**kw)
    for attempt in (0, 2) * 50:
        d = tpol.next_delay(attempt, 0.05, trng)
        assert d == jpol.next_delay(attempt, 0.05, jrng)
        base = 0.05 * 2.0 ** attempt
        assert base * 0.8 <= d <= base * 1.2
    assert tp.RetryPolicy(jitter=0.0).next_delay(0, 1e-9, trng) == \
        pytest.approx(1e-3)
    for bad in (dict(max_retries=-1), dict(backoff_factor=0.5),
                dict(jitter=1.5)):
        for pkg in (jp, tp):
            with pytest.raises(ValueError):
                pkg.RetryPolicy(**bad)


def test_retry_exhaustion_matches_jax():
    """With no retries every shed op is dropped, reported and counted,
    in the same order as in JAX."""
    jidx, tidx, ref = fresh_pair(pc=96, key_space=2048)
    kw = dict(shed_dup_at=0.15, shed_search_at=0.3, max_recoveries=10_000,
              adapt_deadline=False)
    run = dict(wcfg=dict(batch=48), chunk=48, retry=dict(max_retries=0))
    jrep, jm, _, _, _ = control(jp, jidx, ycsb_stream(jp, "hotkey", 1500,
                                                      0.6),
                                jp.OverloadConfig(**kw), **run)
    stream = ycsb_stream(tp, "hotkey", 1500, 0.6)
    trep, tm, td, _, _ = control(tp, tidx, stream, tp.OverloadConfig(**kw),
                                 **run)
    assert trep.retries == 0 and len(trep.dropped) > 0
    assert tm.retry_exhausted == len(trep.dropped) == \
        tm.summary()["shed_total"]
    assert_same_report(jrep, trep)
    assert_same_summary(jm, tm)
    check_admitted_against_oracle(trep, ref, stream)
    assert final_live(td.index) == ref.data


def test_shed_ops_never_in_wal_like_jax(tmp_path):
    """Shedding is admission-time only: every WAL record's qids were
    admitted (or bounced and dropped); the two packages' logs hold the
    same windows."""
    jidx, tidx, _ = fresh_pair(pc=96, key_space=2048)
    kw = dict(shed_dup_at=0.15, shed_search_at=0.3, max_recoveries=10_000,
              adapt_deadline=False)
    walled, reps = {}, {}
    for pkg, idx in ((jp, jidx), (tp, tidx)):
        d = str(tmp_path / pkg.__name__)
        dur = pkg.Durability(d, idx, fsync="per_window")
        reps[pkg] = control(pkg, idx, ycsb_stream(pkg, "hotkey", 1500, 0.6),
                            pkg.OverloadConfig(**kw), wcfg=dict(batch=48),
                            chunk=48, seed=9, durability=dur)[0]
        dur.close()
        walled[pkg] = [[int(q) for q in tp.record_window(r).qids]
                       for r in tp.read_wal(os.path.join(d, "wal"))]
    assert walled[tp] == walled[jp]
    assert_same_report(reps[jp], reps[tp])
    rep = reps[tp]
    flat = {q for w in walled[tp] for q in w}
    assert flat - set(rep.admitted) <= set(rep.dropped)
    assert set(rep.admitted) <= flat


def test_overload_controller_reschedules_read_only_bounced_writes():
    """Writes refused while read-only are backed off and land once the
    breaker closes, as in JAX (each clock read advances one unit)."""
    out = []
    for pkg in (jp, tp):
        jidx, tidx, ref = fresh_pair(pc=64, n0=1024)
        clk = itertools.count()
        ocfg = pkg.OverloadConfig(max_recoveries=0, recovery_interval=5.0,
                                  shed=False, adapt_deadline=False)
        out.append(control(pkg, jidx if pkg is jp else tidx,
                           insert_stream(120), ocfg, wcfg=dict(batch=40),
                           chunk=40, retry=dict(max_retries=20,
                                                backoff_base=2.0,
                                                jitter=0.0),
                           clock=lambda: float(next(clk)), depth=0) + (ref,))
    (jrep, jm, jd, _, _, _), (trep, tm, td, _, _, ref) = out
    assert td.breaker_trips == jd.breaker_trips == 1
    assert tm.shed_by_class.get(tp.SHED_WRITE, 0) > 0
    assert not trep.dropped and td.breaker_state == tp.BREAKER_CLOSED
    assert_same_report(jrep, trep)
    assert_same_summary(jm, tm)
    check_admitted_against_oracle(trep, ref, insert_stream(120))
    assert final_live(td.index) == ref.data
