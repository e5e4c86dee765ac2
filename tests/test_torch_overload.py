"""The port's circuit breaker against the JAX dispatcher's, on the CPU.

The breaker cases of ``tests/test_overload.py`` — recovery at 2x the
pending capacity, the poisoning contract with the breaker off, the
geometry error, escalation to read-only and its decay, ``reset_breaker``
— each run the same windows through the JAX ``Dispatcher`` and the
port's, with the same ``OverloadConfig`` and clock: the per-arrival
results, the breaker's counters and state, the errors raised and every
leaf of the final index must be equal, bit for bit.  ``recover`` with an
``overload`` config replays a durability directory behind the breaker.
The shed and deadline fields, whose controllers are not ported, raise
when set.
The port runs the ``torch`` backend here, the JAX package ``xla``; the
``cuda`` backend is held to the same results on its plain versions.
"""
import types

import jax.numpy as jnp
import numpy as np
import pytest

from repro import pipeline as jp
from repro.core import build as jbuild
from repro_torch import pipeline as tp
from repro_torch.core import DELETE, INSERT, SEARCH, RefIndex
from repro_torch.core import index as tpi
from repro_torch.pipeline import overload as tov
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
def test_overload_config_refuses_unported_fields(field):
    """A shed or deadline setting the port cannot honour raises, naming
    its ROADMAP item, where the JAX package accepts it; the breaker's own
    fields and a ``dataclasses.replace`` of the default are taken."""
    import dataclasses
    jp.OverloadConfig(**field)
    with pytest.raises(NotImplementedError, match="A8"):
        tov.OverloadConfig(**field)
    cfg = tov.OverloadConfig(breaker=False, max_recoveries=9,
                             recovery_interval=5.0)
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
