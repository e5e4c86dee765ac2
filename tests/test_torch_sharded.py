"""The port's fence-sharded index against the JAX package's, on the CPU.

* **S = 8**: the JAX side runs once a backend in a subprocess with 8 host
  devices (``conftest.run_with_devices``) on a plain
  ``jax.sharding.Mesh(np.array(jax.devices()), ("data",))`` — on jax
  0.9.0 the shardings of a ``jax.make_mesh`` mesh break the JAX rebuild
  under ``vmap`` and ``collect_pairs`` (ROADMAP A9).  It dumps to a
  ``.npz`` every window's ``(found, val)``, ``load`` and ``dropped``, every
  stacked leaf after each window, after ``rebuild_sharded`` and after
  ``maybe_rebuild_shards``, ``collect_pairs``, and a sharded
  ``Dispatcher`` run (results, metrics, leaves).  The ``xla`` run also
  writes a sharded durability directory and recovers one the port wrote.
  The port (``torch`` against ``xla``, ``cuda`` on its plain versions
  against ``pallas-interpret``) must match all of it bit for bit.
* **S = 1** in-process, and ``execute_ranges_sharded`` at S = 4 (no mesh).
* The routing helpers, ``alg3.run_threads`` and the rebalance functions.
* The port's own sharded durability: the crash matrix over the five
  fault points, and directories recovered across the packages.
"""
import contextlib
import dataclasses
import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import run_with_devices
from repro import pipeline as jp
from repro.core import alg3 as jalg3
from repro.core import distributed as jdist
from repro.core import index as jpi
from repro.core import rebalance as jreb
from repro_torch import checkpoint as tckpt
from repro_torch import core as tc
from repro_torch import faults
from repro_torch import pipeline as tp
from repro_torch.core import DELETE, INSERT, RANGE, SEARCH, RefIndex
from repro_torch.core import alg3 as talg3
from repro_torch.core import index as tpi
from repro_torch.core import rebalance as treb
from test_query_pipeline import make_stream, replay_stream
from torch_parity import BACKEND_OF, configs

BACKENDS = list(BACKEND_OF.items())        # (JAX backend, port backend)
BACKEND_IDS = ["xla-torch", "pallas-interpret-cuda"]
S8 = 8
GEOMETRY8 = dict(capacity=1024, pending_capacity=128, fanout=4)
N_WINDOWS = 5
WINDOW = dict(batch=128, deadline=4e-4)
CAPACITY_FACTOR = 4.0                     # the dispatcher's, S = 8
MAX_SPAN = 512                            # > any shard's keys: exact ranges

REF_SCRIPT = r"""
import json, types
import numpy as np, jax, jax.numpy as jnp
from repro.core import (PIConfig, build_sharded, collect_pairs,
                        execute_sharded, maybe_rebuild_shards,
                        rebuild_sharded)
from repro import pipeline as jp

z = dict(np.load(ARGS["inp"]))
mesh = jax.sharding.Mesh(np.array(jax.devices()), ("data",))
S = len(jax.devices())
backend = ARGS["backend"]
out = {}


def dump(tag, tree):
    for i, x in enumerate(jax.tree_util.tree_leaves(tree)):
        out[f"{tag}/leaf{i}"] = np.asarray(x)


def serve(index, durability=None):
    met = jp.PipelineMetrics()
    disp = jp.Dispatcher(index, mesh=mesh, depth=1, clock=lambda: 0.0,
                         max_span=ARGS["max_span"], metrics=met,
                         capacity_factor=ARGS["capacity_factor"],
                         durability=durability)
    col = jp.Collector(jp.WindowConfig(**ARGS["window"]),
                       on_seal=durability.on_seal if durability else None)
    res = disp.run(stream, collector=col, chunk=ARGS["window"]["batch"])
    return disp, met, res


stream = types.SimpleNamespace(**{k: z["stream_" + k] for k in
                                  ("t", "ops", "keys", "vals", "keys2")})
cfg = PIConfig(backend=backend, **ARGS["geometry"])
st = build_sharded(cfg, S, z["keys"], z["vals"])
built = st
dump("build", (st.shards, st.fences))
for w in range(ARGS["n_windows"]):
    if w == ARGS["n_windows"] - 1:
        out["pairs/k"], out["pairs/v"] = collect_pairs(st)
        st = rebuild_sharded(st)
        dump("rebuild", st.shards)
    st, (f, v), load, drop = execute_sharded(
        st, mesh, jnp.asarray(z[f"w{w}_ops"]), jnp.asarray(z[f"w{w}_keys"]),
        jnp.asarray(z[f"w{w}_vals"]))
    for name, x in (("found", f), ("val", v), ("load", load),
                    ("dropped", drop)):
        out[f"w{w}/{name}"] = np.asarray(x)
    dump(f"w{w}", st.shards)
shards, ovf, due = maybe_rebuild_shards(st.shards)
dump("maybe", shards)
out["maybe/ovf"], out["maybe/due"] = np.asarray(ovf), np.asarray(due)

disp, met, res = serve(built)
for i, r in enumerate(res):
    for name in ("found", "val", "rcnt", "rsum"):
        if getattr(r, name) is not None:
            out[f"disp{i}/{name}"] = np.asarray(getattr(r, name))
    out[f"disp{i}/meta"] = np.array([r.rebuilt, r.rebuilt_incremental,
                                     r.pending_fill])
out["disp/n"] = np.array(len(res))
out["disp/summary"] = np.array(json.dumps(met.summary(), sort_keys=True))
dump("disp", disp.index.shards)

if "jax_dir" in ARGS:
    dur = jp.Durability(ARGS["jax_dir"], built, snapshot_every=3)
    disp, _, _ = serve(built, dur)
    dur.close()
    dump("dur/live", (disp.index.shards, disp.index.fences))
    rec, replayed = jp.recover(ARGS["port_dir"], mesh=mesh)
    dump("dur/port", (rec.shards, rec.fences))
    out["dur/port_replayed"] = np.array([r.seq for r in replayed])
np.savez(ARGS["out"], **out)
print("OK")
"""


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def port_leaves(*parts):
    """numpy leaves of PIIndex / tensor parts, in the JAX flatten order."""
    out = []
    for p in parts:
        out += tpi.flat_leaves(p) if isinstance(p, tpi.PIIndex) else [p]
    return [x.cpu().numpy() for x in out]


def jax_leaves(*parts):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tuple(parts))]


def assert_leaves(want, got, tag):
    assert len(want) == len(got), f"{tag}: {len(want)} != {len(got)} leaves"
    for i, (w, g) in enumerate(zip(want, got)):
        assert w.dtype == g.dtype, f"{tag}: leaf {i} dtype"
        np.testing.assert_array_equal(w, g, err_msg=f"{tag}: leaf {i}")


def ref_leaves(ref, tag):
    n = sum(1 for k in ref if k.startswith(tag + "/leaf"))
    return [ref[f"{tag}/leaf{i}"] for i in range(n)]


def jax_mesh1():
    """A one-device JAX mesh on which the JAX rebuild runs (see above)."""
    return jax.sharding.Mesh(np.array(jax.devices()[:1]), ("data",))


def inputs8():
    """The S = 8 scenario: an index, five windows of 512, a stream."""
    rng = np.random.default_rng(1)
    B = 512
    keys = rng.choice(100_000, size=1000, replace=False).astype(np.int32)
    inp = dict(keys=keys, vals=np.arange(1000, dtype=np.int32))
    pool = np.concatenate([keys, rng.integers(0, 100_000, 500)
                           .astype(np.int32)])
    for w in range(3):          # mixed ops on keys old and new
        inp[f"w{w}_ops"] = rng.integers(0, 3, B).astype(np.int32)
        inp[f"w{w}_keys"] = rng.choice(pool, B).astype(np.int32)
        inp[f"w{w}_vals"] = rng.integers(0, 1000, B).astype(np.int32)
    # every query on shard 0: its buckets overflow, real queries drop
    inp["w3_ops"] = rng.integers(0, 3, B).astype(np.int32)
    inp["w3_keys"] = rng.choice(np.sort(keys)[:125], B).astype(np.int32)
    inp["w3_vals"] = rng.integers(0, 1000, B).astype(np.int32)
    # after the rebuild: inserts on shards 0-2 only, 5/8 of the lanes
    # sentinel padding (dropped, not counted), so 3 of 8 shards come due
    real = np.arange(B) < 3 * B // 8
    perm = rng.permutation(B)
    inp["w4_ops"] = np.where(real, INSERT, SEARCH).astype(np.int32)[perm]
    inp["w4_keys"] = np.where(real, rng.integers(0, np.sort(keys)[375], B),
                              np.iinfo(np.int32).max).astype(np.int32)[perm]
    inp["w4_vals"] = rng.integers(0, 1000, B).astype(np.int32)
    ycfg = tc_data().YCSBConfig(n_keys=300, key_space=100_000,
                                write_ratio=0.5, theta=0.5, seed=4)
    stream = tp.make_arrivals(
        tp.ArrivalConfig(process="bursty", rate=1e5, n_arrivals=640,
                         range_frac=0.2, span_min=1, span_max=20_000,
                         seed=2), ycfg, keys)
    for k in ("t", "ops", "keys", "vals", "keys2"):
        inp["stream_" + k] = getattr(stream, k)
    return inp


def tc_data():
    from repro_torch import data
    return data


def stream_of(inp):
    return types.SimpleNamespace(**{k: inp["stream_" + k] for k in
                                    ("t", "ops", "keys", "vals", "keys2")})


def port_serve(index, mesh, stream, durability=None):
    met = tp.PipelineMetrics()
    disp = tp.Dispatcher(index, mesh=mesh, depth=1, clock=lambda: 0.0,
                         max_span=MAX_SPAN, metrics=met,
                         capacity_factor=CAPACITY_FACTOR,
                         durability=durability)
    col = tp.Collector(tp.WindowConfig(**WINDOW),
                       on_seal=durability.on_seal if durability else None)
    res = disp.run(stream, collector=col, chunk=WINDOW["batch"])
    return disp, met, res


@pytest.fixture(scope="module")
def ref8(tmp_path_factory):
    """The JAX package's S = 8 runs, one subprocess a backend."""
    d = tmp_path_factory.mktemp("sharded8")
    inp = inputs8()
    np.savez(d / "inp.npz", **inp)
    # the port's durability directory, for the JAX package to recover
    _, tcfg = configs("xla", **GEOMETRY8)
    built = tc.build_sharded(tcfg, S8, inp["keys"], inp["vals"],
                             device="cpu")
    mesh = tc.make_mesh((S8,), ("data",), device="cpu")
    port_dir = str(d / "port_dir")
    dur = tp.Durability(port_dir, built, snapshot_every=3)
    disp, _, _ = port_serve(built, mesh, stream_of(inp), dur)
    dur.close()
    ref = {}
    for jb, _ in BACKENDS:
        args = dict(inp=str(d / "inp.npz"), out=str(d / f"{jb}.npz"),
                    backend=jb, geometry=GEOMETRY8, n_windows=N_WINDOWS,
                    max_span=MAX_SPAN, capacity_factor=CAPACITY_FACTOR,
                    window=WINDOW)
        if jb == "xla":
            args.update(jax_dir=str(d / "jax_dir"), port_dir=port_dir)
        out = run_with_devices(f"ARGS = {json.dumps(args)}\n" + REF_SCRIPT,
                               S8)
        assert "OK" in out
        ref[jb] = dict(np.load(d / f"{jb}.npz"))
    return types.SimpleNamespace(inp=inp, ref=ref, port_live=disp.index,
                                 jax_dir=str(d / "jax_dir"))


def run_windows8(inp, backend):
    """The port's side of the S = 8 core scenario: yields (tag, value)."""
    cfg = tc.PIConfig(backend=backend, **GEOMETRY8)
    mesh = tc.make_mesh((S8,), ("data",), device="cpu")
    st = tc.build_sharded(cfg, S8, inp["keys"], inp["vals"], device="cpu")
    yield "build", st
    for w in range(N_WINDOWS):
        if w == N_WINDOWS - 1:
            yield "pairs", tc.collect_pairs(st)
            st = tc.rebuild_sharded(st)
            yield "rebuild", st
        st, (f, v), load, drop = tc.execute_sharded(
            st, mesh, inp[f"w{w}_ops"], inp[f"w{w}_keys"], inp[f"w{w}_vals"])
        yield f"w{w}", (st, f, v, load, drop)
    yield "maybe", (st, tc.maybe_rebuild_shards(st.shards))


# ---------------------------------------------------------------------------
# routing helpers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,n_dest,cap,keyed", [
    (64, 4, 16, True), (64, 4, 8, True), (96, 8, 5, False), (33, 3, 40, True)])
def test_dispatch_plan_matches_jax(B, n_dest, cap, keyed):
    """order, slot, keep and the drop count equal the JAX plan's; the
    port's plan over a (rows, B) batch equals it row by row."""
    rng = np.random.default_rng(B + cap)
    dest = rng.integers(0, n_dest, (3, B)).astype(np.int32)
    key = rng.integers(0, 50, (3, B)).astype(np.int32) if keyed else None
    got = tc.dispatch_plan(torch.from_numpy(dest), n_dest, cap,
                           None if key is None else torch.from_numpy(key))
    for r in range(3):
        want = jdist.dispatch_plan(
            jnp.asarray(dest[r]), n_dest, cap,
            None if key is None else jnp.asarray(key[r]))
        row = tc.dispatch_plan(torch.from_numpy(dest[r]), n_dest, cap,
                               None if key is None
                               else torch.from_numpy(key[r]))
        for w, g, gb in zip(want, row, got):
            np.testing.assert_array_equal(np.asarray(w), g.numpy())
            np.testing.assert_array_equal(g.numpy(), gb[r].numpy())


def test_scatter_to_buffer_matches_jax():
    rng = np.random.default_rng(3)
    dest = rng.integers(0, 4, 40).astype(np.int32)
    arr = rng.integers(0, 1000, 40).astype(np.int32)
    order, slot, _, n_drop = jdist.dispatch_plan(jnp.asarray(dest), 4, 6)
    assert int(n_drop) > 0
    want = jdist.scatter_to_buffer(jnp.asarray(arr), order, slot, 4, 6, -7)
    torder, tslot, _, _ = tc.dispatch_plan(torch.from_numpy(dest), 4, 6)
    got = tc.scatter_to_buffer(torch.from_numpy(arr), torder, tslot, 4, 6,
                               -7)
    assert got.shape == (4, 6)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


# ---------------------------------------------------------------------------
# S = 8 against the JAX reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("jb,tb", BACKENDS, ids=BACKEND_IDS)
def test_execute_sharded_matches_jax_8(ref8, jb, tb):
    """Every window's results, load and drops, and every stacked leaf
    after it; window 3 drops real queries, window 4 only padding."""
    ref = ref8.ref[jb]
    for tag, x in run_windows8(ref8.inp, tb):
        if tag == "build":
            assert_leaves(ref_leaves(ref, tag),
                          port_leaves(x.shards, x.fences), tag)
        elif tag.startswith("w"):
            st, f, v, load, drop = x
            for name, t in (("found", f), ("val", v), ("load", load),
                            ("dropped", drop)):
                np.testing.assert_array_equal(ref[f"{tag}/{name}"],
                                              t.numpy(), err_msg=tag)
                assert ref[f"{tag}/{name}"].dtype == t.numpy().dtype
            assert_leaves(ref_leaves(ref, tag), port_leaves(st.shards), tag)
    assert ref["w3/dropped"].sum() > 0 and ref["w4/dropped"].sum() == 0
    assert (ref["w4/load"][3:] == 0).all()


@pytest.mark.parametrize("jb,tb", BACKENDS, ids=BACKEND_IDS)
def test_sharded_rebuilds_match_jax_8(ref8, jb, tb):
    """``rebuild_sharded`` of every shard, and ``maybe_rebuild_shards``
    with 3 of 8 shards due, leaf for leaf; ``maybe_rebuild_sharded`` is
    its state-level wrapper."""
    ref = ref8.ref[jb]
    out = dict(run_windows8(ref8.inp, tb))
    assert_leaves(ref_leaves(ref, "rebuild"),
                  port_leaves(out["rebuild"].shards), "rebuild")
    st, (shards, ovf, due) = out["maybe"]
    assert tpi.needs_rebuild(st.shards).tolist() == [True] * 3 + [False] * 5
    assert_leaves(ref_leaves(ref, "maybe"), port_leaves(shards), "maybe")
    assert (bool(ovf), bool(due)) == (bool(ref["maybe/ovf"]),
                                      bool(ref["maybe/due"])) == (False, True)
    again = tc.maybe_rebuild_sharded(st)
    assert_leaves(ref_leaves(ref, "maybe"), port_leaves(again.shards),
                  "maybe_rebuild_sharded")


@pytest.mark.parametrize("jb,tb", BACKENDS, ids=BACKEND_IDS)
def test_collect_pairs_matches_jax_and_oracle_8(ref8, jb, tb):
    """``collect_pairs`` after the windows equals the JAX one; over the
    windows that drop nothing, every result and the pairs equal
    ``RefIndex``'s."""
    inp = ref8.inp
    k, v = dict(run_windows8(inp, tb))["pairs"]
    np.testing.assert_array_equal(k, ref8.ref[jb]["pairs/k"])
    np.testing.assert_array_equal(v, ref8.ref[jb]["pairs/v"])
    cfg = tc.PIConfig(backend=tb, **GEOMETRY8)
    mesh = tc.make_mesh((S8,), ("data",), device="cpu")
    st = tc.build_sharded(cfg, S8, inp["keys"], inp["vals"], device="cpu")
    oracle = RefIndex.build(inp["keys"], inp["vals"])
    for w in range(3):
        args = (inp[f"w{w}_ops"], inp[f"w{w}_keys"], inp[f"w{w}_vals"])
        st, (f, val), _, drop = tc.execute_sharded(st, mesh, *args)
        assert int(drop.sum()) == 0
        want = oracle.execute(*args)
        assert [int(x) if y else None for x, y in zip(val, f)] == want
    k, v = tc.collect_pairs(st)
    assert dict(zip(k.tolist(), v.tolist())) == oracle.data


@pytest.mark.parametrize("jb,tb", BACKENDS, ids=BACKEND_IDS)
def test_sharded_dispatcher_matches_jax_8(ref8, jb, tb):
    """A bursty stream with 20 % ranges through the sharded ``Dispatcher``:
    every window's point and range results, rebuild flags and pending
    fill, the metrics summary and the final leaves; the point results
    against ``RefIndex``, the ranges against its pre-window state."""
    ref = ref8.ref[jb]
    inp = ref8.inp
    cfg = tc.PIConfig(backend=tb, **GEOMETRY8)
    built = tc.build_sharded(cfg, S8, inp["keys"], inp["vals"], device="cpu")
    mesh = tc.make_mesh((S8,), ("data",), device="cpu")
    disp, met, res = port_serve(built, mesh, stream_of(inp))
    assert len(res) == int(ref["disp/n"]) > 4
    for i, r in enumerate(res):
        for name in ("found", "val", "rcnt", "rsum"):
            x = getattr(r, name)
            if x is None:
                assert f"disp{i}/{name}" not in ref
            else:
                np.testing.assert_array_equal(x, ref[f"disp{i}/{name}"])
        np.testing.assert_array_equal(
            [r.rebuilt, r.rebuilt_incremental, r.pending_fill],
            ref[f"disp{i}/meta"])
    assert json.dumps(met.summary(), sort_keys=True) == \
        str(ref["disp/summary"])
    assert met.summary()["rebuilds"] >= 1
    assert_leaves(ref_leaves(ref, "disp"), port_leaves(disp.index.shards),
                  "dispatcher")
    oracle = RefIndex.build(inp["keys"], inp["vals"])
    n_ranges = 0
    for r in res:
        w, occ = r.window, r.window.occupancy
        is_r = w.ops[:occ] == RANGE
        for j in np.flatnonzero(is_r):
            got = oracle.range(w.keys[j], w.keys2[j])
            s = sum(v for _, v in got)
            assert (r.rcnt[j], r.rsum[j]) == \
                (len(got), (s + 2 ** 31) % 2 ** 32 - 2 ** 31)
            n_ranges += 1
        want = oracle.execute(w.ops[:occ], w.keys[:occ], w.vals[:occ])
        for j in np.flatnonzero(~is_r):
            assert (r.val[j] if r.found[j] else None) == want[j]
    assert n_ranges > 0


def test_sharded_durability_across_packages_8(ref8):
    """The JAX package's S = 8 directory recovers in the port to its live
    leaves; the port's recovers in the JAX package to the port's."""
    ref = ref8.ref["xla"]
    rec, replayed = tp.recover(ref8.jax_dir, device="cpu")
    assert isinstance(rec, tc.ShardedPIIndex) and rec.n_shards == S8
    assert rec.shards.config.backend == "torch"
    assert len(replayed) == int(ref["disp/n"]) % 3 > 0
    assert_leaves(ref_leaves(ref, "dur/live"),
                  port_leaves(rec.shards, rec.fences), "port recovers JAX")
    assert_leaves(ref_leaves(ref, "dur/port"),
                  port_leaves(ref8.port_live.shards, ref8.port_live.fences),
                  "JAX recovers the port")
    assert len(ref["dur/port_replayed"]) == len(replayed)


# ---------------------------------------------------------------------------
# S = 1 in-process
# ---------------------------------------------------------------------------

def windows1(n_windows=4, B=48, seed=7):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 3, B).astype(np.int32),
             rng.integers(0, 200, B).astype(np.int32),
             rng.integers(0, 1000, B).astype(np.int32))
            for _ in range(n_windows)]


@pytest.mark.parametrize("jb,tb", BACKENDS, ids=BACKEND_IDS)
def test_execute_sharded_matches_jax_1(jb, tb):
    """One shard through the routing, the rebuilds and ``collect_pairs``;
    the input state is never written."""
    jcfg, tcfg = configs(jb, capacity=256, pending_capacity=64, fanout=4)
    rng = np.random.default_rng(2)
    keys = rng.choice(200, 60, replace=False).astype(np.int32)
    vals = rng.integers(0, 1000, 60).astype(np.int32)
    js = jdist.build_sharded(jcfg, 1, keys, vals)
    ts = tc.build_sharded(tcfg, 1, keys, vals, device="cpu")
    jmesh, tmesh = jax_mesh1(), tc.make_mesh((1,), ("data",), device="cpu")
    assert_leaves(jax_leaves(js.shards, js.fences),
                  port_leaves(ts.shards, ts.fences), "build")
    for w, (ops, ks, vs) in enumerate(windows1()):
        before = port_leaves(ts.shards, ts.fences)
        js, jout, jload, jdrop = jdist.execute_sharded(
            js, jmesh, jnp.asarray(ops), jnp.asarray(ks), jnp.asarray(vs))
        new, tout, tload, tdrop = tc.execute_sharded(ts, tmesh, ops, ks, vs)
        assert_leaves(before, port_leaves(ts.shards, ts.fences),
                      "input untouched")
        ts = new
        for a, b in zip((*jout, jload, jdrop), (*tout, tload, tdrop)):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
        assert_leaves(jax_leaves(js.shards), port_leaves(ts.shards), w)
        jsh, jovf, jdue = jdist.maybe_rebuild_shards(js.shards)
        tsh, tovf, tdue = tc.maybe_rebuild_shards(ts.shards)
        assert (bool(jovf), bool(jdue)) == (bool(tovf), bool(tdue))
        assert_leaves(jax_leaves(jsh), port_leaves(tsh), f"maybe {w}")
        js = jdist.ShardedPIIndex(jsh, js.fences, 1)
        ts = tc.ShardedPIIndex(tsh, ts.fences, 1)
    assert_leaves(jax_leaves(jdist.rebuild_sharded(js).shards),
                  port_leaves(tc.rebuild_sharded(ts).shards), "rebuild")
    for a, b in zip(jdist.collect_pairs(js), tc.collect_pairs(ts)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(np.asarray(js.live_count()),
                                  ts.live_count().numpy())


@pytest.mark.parametrize("jb,tb", BACKENDS, ids=BACKEND_IDS)
def test_sharded_dispatch_matches_oracle(jb, tb):
    """``test_query_pipeline.test_sharded_dispatch_matches_oracle`` on both
    packages: the same per-arrival results, equal to RefIndex, and the same
    final leaves."""
    jcfg, tcfg = configs(jb, capacity=256, pending_capacity=128, fanout=4)
    rng = np.random.default_rng(3)
    keys0 = rng.choice(40, 20, replace=False).astype(np.int32)
    vals0 = rng.integers(0, 1000, 20).astype(np.int32)
    t, ops, keys, vals = make_stream(n=300, seed=5)
    jd = jp.Dispatcher(jdist.build_sharded(jcfg, 1, keys0, vals0),
                       mesh=jax_mesh1(), depth=1,
                       clock=lambda: 0.0)
    td = tp.Dispatcher(tc.build_sharded(tcfg, 1, keys0, vals0, device="cpu"),
                       mesh=tc.make_mesh((1,), ("data",), device="cpu"),
                       depth=1, clock=lambda: 0.0)
    res = {}
    for pkg, disp in ((jp, jd), (tp, td)):
        col = pkg.Collector(pkg.WindowConfig(batch=32, deadline=5.0))
        res[pkg] = replay_stream(disp, col, t, ops, keys, vals)
    assert res[tp] == res[jp] and len(res[tp]) == len(t)
    want = RefIndex.build(keys0, vals0).execute(ops, keys, vals)
    for i in range(len(t)):
        found, val = res[tp][i]
        if ops[i] == SEARCH:
            assert (val if found else None) == want[i], i
        elif ops[i] == DELETE:
            assert found == (want[i] is not None), i
    assert_leaves(jax_leaves(jd.index.shards), port_leaves(td.index.shards),
                  "final")


def test_sharded_dispatch_surfaces_routing_drops():
    """A fence bucket overflowing its send capacity raises in both
    packages and poisons the dispatcher; padding drops do not raise."""
    jcfg, tcfg = configs("xla", capacity=256, pending_capacity=128, fanout=4)
    keys0 = np.arange(0, 64, 2, dtype=np.int32)
    meshes = {jp: jax_mesh1(),
              tp: tc.make_mesh((1,), ("data",), device="cpu")}
    builds = {jp: lambda: jdist.build_sharded(jcfg, 1, keys0, keys0),
              tp: lambda: tc.build_sharded(tcfg, 1, keys0, keys0,
                                           device="cpu")}
    for pkg in (jp, tp):
        disp = pkg.Dispatcher(builds[pkg](), mesh=meshes[pkg], depth=0,
                              capacity_factor=0.25, clock=lambda: 0.0)
        col = pkg.Collector(pkg.WindowConfig(batch=32, coalesce=False))
        for i in range(32):
            assert col.offer(float(i), SEARCH, int(keys0[i % len(keys0)]),
                             0, i)
        window = col.take()
        with pytest.raises(pkg.DispatchOverflowError,
                           match="dropped 24 queries") as e:
            disp.submit(window)
        assert e.value.windows == [window]
        with pytest.raises(pkg.DispatchOverflowError):
            disp.flush()
        disp2 = pkg.Dispatcher(builds[pkg](), mesh=meshes[pkg], depth=0,
                               capacity_factor=0.25, clock=lambda: 0.0)
        col2 = pkg.Collector(pkg.WindowConfig(batch=32, coalesce=False))
        for i in range(4):
            assert col2.offer(float(i), SEARCH, int(keys0[i]), 0, i)
        (res,) = disp2.submit(col2.take())
        assert res.per_arrival() == {i: (True, int(keys0[i]))
                                     for i in range(4)}


def test_sharded_dispatch_requires_mesh_and_refuses_many_devices():
    """A ``ShardedPIIndex`` without a mesh is a ``ValueError``, as in JAX;
    a mesh over two devices is two ranks, and without a process group
    (``launch.mesh``) it is a ``ValueError`` that says so."""
    cfg = tc.PIConfig(capacity=64, pending_capacity=32, fanout=4)
    state = tc.build_sharded(cfg, 1, np.arange(4, dtype=np.int32),
                             np.arange(4, dtype=np.int32), device="cpu")
    with pytest.raises(ValueError, match="mesh"):
        tp.Dispatcher(state)
    with pytest.raises(ValueError, match="process group"):
        tc.make_mesh((2,), ("data",), device=["cuda:0", "cuda:1"])
    mesh = tc.make_mesh((2,), ("data",), device=["cpu", "cpu"])
    assert mesh.shape == {"data": 2} and mesh.device == torch.device("cpu")
    with pytest.raises(ValueError, match="shards"):
        tc.execute_sharded(state, mesh, np.zeros(4, np.int32),
                           np.zeros(4, np.int32), np.zeros(4, np.int32))


# ---------------------------------------------------------------------------
# ranges, Alg. 3, rebalancing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("jb,tb", BACKENDS, ids=BACKEND_IDS)
def test_execute_ranges_sharded_matches_jax_4(jb, tb):
    """``test_range_pipeline.test_sharded_fanout_parity_and_oracle`` at
    S = 4 on both packages, with pending keys and tombstones."""
    rng = np.random.default_rng(0)
    keys = np.unique(rng.integers(0, 100_000, 2500).astype(np.int32))
    vals = rng.integers(0, 1 << 20, keys.shape[0]).astype(np.int32)
    jcfg, tcfg = configs(jb, capacity=2048, pending_capacity=64, fanout=4,
                         seg_width=64)
    js = jdist.build_sharded(jcfg, 4, keys, vals)
    ts = tc.build_sharded(tcfg, 4, keys, vals, device="cpu")
    # pending inserts and deletes on every shard, without routing
    views = [tc.shard_of(ts.shards, s) for s in range(4)]
    lo_f = np.asarray(js.fences)
    parts = []
    jparts = []
    for s, v in enumerate(views):
        lo, hi = max(int(lo_f[s]), 0), min(int(lo_f[s + 1]), 100_000)
        new = rng.integers(lo, hi, 20).astype(np.int32)
        dead = rng.choice(keys[(keys >= lo) & (keys < hi)], 10)
        ops = np.concatenate([np.full(20, INSERT), np.full(10, DELETE)]) \
            .astype(np.int32)
        ks = np.concatenate([new, dead]).astype(np.int32)
        parts.append(tpi.execute_impl(v, torch.from_numpy(ops),
                                      torch.from_numpy(ks),
                                      torch.from_numpy(ks))[0])
        jv = jax.tree.map(lambda x: x[s], js.shards)
        jparts.append(jpi.execute_impl(jv, jnp.asarray(ops), jnp.asarray(ks),
                                       jnp.asarray(ks))[0])
    ts = tc.ShardedPIIndex(tc.stack_shards(parts), ts.fences, 4)
    js = jdist.ShardedPIIndex(jax.tree.map(lambda *x: jnp.stack(x), *jparts),
                              js.fences, 4)
    assert_leaves(jax_leaves(js.shards), port_leaves(ts.shards), "state")
    B = 64
    ops = np.full(B, SEARCH, np.int32)
    los = np.zeros(B, np.int32)
    his = np.zeros(B, np.int32)
    for i in range(48):
        lo = int(rng.integers(0, 90_000))
        ops[i], los[i], his[i] = RANGE, lo, lo + int(rng.integers(0, 50_000))
    for span in (8192, 40):        # whole ranges, and a per-shard budget
        want = jp.execute_ranges_sharded(js, jnp.asarray(ops),
                                         jnp.asarray(los), jnp.asarray(his),
                                         span)
        got = tp.execute_ranges_sharded(ts, ops, los, his, span)
        for w, g in zip(want, got):
            np.testing.assert_array_equal(np.asarray(w), g.numpy())
    ref = RefIndex.build(*tc.collect_pairs(ts))
    cnt, sm = (x.numpy() for x in tp.execute_ranges_sharded(ts, ops, los,
                                                            his, 8192))
    for i in range(48):
        got = ref.range(los[i], his[i])
        s = sum(v for _, v in got)
        assert (cnt[i], sm[i]) == (len(got),
                                   (s + 2 ** 31) % 2 ** 32 - 2 ** 31)
    assert not cnt[48:].any() and not sm[48:].any()


@pytest.mark.parametrize("n_threads", [2, 4, 8])
def test_alg3_run_threads_matches_jax(n_threads):
    """The Alg. 3 oracle: results, final state, ownership and hand-offs
    equal the JAX copy's; ownership stays disjoint."""
    rng = np.random.default_rng(n_threads)
    keys = rng.choice(1000, size=80, replace=False).astype(np.int32)
    init = {int(k): int(i) for i, k in enumerate(keys)}
    for _ in range(5):
        ops = rng.integers(0, 3, 128).astype(np.int32)
        ks = rng.choice(keys, 128).astype(np.int32)
        vs = rng.integers(0, 100, 128).astype(np.int32)
        want = jalg3.run_threads(init, ops, ks, vs, n_threads)
        got = talg3.run_threads(init, ops, ks, vs, n_threads)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        for a in range(n_threads):
            for b in range(a + 1, n_threads):
                assert not got.ownership[a] & got.ownership[b]
        ref = RefIndex.build(list(init), list(init.values()))
        assert got.results == ref.execute(ops, ks, vs)
        assert got.state == ref.data


def test_alg3_handoff_occurs():
    init = {i * 10: i for i in range(50)}
    ks = np.array([105] * 64, np.int32)
    zeros = np.zeros(64, np.int32)
    res = talg3.run_threads(init, zeros, ks, zeros, 4)
    assert res.handoffs > 0
    assert sum(1 for o in res.ownership if o) == 1


def test_rebalance_matches_jax():
    rng = np.random.default_rng(4)
    fences = np.array([np.iinfo(np.int32).min, 100, 2000, 30_000, 70_000,
                       np.iinfo(np.int32).max], np.int32)
    for smoothing, bounds in ((0.5, {}), (1.0, dict(key_lo=0,
                                                    key_hi=100_000))):
        load = rng.integers(0, 500, 5)
        want = jreb.rebalance_from_load(fences, load, smoothing, **bounds)
        got = treb.rebalance_from_load(fences, load, smoothing, **bounds)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
        assert treb.load_imbalance(load) == jreb.load_imbalance(load)
    sample = rng.integers(0, 1 << 20, 999)
    np.testing.assert_array_equal(
        treb.rebalance_from_sample(sample, 8, 0, 1 << 20),
        jreb.rebalance_from_sample(sample, 8, 0, 1 << 20))
    assert treb.load_imbalance(np.zeros(4)) == 1.0


def test_rebalance_reduces_imbalance_8():
    """``test_core_sharded.test_rebalance_reduces_imbalance_8_devices`` on
    the port: a zipf burst's load re-cuts the fences, and the rebuilt
    index serves the same burst with a lower imbalance."""
    rng = np.random.default_rng(1)
    cfg = tc.PIConfig(capacity=1024, pending_capacity=128, fanout=4,
                      backend="torch")
    keys = rng.choice(100_000, size=1000, replace=False).astype(np.int32)
    state = tc.build_sharded(cfg, 8, keys, np.arange(1000, dtype=np.int32),
                             device="cpu")
    mesh = tc.make_mesh((8,), ("data",), device="cpu")
    zeros = np.zeros(4096, np.int32)
    zipf = (np.random.default_rng(2).zipf(1.5, size=4096) % 100_000) \
        .astype(np.int32)
    state, _, load, _ = tc.execute_sharded(state, mesh, zeros, zipf, zeros)
    i0 = treb.load_imbalance(load.numpy())
    f2 = treb.rebalance_from_load(state.fences.numpy(), load.numpy(),
                                  smoothing=1.0, key_lo=0, key_hi=100_000)
    kk, vv = tc.collect_pairs(state)
    state2 = tc.build_sharded(cfg, 8, kk, vv, fences=f2, device="cpu")
    _, _, load2, _ = tc.execute_sharded(state2, mesh, zeros, zipf, zeros)
    assert treb.load_imbalance(load2.numpy()) < i0


# ---------------------------------------------------------------------------
# the port's sharded durability
# ---------------------------------------------------------------------------

class SimulatedCrash(RuntimeError):
    """Raised out of a port fault point to model the process dying."""


@contextlib.contextmanager
def crash_at(name, hit):
    seen = [0]

    def hook(point):
        if point == name:
            seen[0] += 1
            if seen[0] == hit:
                raise SimulatedCrash(name)

    prev = faults.set_fault_hook(hook)
    try:
        yield seen
    finally:
        faults.set_fault_hook(prev)


def seeded2(backend="cuda"):
    """Two shards of ``test_durability``'s seed index, on the CPU."""
    rng = np.random.default_rng(5)
    keys0 = np.unique(rng.integers(1, 40, 25).astype(np.int32))
    vals0 = rng.integers(0, 1000, keys0.size).astype(np.int32)
    cfg = tc.PIConfig(capacity=1024, pending_capacity=128, fanout=4,
                      backend=backend)
    return tc.build_sharded(cfg, 2, keys0, vals0, device="cpu"), \
        tc.make_mesh((2,), ("data",), device="cpu")


def mk_stream(n, seed):
    rng = np.random.default_rng(seed)
    return (np.arange(n, dtype=np.float64),
            rng.integers(0, 3, n).astype(np.int32),
            rng.integers(1, 40, n).astype(np.int32),
            rng.integers(0, 1000, n).astype(np.int32))


def drive2(d, crash_point=None, hit=1, backend="cuda", n=300, batch=16):
    """``test_durability.drive`` for the port's sharded kind (S = 2)."""
    index, mesh = seeded2(backend)
    t, ops, keys, vals = mk_stream(n, 11)
    sealed, acked, crashed = [], [], False
    ctx = crash_at(crash_point, hit) if crash_point \
        else contextlib.nullcontext()
    try:
        with ctx:
            dur = tp.Durability(d, index, snapshot_every=4)

            def hook(win):
                sealed.append(tp.Window(
                    ops=win.ops.copy(), keys=win.keys.copy(),
                    vals=win.vals.copy(), occupancy=win.occupancy,
                    qids=list(win.qids), slots=win.slots.copy(),
                    t_open=win.t_open, t_enq=win.t_enq.copy(),
                    trigger=win.trigger))
                acked.append(dur.on_seal(win))

            col = tp.Collector(tp.WindowConfig(batch=batch), on_seal=hook)
            disp = tp.Dispatcher(index, mesh=mesh, depth=1, durability=dur)
            for s in range(0, n, batch):
                e = min(n, s + batch)
                for w in col.offer_many(t[s:e], ops[s:e], keys[s:e],
                                        vals[s:e], np.arange(s, e))[1]:
                    disp.submit(w)
            tail = col.take()
            if tail is not None:
                disp.submit(tail)
            disp.flush()
            dur.close()
    except SimulatedCrash:
        crashed = True
    return sealed, acked, crashed


def fresh_replay2(windows, backend="cuda"):
    index, mesh = seeded2(backend)
    disp = tp.Dispatcher(index, mesh=mesh, depth=0)
    for w in windows:
        disp.submit(w)
    return disp.index


@pytest.mark.parametrize("point", faults.FAULT_POINTS)
def test_sharded_crash_point_recovery(tmp_path, point):
    """The acked-prefix contract of ``test_durability`` on the port's
    sharded kind: the recovered index is bit-identical to a crash-free
    sharded dispatcher over the recovered windows."""
    hit = 3 if point.startswith("wal.") else 2
    d = str(tmp_path)
    sealed, acked, crashed = drive2(d, point, hit)
    assert crashed
    with open(os.path.join(d, "durability.json")) as f:
        meta = json.load(f)
    assert (meta["kind"], meta["n_shards"]) == ("sharded", 2)
    step = tckpt.CheckpointManager(os.path.join(d, "ckpt")).latest_step()
    index, replayed = tp.recover(d, device="cpu")
    n_applied = step + len(replayed)
    acked_max = acked[-1] if acked else 0
    assert 0 < acked_max <= n_applied <= len(sealed)
    if point == "wal.mid_append":
        assert n_applied == acked_max
    elif point.startswith("ckpt."):
        assert n_applied == acked_max == len(sealed)
    want = fresh_replay2(sealed[:n_applied])
    assert_leaves(port_leaves(want.shards, want.fences),
                  port_leaves(index.shards, index.fences), point)


@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_sharded_crashfree_roundtrip(tmp_path, backend):
    d = str(tmp_path)
    sealed, acked, crashed = drive2(d, backend=backend)
    assert not crashed and acked[-1] == len(sealed)
    index, replayed = tp.recover(d, device="cpu")
    assert index.shards.config.backend == backend and len(replayed) > 0
    want = fresh_replay2(sealed, backend)
    assert_leaves(port_leaves(want.shards, want.fences),
                  port_leaves(index.shards, index.fences), "roundtrip")
    ref = RefIndex.build(*tc.collect_pairs(seeded2()[0]))
    for w in sealed:
        ref.execute(w.ops[:w.occupancy], w.keys[:w.occupancy],
                    w.vals[:w.occupancy])
    k, v = tc.collect_pairs(index)
    assert dict(zip(k.tolist(), v.tolist())) == ref.data


def test_sharded_durability_across_packages_1(tmp_path):
    """S = 1 in-process: a JAX sharded directory recovers in the port to
    the JAX live leaves, and the port's recovers in the JAX package."""
    jcfg, tcfg = configs("xla", capacity=1024, pending_capacity=64,
                         fanout=4)
    rng = np.random.default_rng(5)
    keys0 = np.unique(rng.integers(1, 40, 25).astype(np.int32))
    vals0 = rng.integers(0, 1000, keys0.size).astype(np.int32)
    t, ops, keys, vals = mk_stream(200, 12)
    stream = types.SimpleNamespace(t=t, ops=ops, keys=keys, vals=vals)
    live = {}
    for pkg, state, mesh in (
            (jp, jdist.build_sharded(jcfg, 1, keys0, vals0), jax_mesh1()),
            (tp, tc.build_sharded(tcfg, 1, keys0, vals0, device="cpu"),
             tc.make_mesh((1,), ("data",), device="cpu"))):
        d = str(tmp_path / pkg.__name__)
        dur = pkg.Durability(d, state, snapshot_every=3)
        disp = pkg.Dispatcher(state, mesh=mesh, depth=1, durability=dur)
        disp.run(stream, collector=pkg.Collector(pkg.WindowConfig(batch=16),
                                                 on_seal=dur.on_seal))
        dur.close()
        live[pkg] = disp.index
    want = jax_leaves(live[jp].shards, live[jp].fences)
    rec, _ = tp.recover(str(tmp_path / jp.__name__), device="cpu")
    assert_leaves(want, port_leaves(rec.shards, rec.fences), "port reads")
    assert_leaves(want, port_leaves(live[tp].shards, live[tp].fences),
                  "live states")
    jrec, _ = jp.recover(str(tmp_path / tp.__name__), mesh=jax_mesh1())
    assert_leaves(want, jax_leaves(jrec.shards, jrec.fences), "JAX reads")


def test_sharded_recover_replays_at_the_recorded_capacity_factor(tmp_path):
    """A dispatcher at capacity factor 4.0 records it in the metadata, and
    ``recover`` replays the WAL at it with no argument: every window is
    on one shard, so the reference's replay at 2.0 overflows the send
    buckets.  A dispatcher at another factor cannot append to the
    directory."""
    cfg = tc.PIConfig(capacity=1024, pending_capacity=128, fanout=4,
                      backend="torch")
    keys0 = np.arange(0, 400, 2, dtype=np.int32)
    state = tc.build_sharded(cfg, 4, keys0, keys0 * 3, device="cpu")
    mesh = tc.make_mesh((4,), ("data",), device="cpu")
    rng = np.random.default_rng(7)
    n = 64                        # four windows, all on shard 0's keys
    stream = types.SimpleNamespace(
        t=np.zeros(n), ops=rng.integers(0, 3, n).astype(np.int32),
        keys=rng.integers(0, 100, n).astype(np.int32),
        vals=rng.integers(0, 1000, n).astype(np.int32))
    d = str(tmp_path)
    dur = tp.Durability(d, state)         # a crash: never closed
    disp = tp.Dispatcher(state, mesh=mesh, depth=0, capacity_factor=4.0,
                         durability=dur)
    disp.run(stream, collector=tp.Collector(tp.WindowConfig(batch=16),
                                            on_seal=dur.on_seal))
    with open(os.path.join(d, "durability.json")) as f:
        assert json.load(f)["capacity_factor"] == 4.0
    rec, replayed = tp.recover(d, device="cpu")
    assert len(replayed) == 4
    assert_leaves(port_leaves(disp.index.shards, disp.index.fences),
                  port_leaves(rec.shards, rec.fences), "recover at 4.0")
    at2 = tp.Dispatcher(state, mesh=mesh, depth=0, capacity_factor=2.0)
    with pytest.raises(tp.DispatchOverflowError):
        at2.submit(tp.record_window(replayed[0]))
    with pytest.raises(ValueError, match="capacity factor 4.0"):
        tp.Dispatcher(rec, mesh=mesh, capacity_factor=2.0,
                      durability=tp.Durability(d, rec))


def test_sharded_snapshot_restores_onto_a_device_tree(tmp_path):
    """Elastic restore of a sharded snapshot: ``shardings`` as a tree of
    devices, as one device, and as a one-device mesh."""
    state, mesh = seeded2()
    m = tckpt.CheckpointManager(str(tmp_path))
    m.save(1, (state.shards, state.fences), blocking=True)
    target = tc.leaf_spec_sharded(state.shards.config, 2)
    want = port_leaves(state.shards, state.fences)
    n = len(tpi.flat_leaves(state.shards))
    tree = (tpi.from_flat_leaves(state.shards.config,
                                 [torch.device("cpu")] * n), "cpu")
    for shardings in (tree, torch.device("cpu"), mesh):
        shards, fences = m.restore(1, target, shardings=shardings)
        assert_leaves(want, port_leaves(shards, fences), repr(shardings))
    with pytest.raises(ValueError, match="shardings"):
        m.restore(1, target, shardings=("cpu",))
