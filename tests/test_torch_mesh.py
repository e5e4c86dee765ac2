"""The port's SPMD layer across ranks against the JAX package's shard_map.

Ranks are processes on the CPU, joined by ``gloo`` (``torch_ranks``):
one group of P = 1, 2, 4 and 8 ranks each, spawned once for the module.
Each runs the fence-sharded index at S = 8 (every window, leaf, rebuild,
``collect_pairs``, a fence re-cut from the gathered load,
``execute_ranges_sharded`` and a sharded ``Dispatcher`` stream); the four ranks also write durability directories
(crash-free and at two fault points) that one and two ranks recover; the
eight ranks run ``moe_apply_shardmap`` on the (2, 2, 2) test mesh,
``pipelined_forward`` on a (4, 2) ("stage", "data") mesh,
``compressed_psum`` over 8 ranks and ``logical_to_spec`` for every
config.  The JAX side runs once, in one subprocess with 8 host devices, on
meshes built as ``jax.sharding.Mesh(np.array(jax.devices()).reshape(...))``
(on jax 0.9.0 a ``jax.make_mesh`` mesh breaks the JAX sharded path,
``tests/test_torch_sharded.py``).  The index is held bit for bit, in every
int32 result and every state leaf in ``PIIndex.tree_flatten`` order, to
the JAX run and to the port in one process without a process group.
"""
import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

import torch_ranks as R
from conftest import REPO

RANKS = [1, 2, 4, 8]

JAX_SCRIPT = r"""
import json, os, time
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from repro import optim, sharding
from repro import pipeline as jp
from repro.configs import ARCH_IDS, get_config, smoke
from repro.core import (PIConfig, build_sharded, collect_pairs,
                        execute_sharded, maybe_rebuild_shards,
                        rebuild_sharded)
from repro.models import moe as moe_mod
from repro.models.pipeline import pipelined_forward, stage_split
from repro.core.rebalance import rebalance_from_load
from repro.models.transformer import model_layout
from repro.pipeline.ranges import execute_ranges_sharded

d = ARGS["dir"]
devs = np.array(jax.devices())
mesh = Mesh(devs, ("data",))
z = dict(np.load(os.path.join(d, "index.npz")))
out = {}


def dump(tag, tree):
    for i, x in enumerate(jax.tree_util.tree_leaves(tree)):
        out[f"{tag}/leaf{i}"] = np.asarray(x)


cfg = PIConfig(backend="xla", **ARGS["geometry"])
st = build_sharded(cfg, 8, z["keys"], z["vals"])
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
    if w == 2:
        cnt, sm = execute_ranges_sharded(
            st, jnp.asarray(z["r_ops"]), jnp.asarray(z["r_lo"]),
            jnp.asarray(z["r_hi"]), ARGS["max_span"])
        out["ranges/cnt"], out["ranges/sum"] = np.asarray(cnt), np.asarray(sm)
shards, ovf, due = maybe_rebuild_shards(st.shards)
dump("maybe", shards)
out["maybe/ovf"], out["maybe/due"] = np.asarray(ovf), np.asarray(due)
out["live"] = np.asarray(st.live_count())
f2 = rebalance_from_load(np.asarray(st.fences), out["w0/load"],
                         smoothing=1.0, key_lo=0, key_hi=100_000)
kk, vv = collect_pairs(st)
st2 = build_sharded(cfg, 8, kk, vv, fences=f2)
dump("recut", (st2.shards, st2.fences))

met = jp.PipelineMetrics()
disp = jp.Dispatcher(built, mesh=mesh, depth=1, clock=lambda: 0.0,
                     max_span=ARGS["max_span"], metrics=met,
                     capacity_factor=ARGS["capacity_factor"])
col = jp.Collector(jp.WindowConfig(**ARGS["window"]))
stream = type("S", (), {k: z["stream_" + k] for k in
                        ("t", "ops", "keys", "vals", "keys2")})
res = disp.run(stream, collector=col, chunk=ARGS["window"]["batch"])
for i, r in enumerate(res):
    for name in ("found", "val", "rcnt", "rsum"):
        if getattr(r, name) is not None:
            out[f"disp{i}/{name}"] = np.asarray(getattr(r, name))
    out[f"disp{i}/meta"] = np.array([r.rebuilt, r.rebuilt_incremental,
                                     r.pending_fill])
out["disp/n"] = np.array(len(res))
out["disp/summary"] = np.array(json.dumps(met.summary(), sort_keys=True))
dump("disp", disp.index.shards)

# moe_apply_shardmap on the (2, 2, 2) test mesh
m = dict(np.load(os.path.join(d, "moe.npz")))
mcfg = smoke(get_config("granite-moe-3b-a800m"))
p = {k: jnp.asarray(m[k]) for k in ("router", "w_gate", "w_up", "w_down")}
x = jnp.asarray(m["x"])
mesh3 = Mesh(devs.reshape(2, 2, 2), ("pod", "data", "model"))
with sharding.use_mesh(mesh3):
    y, lb = jax.jit(lambda xx: moe_mod.moe_apply_shardmap(mcfg, p, xx))(x)
out["moe/y"], out["moe/lb"] = np.asarray(y), np.asarray(lb)

# compressed_psum over 8 devices
ps = dict(np.load(os.path.join(d, "psum.npz")))
mesh_all = Mesh(devs, ("all",))
def body(xb, eb):
    mean, err = optim.compressed_psum(xb[0], "all", eb[0])
    return mean[None], err[None]
mean, err = jax.jit(sharding.shard_map(
    body, mesh=mesh_all, in_specs=(P("all"), P("all")),
    out_specs=(P("all"), P("all")), check_vma=False))(
    jnp.asarray(ps["x"]), jnp.asarray(ps["err"]))
out["psum/mean"], out["psum/err"] = np.asarray(mean), np.asarray(err)
out["psum/q"] = np.stack([np.asarray(optim.quantize_int8(
    jnp.asarray(ps["x"][r]) + jnp.asarray(ps["err"][r]))[0])
    for r in range(8)])

# pipelined_forward on a (4, 2) ("stage", "data") mesh, M > S and M == S
pz = dict(np.load(os.path.join(d, "pipe.npz")))
Sg = ARGS["stages"]
mesh_pipe = Mesh(devs.reshape(Sg, 2), ("stage", "data"))
W, xs = jnp.asarray(pz["W"]), jnp.asarray(pz["x"])
def stage_fn(p_stage, h):
    return jax.lax.scan(lambda h, w: (jnp.tanh(h @ w), None), h, p_stage)[0]
out["pipe/y"] = np.asarray(pipelined_forward(
    mesh_pipe, "stage", stage_fn, stage_split(W, Sg), xs))
out["pipe/y_sm"] = np.asarray(pipelined_forward(
    mesh_pipe, "stage", stage_fn, stage_split(W, Sg), xs[:Sg]))

# logical_to_spec for every config on both test meshes
table = {}
for multi in (False, True):
    shape = (2, 2, 2) if multi else (4, 2)
    axes = ("pod", "data", "model") if multi else ("data", "model")
    tm = Mesh(devs.reshape(shape), axes)
    for rname, rules in (("default", sharding.DEFAULT_RULES),
                         ("sp", sharding.with_rules({"seq": "model"}))):
        for arch in ARCH_IDS:
            for k, pd in sorted(model_layout(get_config(arch)).items()):
                spec = sharding.logical_to_spec(pd.logical, rules, tm,
                                                pd.shape)
                table[f"{multi}/{rname}/{arch}/{k}"] = [
                    list(e) if isinstance(e, tuple) else e for e in spec]
out["specs"] = np.array(json.dumps(table, sort_keys=True))

# the directory four ranks of the port wrote, recovered here
done = os.path.join(d, "port4.done")
t_end = time.monotonic() + ARGS["wait"]
while not os.path.exists(done):
    assert time.monotonic() < t_end, "the four ranks never finished"
    time.sleep(0.1)
rec, replayed = jp.recover(os.path.join(d, "port4"), mesh=mesh)
dump("recjax/port4", (rec.shards, rec.fences))
np.savez(os.path.join(d, "jax.npz"), **out)
print("OK")
"""


def leaves(z, tag):
    n = sum(1 for k in z if k.startswith(tag + "/leaf"))
    assert n, tag
    return [z[f"{tag}/leaf{i}"] for i in range(n)]


def same_leaves(want, got, tag):
    assert len(want) == len(got), f"{tag}: {len(want)} != {len(got)}"
    for i, (w, g) in enumerate(zip(want, got)):
        assert w.dtype == g.dtype, f"{tag}: leaf {i} dtype"
        np.testing.assert_array_equal(w, g, err_msg=f"{tag}: leaf {i}")


def load(d, name):
    with np.load(os.path.join(d, name)) as z:
        return dict(z)


def crash_references(inp, built, mesh):
    """The one-process states after each window of the stream (index 0:
    the build), by a dispatcher without durability."""
    from repro_torch import pipeline as tp
    states = [built]
    hook = types.SimpleNamespace(on_seal=lambda w: None,
                                 maybe_snapshot=lambda idx, seq:
                                 states.append(idx),
                                 record_capacity_factor=lambda cf: None)
    disp = tp.Dispatcher(built, mesh=mesh, depth=0, clock=lambda: 0.0,
                         max_span=R.MAX_SPAN,
                         capacity_factor=R.CAPACITY_FACTOR, durability=hook)
    disp.run(R.stream_of(inp), tp.WindowConfig(**R.WINDOW),
             chunk=R.WINDOW["batch"])
    return states


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("mesh"))
    R.write_inputs(d)
    args = dict(dir=d, geometry=R.GEOMETRY, n_windows=R.N_WINDOWS,
                max_span=R.MAX_SPAN, capacity_factor=R.CAPACITY_FACTOR,
                window=R.WINDOW, stages=R.PIPE["S"], wait=300)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.path.join(REPO, "src"))
    jax_log = open(os.path.join(d, "jax-log.txt"), "w+")
    jax_proc = subprocess.Popen(
        [sys.executable, "-c", f"ARGS = {json.dumps(args)}\n" + JAX_SCRIPT],
        env=env, stdout=jax_log, stderr=subprocess.STDOUT, text=True)
    threads = torch.get_num_threads()
    try:
        R.wait(R.spawn(4, d, ["index", "durable"], "p4"), 300)
        open(os.path.join(d, "port4.done"), "w").close()
        groups = [R.spawn(1, d, ["index", "recover"], "p1"),
                  R.spawn(2, d, ["index", "recover", "diverge"], "p2"),
                  R.spawn(8, d, ["index", "mesh8"], "p8")]
        # meanwhile, the port in one process without a process group, on
        # one thread beside the ranks
        torch.set_num_threads(1)
        inp = load(d, "index.npz")
        one = {}
        built, mesh = R.index_program(inp, None, one, d)
        R.recover_program(None, one, d, "rec0")
        states = crash_references(inp, built, mesh)
        from repro_torch import pipeline as tp
        dur = tp.Durability(os.path.join(d, "port1"), built,
                            snapshot_every=R.SNAPSHOT_EVERY)
        disp, _, _ = R.serve(built, mesh, R.stream_of(inp), dur)
        dur.close()
        R._leaves(one, "dur/live", disp.index, disp.index.fences)
        for g in groups:
            R.wait(g, 300)
        jax_proc.wait(timeout=400)
    finally:
        torch.set_num_threads(threads)
        if jax_proc.poll() is None:
            jax_proc.kill()
    jax_log.seek(0)
    assert jax_proc.returncode == 0, jax_log.read()
    ranks = {P: [load(d, f"p{P}-rank{r}.npz") for r in range(P)]
             for P in RANKS}
    return types.SimpleNamespace(dir=d, jax=load(d, "jax.npz"), one=one,
                                 ranks=ranks, states=states, inp=inp)


WINDOW_TAGS = [f"w{w}" for w in range(R.N_WINDOWS)]


@pytest.mark.parametrize("P", RANKS)
def test_execute_sharded_across_ranks(runs, P):
    """Every window's found/val/load/dropped on every rank, and the
    gathered leaves after the build and after each window, equal the JAX
    S = 8 run and the port in one process."""
    r0 = runs.ranks[P][0]
    for ref in (runs.jax, runs.one):
        same_leaves(leaves(ref, "build"), leaves(r0, "build"), "build")
        for tag in WINDOW_TAGS:
            for name in ("found", "val", "load", "dropped"):
                w = ref[f"{tag}/{name}"]
                for rk in runs.ranks[P]:
                    np.testing.assert_array_equal(
                        w.astype(rk[f"{tag}/{name}"].dtype),
                        rk[f"{tag}/{name}"], err_msg=f"{tag}/{name}")
            same_leaves(leaves(ref, tag), leaves(r0, tag), tag)
    assert runs.jax["w3/dropped"].sum() > 0     # a window that drops
    assert runs.jax["w4/dropped"].sum() == 0    # padding only: not counted


@pytest.mark.parametrize("P", RANKS)
def test_rebuild_sweep_across_ranks(runs, P):
    """``rebuild_sharded`` and ``maybe_rebuild_shards`` (the due flags
    gathered from every rank) leave the JAX leaves."""
    r0 = runs.ranks[P][0]
    for ref in (runs.jax, runs.one):
        same_leaves(leaves(ref, "rebuild"), leaves(r0, "rebuild"),
                    "rebuild")
        same_leaves(leaves(ref, "maybe"), leaves(r0, "maybe"), "maybe")
        for rk in runs.ranks[P]:
            assert bool(rk["maybe/ovf"]) == bool(ref["maybe/ovf"])
            assert bool(rk["maybe/due"]) == bool(ref["maybe/due"])
    assert bool(runs.jax["maybe/due"])


@pytest.mark.parametrize("P", RANKS)
def test_collect_pairs_across_ranks(runs, P):
    for ref in (runs.jax, runs.one):
        for rk in runs.ranks[P]:
            for name in ("pairs/k", "pairs/v", "live"):
                np.testing.assert_array_equal(
                    ref[name], rk[name].astype(ref[name].dtype),
                    err_msg=name)


@pytest.mark.parametrize("P", RANKS)
def test_float_keys_across_ranks(runs, P):
    """float32 keys cross the exchange as their bits: a window's results
    and the leaves equal the one-process port's."""
    r0 = runs.ranks[P][0]
    assert runs.one["f32/found"].any()
    for rk in runs.ranks[P]:
        for name in ("f32/found", "f32/val"):
            np.testing.assert_array_equal(runs.one[name], rk[name])
    same_leaves(leaves(runs.one, "f32"), leaves(r0, "f32"), "f32")


def test_ranks_that_diverge_fail_loudly(runs):
    """Two ranks that submit different windows both raise, after the
    window's collectives, instead of serving different results."""
    for rk in runs.ranks[2]:
        assert "ranks ran different windows" in str(rk["diverge"])


@pytest.mark.parametrize("P", RANKS)
def test_fence_recut_across_ranks(runs, P):
    """Fences re-cut from a window's gathered load, and each rank's
    shards rebuilt from the gathered pairs on them: the JAX leaves."""
    r0 = runs.ranks[P][0]
    fences = [leaves(runs.jax, tag)[-1] for tag in ("build", "recut")]
    assert not np.array_equal(*fences)             # the fences moved
    for ref in (runs.jax, runs.one):
        same_leaves(leaves(ref, "recut"), leaves(r0, "recut"), "recut")


@pytest.mark.parametrize("P", RANKS)
def test_execute_ranges_sharded_across_ranks(runs, P):
    """Each rank's partials, gathered and summed in shard order, equal
    the JAX int32 sums on a state with pending keys and tombstones."""
    assert (runs.jax["ranges/cnt"] > 0).sum() > 100
    for ref in (runs.jax, runs.one):
        for rk in runs.ranks[P]:
            for name in ("ranges/cnt", "ranges/sum"):
                np.testing.assert_array_equal(ref[name], rk[name],
                                              err_msg=name)


@pytest.mark.parametrize("P", RANKS)
def test_dispatcher_across_ranks(runs, P):
    """The sharded ``Dispatcher`` over a bursty stream with ranges: every
    retired window, the metrics and the final leaves."""
    n = int(runs.jax["disp/n"])
    assert n > 3
    for ref in (runs.jax, runs.one):
        for rk in runs.ranks[P]:
            assert int(rk["disp/n"]) == n
            for i in range(n):
                for name in ("found", "val", "rcnt", "rsum", "meta"):
                    key = f"disp{i}/{name}"
                    assert (key in ref) == (key in rk), key
                    if key in ref:
                        np.testing.assert_array_equal(
                            ref[key], rk[key].astype(ref[key].dtype),
                            err_msg=key)
            assert str(rk["disp/summary"]) == str(ref["disp/summary"])
        same_leaves(leaves(ref, "disp"), leaves(runs.ranks[P][0], "disp"),
                    "disp")


@pytest.mark.parametrize("where", ["P1", "P2", "one-process", "jax"])
def test_durability_written_by_four_ranks_recovers(runs, where):
    """Four ranks write the directory one process would (every WAL byte
    and every snapshot leaf); it recovers on one and two ranks, in one
    process and in the JAX package to the live state of the four."""
    four = runs.ranks[4][0]
    live = leaves(four, "dur/live")
    same_leaves(leaves(runs.one, "dur/live"), live, "live")
    got = {"P1": runs.ranks[1][0], "P2": runs.ranks[2][0],
           "one-process": runs.one, "jax": runs.jax}[where]
    tag = {"P1": "rec1", "P2": "rec2", "one-process": "rec0",
           "jax": "recjax"}[where]
    same_leaves(live, leaves(got, f"{tag}/port4"), where)
    if where == "one-process":
        from repro_torch.checkpoint import CheckpointManager
        a, b = (os.path.join(runs.dir, x) for x in ("port4", "port1"))
        for sub in ("wal",):
            names = sorted(os.listdir(os.path.join(a, sub)))
            assert names == sorted(os.listdir(os.path.join(b, sub)))
            for f in names:
                with open(os.path.join(a, sub, f), "rb") as fa, \
                        open(os.path.join(b, sub, f), "rb") as fb:
                    assert fa.read() == fb.read(), f
        steps = CheckpointManager(os.path.join(a, "ckpt")).all_steps()
        assert steps == CheckpointManager(os.path.join(b, "ckpt")) \
            .all_steps()
        for s in steps:
            za, zb = (load(os.path.join(x, "ckpt", f"step_{s}"), "host0.npz")
                      for x in (a, b))
            same_leaves([za[k] for k in sorted(za)],
                        [zb[k] for k in sorted(zb)], f"step {s}")
        with open(os.path.join(a, "durability.json")) as fa, \
                open(os.path.join(b, "durability.json")) as fb:
            assert fa.read() == fb.read()


@pytest.mark.parametrize("point", [p for p, _, _ in R.CRASHES])
def test_crash_across_four_ranks_recovers(runs, point):
    """Four ranks stop at the same fault point (a sync at a segment
    rotation too); one and two ranks recover the state a dispatcher
    without durability reaches over the windows recovered."""
    from repro_torch.core import distributed as dist
    from repro_torch.core import index as tpi
    name = f"crash4-{point}"
    for tag, got in (("rec1", runs.ranks[1][0]), ("rec2", runs.ranks[2][0]),
                     ("rec0", runs.one)):
        n = int(got[f"{tag}/{name}/applied"])
        assert 0 < n < len(runs.states) - 1, (tag, n)
        st = runs.states[n]
        want = [x.numpy() for x in tpi.flat_leaves(
            dist.gather_shards(st.shards, st.group))] + [st.fences.numpy()]
        same_leaves(want, leaves(got, f"{tag}/{name}"), f"{tag} {point}")


def test_interval_fsync_refused_across_ranks(runs):
    """A time-based fsync cannot be mirrored by the ranks that do not
    write: every rank of four refuses it before touching the directory."""
    for rk in runs.ranks[4]:
        assert 'fsync="interval"' in str(rk["interval"])
    assert not os.path.exists(os.path.join(runs.dir, "interval4"))


def test_moe_shardmap_refuses_backward_across_ranks(runs):
    """Its collectives now carry the gradient: on the mesh of eight ranks
    every rank's gradient of sum(y^2) + lb_loss, for x and every weight,
    lies within 1e-5 of each leaf's largest of the port's one-process
    ``moe_apply`` (drop-free at this size)."""
    from repro_torch.configs import get_config, smoke
    from repro_torch.models import moe
    z = load(runs.dir, "moe.npz")
    cfg = smoke(get_config("granite-moe-3b-a800m"))
    leaves = [torch.from_numpy(z[k]).requires_grad_()
              for k in ("x",) + R.MOE_LEAVES]
    y, lb = moe.moe_apply(cfg, dict(zip(R.MOE_LEAVES, leaves[1:])),
                          leaves[0])
    want = torch.autograd.grad(y.square().sum() + lb, leaves)
    for rk in runs.ranks[8]:
        for k, w in zip(("x",) + R.MOE_LEAVES, want):
            w = w.numpy()
            np.testing.assert_allclose(rk[f"moe/grad/{k}"], w, rtol=0,
                                       atol=1e-5 * np.abs(w).max(),
                                       err_msg=k)


def test_moe_shardmap_across_ranks(runs):
    """granite-moe's smoke expert layer on the (2, 2, 2) mesh, float32,
    drop-free: within 1e-5 of the largest |y| of the reference's shard_map
    and of the port's one-process ``moe_apply``; ``lb_loss`` 1e-6."""
    from repro_torch.configs import get_config, smoke
    from repro_torch.models import moe
    z = load(runs.dir, "moe.npz")
    cfg = smoke(get_config("granite-moe-3b-a800m"))
    p = {k: torch.from_numpy(z[k]) for k in
         ("router", "w_gate", "w_up", "w_down")}
    y0, lb0 = moe.moe_apply(cfg, p, torch.from_numpy(z["x"]))
    want = runs.jax["moe/y"]
    tol = 1e-5 * np.abs(want).max()
    for rk in runs.ranks[8]:
        np.testing.assert_allclose(rk["moe/y"], want, rtol=0, atol=tol)
        np.testing.assert_allclose(rk["moe/y"], y0.numpy(), rtol=0, atol=tol)
        assert abs(float(rk["moe/lb"]) - float(runs.jax["moe/lb"])) <= 1e-6
        assert abs(float(rk["moe/lb"]) - lb0.item()) <= 1e-6


def test_compressed_psum_across_ranks(runs):
    """Over 8 ranks: each rank's int8 ``q`` bit for bit, the mean and the
    carried error within 1e-6 of the reference's over 8 devices."""
    for r, rk in enumerate(runs.ranks[8]):
        np.testing.assert_array_equal(rk["psum/q"], runs.jax["psum/q"][r])
        np.testing.assert_allclose(rk["psum/mean"], runs.jax["psum/mean"][r],
                                   rtol=0, atol=1e-6)
        np.testing.assert_allclose(rk["psum/err"], runs.jax["psum/err"][r],
                                   rtol=0, atol=1e-6)


@pytest.mark.parametrize("name", ["y", "y_sm"], ids=["M>S", "M==S"])
def test_pipelined_forward_across_ranks(runs, name):
    """GPipe over a 4-stage axis of the (4, 2) mesh: within 1e-5 of the
    reference's and of the stages run in sequence."""
    z = load(runs.dir, "pipe.npz")
    h = torch.from_numpy(z["x"])
    for w in torch.from_numpy(z["W"]):
        h = torch.tanh(h @ w)
    seq = h.numpy()[:runs.jax[f"pipe/{name}"].shape[0]]
    for rk in runs.ranks[8]:
        got = rk[f"pipe/{name}"]
        np.testing.assert_allclose(got, runs.jax[f"pipe/{name}"], rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(got, seq, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("multi", ["False", "True"],
                         ids=["(4,2)", "(2,2,2)"])
def test_logical_to_spec_matches_reference(runs, multi):
    """Every config's parameters, default rules and sequence parallelism,
    on both test meshes: the reference's ``PartitionSpec`` entry for
    entry."""
    want = json.loads(str(runs.jax["specs"]))
    got = json.loads(str(runs.ranks[8][0]["specs"]))
    keys = [k for k in want if k.startswith(multi + "/")]
    assert len(keys) > 100
    assert {k: got[k] for k in keys} == {k: want[k] for k in keys}
    assert any(e is not None for k in keys for e in want[k])


def test_mesh_shapes_and_refusals(runs):
    """The test mesh's shape and names; a production mesh on eight ranks
    is a ``ValueError``; under a mesh of several ranks ``constrain``
    redistributes a DTensor to the rules' placements (each rank's block
    of the (8, 4) arange: rows by "data", columns by "model") and
    refuses a plain tensor, ``named_sharding`` and ``tree_shardings``
    give ``(mesh, placements)``."""
    full = np.arange(32.0).reshape(8, 4)
    for r, rk in enumerate(runs.ranks[8]):
        assert rk["mesh/shape"].tolist() == [4, 2]
        assert json.loads(str(rk["mesh/names"])) == ["data", "model"]
        assert rk["mesh/axis"].tolist() == [4, 2]
        msgs = json.loads(str(rk["mesh/refusals"]))
        assert len(msgs) == 2 and "256 ranks" in msgs[0]
        assert "plain tensor" in msgs[1]
        i, j = divmod(r, 2)
        np.testing.assert_array_equal(rk["mesh/constrain"],
                                      full[2 * i:2 * i + 2, 2 * j:2 * j + 2])
        y, pl, w, v, same = json.loads(str(rk["mesh/placements"]))
        assert y == pl == "(Shard(dim=0), Shard(dim=1))"
        assert w == "(Shard(dim=0), Replicate())"
        assert v == "(Replicate(), Shard(dim=0))" and same


def test_stray_local_block_raises_under_mesh(runs):
    """Under a mesh of several ranks a rank's own block taken out of a
    DTensor (``to_local``), or a plain constant, that meets a DTensor in
    an op raises: nothing takes a plain tensor as replicated.  A constant
    declared replicated (``sharding.replicated``) combines blockwise."""
    full = np.arange(32.0).reshape(8, 4)
    for r, rk in enumerate(runs.ranks[8]):
        stray = json.loads(str(rk["mesh/stray"]))
        assert len(stray) == 2
        for msg in stray:
            assert "mixed torch.Tensor and DTensor" in msg, msg
        i, j = divmod(r, 2)
        np.testing.assert_array_equal(
            rk["mesh/declared"], 2 * full[2 * i:2 * i + 2, 2 * j:2 * j + 2])
