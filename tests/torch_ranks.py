"""Rank harness for the port's SPMD tests: P processes on the CPU, ``gloo``.

``spawn`` starts one Python process a rank (``python tests/torch_ranks.py
ARGS``), each joining a process group through a ``FileStore`` under the
test's temporary directory, every process group with ``TIMEOUT``; ``wait``
fails the test with the ranks' output when any rank fails or outlives its
limit, and kills the rest.  A rank runs the programs named in ARGS and
writes what the test compares to ``rank<r>.npz``.

The programs mirror the reference's ``shard_map`` tests at S = 8 shards:
the fence-sharded index (windows, rebuilds, ``collect_pairs``, ranges, the
sharded ``Dispatcher``, durability written by four ranks and recovered by
others), and, on eight ranks, ``moe_apply_shardmap``, ``compressed_psum``,
``pipelined_forward`` and ``logical_to_spec`` on the test meshes.  The LM
programs (``lm8``, ``lm2``, ``train2``) place the language model's state
over a mesh and train, prefill, decode, differentiate the expert layer and
restore checkpoints there (``tests/test_torch_lm_mesh.py``).
"""
import contextlib
import datetime
import json
import os
import subprocess
import sys
import time
import traceback
import types

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
TIMEOUT = datetime.timedelta(seconds=90)     # every process group's

S = 8
GEOMETRY = dict(capacity=1024, pending_capacity=128, fanout=4)
N_WINDOWS = 5
WINDOW = dict(batch=128, deadline=4e-4)
CAPACITY_FACTOR = 4.0
MAX_SPAN = 512
SNAPSHOT_EVERY = 3
# (fault point, pass, Durability options): one-record segments make rank
# 0's WAL sync twice a window, at the window and at the rotation
CRASHES = (("wal.after_append", 3, {}), ("ckpt.pre_rename", 2, {}),
           ("wal.pre_sync", 4, {"segment_bytes": 1}))
PIPE = dict(S=4, M=8, mb=2, d=16, L=8)


class SimulatedCrash(Exception):
    pass


# ---------------------------------------------------------------------------
# inputs (numpy, from seeds)
# ---------------------------------------------------------------------------

def index_inputs():
    """An index of 1000 keys, five windows of 512, range lanes and an
    arrival stream with ranges (``test_torch_sharded.inputs8``'s
    scenario)."""
    from repro_torch import data
    from repro_torch import pipeline as tp
    from repro_torch.core import INSERT, RANGE, SEARCH
    rng = np.random.default_rng(1)
    B = 512
    keys = rng.choice(100_000, size=1000, replace=False).astype(np.int32)
    inp = dict(keys=keys, vals=np.arange(1000, dtype=np.int32))
    pool = np.concatenate([keys, rng.integers(0, 100_000, 500)
                           .astype(np.int32)])
    for w in range(3):
        inp[f"w{w}_ops"] = rng.integers(0, 3, B).astype(np.int32)
        inp[f"w{w}_keys"] = rng.choice(pool, B).astype(np.int32)
        inp[f"w{w}_vals"] = rng.integers(0, 1000, B).astype(np.int32)
    # every query on shard 0: its buckets overflow, real queries drop
    inp["w3_ops"] = rng.integers(0, 3, B).astype(np.int32)
    inp["w3_keys"] = rng.choice(np.sort(keys)[:125], B).astype(np.int32)
    inp["w3_vals"] = rng.integers(0, 1000, B).astype(np.int32)
    # after the rebuild: inserts on shards 0-2 only, the rest padding
    real = np.arange(B) < 3 * B // 8
    perm = rng.permutation(B)
    inp["w4_ops"] = np.where(real, INSERT, SEARCH).astype(np.int32)[perm]
    inp["w4_keys"] = np.where(real, rng.integers(0, np.sort(keys)[375], B),
                              np.iinfo(np.int32).max).astype(np.int32)[perm]
    inp["w4_vals"] = rng.integers(0, 1000, B).astype(np.int32)
    lo = rng.integers(0, 100_000, 256).astype(np.int32)
    inp["r_ops"] = np.where(rng.random(256) < 0.8, RANGE, SEARCH) \
        .astype(np.int32)
    inp["r_lo"] = lo
    inp["r_hi"] = (lo + rng.integers(0, 30_000, 256)).astype(np.int32)
    ycfg = data.YCSBConfig(n_keys=300, key_space=100_000, write_ratio=0.5,
                           theta=0.5, seed=4)
    stream = tp.make_arrivals(
        tp.ArrivalConfig(process="bursty", rate=1e5, n_arrivals=640,
                         range_frac=0.2, span_min=1, span_max=20_000,
                         seed=2), ycfg, keys)
    for k in ("t", "ops", "keys", "vals", "keys2"):
        inp["stream_" + k] = getattr(stream, k)
    return inp


def stream_of(inp):
    return types.SimpleNamespace(**{k: inp["stream_" + k] for k in
                                    ("t", "ops", "keys", "vals", "keys2")})


def moe_inputs():
    """granite-moe's ``smoke()`` expert layer and tokens, float32."""
    from repro_torch.configs import get_config, smoke
    cfg = smoke(get_config("granite-moe-3b-a800m"))
    rng = np.random.default_rng(0)
    d, f, Ep = cfg.d_model, cfg.d_ff_expert, cfg.experts_padded
    return dict(
        x=rng.normal(size=(8, 16, d)).astype(np.float32),
        router=(rng.normal(size=(d, cfg.n_experts)) / np.sqrt(d))
        .astype(np.float32),
        w_gate=(rng.normal(size=(Ep, d, f)) / np.sqrt(d)).astype(np.float32),
        w_up=(rng.normal(size=(Ep, d, f)) / np.sqrt(d)).astype(np.float32),
        w_down=(rng.normal(size=(Ep, f, d)) / np.sqrt(f)).astype(np.float32))


def psum_inputs(world=8):
    rng = np.random.default_rng(3)
    return dict(x=rng.normal(size=(world, 300)).astype(np.float32),
                err=(1e-3 * rng.normal(size=(world, 300))).astype(np.float32))


def pipe_inputs():
    rng = np.random.default_rng(0)
    d, L, M, mb = PIPE["d"], PIPE["L"], PIPE["M"], PIPE["mb"]
    return dict(W=(rng.normal(size=(L, d, d)) / np.sqrt(d)).astype(np.float32),
                x=rng.normal(size=(M, mb, d)).astype(np.float32))


def write_inputs(directory):
    np.savez(os.path.join(directory, "index.npz"), **index_inputs())
    np.savez(os.path.join(directory, "moe.npz"), **moe_inputs())
    np.savez(os.path.join(directory, "psum.npz"), **psum_inputs())
    np.savez(os.path.join(directory, "pipe.npz"), **pipe_inputs())


# ---------------------------------------------------------------------------
# the port's side (a rank, or one process without a process group)
# ---------------------------------------------------------------------------

def _leaves(out, tag, shards, fences=None):
    from repro_torch.core import distributed as dist
    from repro_torch.core import index as tpi
    full = dist.gather_shards(shards.shards if hasattr(shards, "shards")
                              else shards, getattr(shards, "group", None))
    xs = tpi.flat_leaves(full) + ([fences] if fences is not None else [])
    for i, x in enumerate(xs):
        out[f"{tag}/leaf{i}"] = x.cpu().numpy()


def index_program(inp, device_mesh, out, directory):
    """The index scenario on this rank (``device_mesh`` None: one process
    without a process group)."""
    from repro_torch import core as tc
    from repro_torch import pipeline as tp
    from repro_torch.core import distributed as dist
    mesh = tc.make_mesh((S,), ("data",), device="cpu",
                        device_mesh=device_mesh)
    cfg = tc.PIConfig(backend="torch", **GEOMETRY)
    st = tc.build_sharded(cfg, S, inp["keys"], inp["vals"], mesh=mesh)
    built = st
    _leaves(out, "build", st, st.fences)
    for w in range(N_WINDOWS):
        if w == N_WINDOWS - 1:
            out["pairs/k"], out["pairs/v"] = tc.collect_pairs(st)
            st = tc.rebuild_sharded(st)
            _leaves(out, "rebuild", st)
        st, (f, v), load, drop = tc.execute_sharded(
            st, mesh, inp[f"w{w}_ops"], inp[f"w{w}_keys"], inp[f"w{w}_vals"],
            capacity_factor=2.0)
        for name, x in (("found", f), ("val", v), ("load", load),
                        ("dropped", drop)):
            out[f"w{w}/{name}"] = x.cpu().numpy()
        _leaves(out, f"w{w}", st)
        if w == 2:
            cnt, sm = tp.execute_ranges_sharded(
                st, inp["r_ops"], inp["r_lo"], inp["r_hi"], MAX_SPAN)
            out["ranges/cnt"], out["ranges/sum"] = cnt.numpy(), sm.numpy()
    shards, ovf, due = tc.maybe_rebuild_shards(st.shards, st.group)
    _leaves(out, "maybe", dist.ShardedPIIndex(shards, st.fences, S,
                                              st.group))
    out["maybe/ovf"], out["maybe/due"] = np.asarray(ovf), np.asarray(due)
    out["live"] = st.live_count().numpy()
    # a fence re-cut from the gathered loads: every rank rebuilds its own
    # shards from the gathered pairs on the same fences
    f2 = tc.rebalance_from_load(st.fences.numpy(), out["w0/load"],
                                smoothing=1.0, key_lo=0, key_hi=100_000)
    kk, vv = tc.collect_pairs(st)
    st2 = tc.build_sharded(cfg, S, kk, vv, fences=f2, mesh=mesh)
    _leaves(out, "recut", st2, st2.fences)

    # float32 keys: the exchange carries a key's bits in an int32 word
    fcfg = tc.PIConfig(backend="torch", key_dtype="float32", **GEOMETRY)
    fst = tc.build_sharded(fcfg, S, inp["keys"].astype(np.float32) / 7,
                           inp["vals"], mesh=mesh)
    fst, (f, v), _, _ = tc.execute_sharded(
        fst, mesh, inp["w0_ops"], inp["w0_keys"].astype(np.float32) / 7,
        inp["w0_vals"])
    out["f32/found"], out["f32/val"] = f.numpy(), v.numpy()
    _leaves(out, "f32", fst, fst.fences)

    disp, met, res = serve(built, mesh, stream_of(inp))
    for i, r in enumerate(res):
        for name in ("found", "val", "rcnt", "rsum"):
            if getattr(r, name) is not None:
                out[f"disp{i}/{name}"] = np.asarray(getattr(r, name))
        out[f"disp{i}/meta"] = np.array([r.rebuilt, r.rebuilt_incremental,
                                         r.pending_fill])
    out["disp/n"] = np.array(len(res))
    out["disp/summary"] = np.array(json.dumps(met.summary(), sort_keys=True))
    _leaves(out, "disp", disp.index)
    return built, mesh


def serve(index, mesh, stream, durability=None):
    from repro_torch import pipeline as tp
    met = tp.PipelineMetrics()
    disp = tp.Dispatcher(index, mesh=mesh, depth=1, clock=lambda: 0.0,
                         max_span=MAX_SPAN, metrics=met,
                         capacity_factor=CAPACITY_FACTOR,
                         durability=durability)
    col = tp.Collector(tp.WindowConfig(**WINDOW),
                       on_seal=durability.on_seal if durability else None)
    res = disp.run(stream, collector=col, chunk=WINDOW["batch"])
    return disp, met, res


def durable_program(built, mesh, inp, out, directory):
    """Four ranks write a durability directory crash-free, and one a
    crash point (each rank passes the same fault points)."""
    from repro_torch import faults
    from repro_torch import pipeline as tp
    d = os.path.join(directory, "port4")
    dur = tp.Durability(d, built, snapshot_every=SNAPSHOT_EVERY)
    disp, _, _ = serve(built, mesh, stream_of(inp), dur)
    dur.close()
    _leaves(out, "dur/live", disp.index, disp.index.fences)
    try:
        tp.Durability(os.path.join(directory, "interval4"), built,
                      fsync="interval")
        out["interval"] = np.array("no error")
    except ValueError as e:
        out["interval"] = np.array(str(e))
    for point, hit, opts in CRASHES:
        hits = [0]

        def hook(name, point=point, hit=hit):
            if name == point:
                hits[0] += 1
                if hits[0] == hit:
                    raise SimulatedCrash(name)

        prev = faults.set_fault_hook(hook)
        try:
            dur = tp.Durability(os.path.join(directory, f"crash4-{point}"),
                                built, snapshot_every=SNAPSHOT_EVERY, **opts)
            try:
                serve(built, mesh, stream_of(inp), dur)
                raise AssertionError(f"{point} was not reached")
            except SimulatedCrash:
                pass
        finally:
            faults.set_fault_hook(prev)


def diverge_program(built, mesh, inp, out):
    """Each rank submits another window: every rank must raise."""
    from repro_torch import pipeline as tp
    rank = mesh.device_mesh.get_rank()
    col = tp.Collector(tp.WindowConfig(batch=64))
    for i in range(4):
        col.offer(0.0, 0, int(inp["keys"][rank * 4 + i]), 0, i)
    disp = tp.Dispatcher(built, mesh=mesh, depth=0, clock=lambda: 0.0)
    try:
        disp.submit(col.take())
        out["diverge"] = np.array("no error")
    except RuntimeError as e:
        out["diverge"] = np.array(str(e))


def recover_program(mesh, out, directory, tag):
    """Recover the directories four ranks wrote, on this mesh."""
    from repro_torch import pipeline as tp
    from repro_torch.checkpoint import CheckpointManager
    for name in ["port4"] + [f"crash4-{p}" for p, _, _ in CRASHES]:
        d = os.path.join(directory, name)
        rec, tail = tp.recover(d, mesh=mesh, device="cpu")
        step = CheckpointManager(os.path.join(d, "ckpt")).latest_step()
        _leaves(out, f"{tag}/{name}", rec, rec.fences)
        out[f"{tag}/{name}/applied"] = np.array(step + len(tail))


def moe_program(device_mesh, out, directory):
    import torch
    from repro_torch import sharding as shd
    from repro_torch.configs import get_config, smoke
    from repro_torch.models import moe
    z = dict(np.load(os.path.join(directory, "moe.npz")))
    cfg = smoke(get_config("granite-moe-3b-a800m"))
    p = {k: torch.from_numpy(z[k]) for k in
         ("router", "w_gate", "w_up", "w_down")}
    x = torch.from_numpy(z["x"])
    with shd.use_mesh(device_mesh):
        y, lb = moe.moe_apply_shardmap(cfg, p, x)
        # with a gradient: of sum(y^2) + lb_loss, for x and every weight
        leaves = [x.clone().requires_grad_()] + \
            [p[k].clone().requires_grad_() for k in MOE_LEAVES]
        y2, lb2 = moe.moe_apply_shardmap(
            cfg, dict(zip(MOE_LEAVES, leaves[1:])), leaves[0])
        grads = torch.autograd.grad(y2.square().sum() + lb2, leaves)
    out["moe/y"], out["moe/lb"] = y.numpy(), np.asarray(lb.item())
    for k, g in zip(("x",) + MOE_LEAVES, grads):
        out[f"moe/grad/{k}"] = g.numpy()


MOE_LEAVES = ("router", "w_gate", "w_up", "w_down")


def psum_program(device_mesh, out, directory):
    import torch
    from repro_torch import optim
    from repro_torch import sharding as shd
    z = dict(np.load(os.path.join(directory, "psum.npz")))
    r = int(device_mesh.get_rank())
    x, err = torch.from_numpy(z["x"][r]), torch.from_numpy(z["err"][r])
    with shd.use_mesh(device_mesh):
        mean, new_err = optim.compressed_psum(x, "all", err)
    out["psum/mean"], out["psum/err"] = mean.numpy(), new_err.numpy()
    out["psum/q"] = optim.quantize_int8(x.float() + err)[0].numpy()


def pipe_program(device_mesh, out, directory):
    import torch
    from repro_torch.models.pipeline import pipelined_forward, stage_split
    z = dict(np.load(os.path.join(directory, "pipe.npz")))
    W, x = torch.from_numpy(z["W"]), torch.from_numpy(z["x"])

    def stage_fn(p_stage, h):
        for w in p_stage:
            h = torch.tanh(h @ w)
        return h

    Sg = PIPE["S"]
    out["pipe/y"] = pipelined_forward(device_mesh, "stage", stage_fn,
                                      stage_split(W, Sg), x).numpy()
    out["pipe/y_sm"] = pipelined_forward(device_mesh, "stage", stage_fn,
                                         stage_split(W, Sg), x[:Sg]).numpy()


def specs_program(out):
    from repro_torch import sharding as shd
    from repro_torch.configs import ARCH_IDS, get_config
    from repro_torch.launch import mesh as lmesh
    from repro_torch.models.transformer import model_layout
    table = {}
    for multi in (False, True):
        m = lmesh.make_test_mesh(multi_pod=multi, device_type="cpu",
                                 timeout=TIMEOUT)
        for rname, rules in (("default", shd.DEFAULT_RULES),
                             ("sp", shd.with_rules({"seq": "model"}))):
            for arch in ARCH_IDS:
                for k, pd in sorted(model_layout(get_config(arch)).items()):
                    spec = shd.logical_to_spec(pd.logical, rules, m,
                                               pd.shape)
                    table[f"{multi}/{rname}/{arch}/{k}"] = [
                        list(e) if isinstance(e, tuple) else e
                        for e in spec]
    out["specs"] = np.array(json.dumps(table, sort_keys=True))


# ---------------------------------------------------------------------------
# the LM across ranks
# ---------------------------------------------------------------------------

LM_ARCHS = ("phi3-mini-3.8b", "granite-moe-3b-a800m", "deepseek-v3-671b",
            "mamba2-2.7b", "recurrentgemma-9b")
LM_MESHES = {"42": ((4, 2), ("data", "model")),
             "222": ((2, 2, 2), ("pod", "data", "model")),
             "12": ((1, 2), ("data", "model"))}
LM_OPT = dict(lr=1e-3, warmup_steps=2, total_steps=50)
LM_B, LM_S = 8, 16
LM_STEPS = 4            # a run resumes the step-0 state: steps 1..3
LM_PROMPT = 12          # prefill of LM_B x LM_PROMPT, then a decode step
LM_ELASTIC = "port-42-phi3-mini-3.8b"   # the 8-rank run restored elsewhere


def lm_batch_np(cfg, step, host=0, n_hosts=1, **_):
    """Both packages' ``lm_batch`` in the LM tests: the batch of (seed,
    step) from numpy."""
    rng = np.random.default_rng((cfg.seed, step, host))
    ranks = np.minimum((rng.uniform(1e-6, 1, (cfg.global_batch // n_hosts,
                                              cfg.seq_len + 1))
                        ** (-1 / 1.1)).astype(np.int32), cfg.vocab - 1)
    return {"tokens": ranks[:, :-1], "labels": ranks[:, 1:]}


def patch_lm_batch():
    import torch
    from repro_torch import data
    data.lm_batch = lambda *a, **k: {
        n: torch.from_numpy(np.ascontiguousarray(x))
        for n, x in lm_batch_np(*a, **k).items()}


def lm_setup(arch, kind="adamw"):
    """(cfg, OptConfig, DataConfig, TrainLoopConfig factory) of a test
    run: the ``smoke()`` config."""
    from repro_torch import data, optim
    from repro_torch.configs import get_config, smoke
    from repro_torch.launch import train
    cfg = smoke(get_config(arch))
    opt = optim.OptConfig(kind=kind, **LM_OPT)
    dcfg = data.DataConfig(vocab=cfg.vocab, seq_len=LM_S,
                           global_batch=LM_B)

    def loop(directory, **kw):
        return train.TrainLoopConfig(steps=LM_STEPS, ckpt_every=50,
                                     ckpt_dir=directory, sync_ckpt=True,
                                     **kw)
    return cfg, opt, dcfg, loop


def lm_block_checks(out, tag, tree, full):
    """Each leaf's local block against the whole leaf sliced where the
    block sits, bit for bit; its (offset, shape) for the comparison with
    JAX's ``devices_indices_map``."""
    import torch
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    from repro_torch.optim import _leaves
    ok, where = True, []
    for a, w in zip(_leaves(tree), _leaves(full)):
        shape, off = compute_local_shape_and_global_offset(
            tuple(a.shape), a.device_mesh, a.placements)
        blk = torch.as_tensor(w)[tuple(slice(o, o + n)
                                       for o, n in zip(off, shape))]
        ok = ok and torch.equal(a.to_local().cpu(), blk)
        where.append([list(off), list(shape)])
    out[f"{tag}/blocks_equal"] = np.array(ok)
    out[f"{tag}/where"] = np.array(json.dumps(where))


def lm_specs_program(dm, mtag, out):
    """(offset, shape) of every rank's block of every leaf of every
    config's abstract train state (AdamW and Adafactor)."""
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    from repro_torch import optim
    from repro_torch.configs import ARCH_IDS, get_config
    from repro_torch.models import steps
    table = {}
    for arch in ARCH_IDS:
        for kind in ("adamw", "adafactor"):
            sh = steps.train_state_shardings(
                get_config(arch), optim.OptConfig(kind=kind), dm)
            ab = steps.abstract_train_state(get_config(arch),
                                            optim.OptConfig(kind=kind))
            for part, tree in (("params", ab[0]), ("opt", ab[2])):
                for i, (a, (_, pl)) in enumerate(zip(
                        optim._leaves(tree), _sh_leaves(sh[part]))):
                    shape, off = compute_local_shape_and_global_offset(
                        tuple(a.shape), dm, pl)
                    table[f"{arch}/{kind}/{part}/{i}"] = [list(off),
                                                          list(shape)]
    out[f"{mtag}/specs"] = np.array(json.dumps(table, sort_keys=True))


def _sh_leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _sh_leaves(tree[k])]
    return [tree]


def lm_train_program(dm, mtag, archs, out, directory):
    """Each config: the step-0 checkpoint restored onto the mesh (its
    blocks checked), the parameters drawn onto the mesh by
    ``init_train_state`` (the same), then ``train()`` resuming the
    checkpoint for steps 1..3 on every rank."""
    import torch
    from repro_torch import checkpoint
    from repro_torch.launch import train
    from repro_torch.models import steps
    for arch in archs:
        cfg, opt, dcfg, loop = lm_setup(arch)
        d = os.path.join(directory, f"port-{mtag}-{arch}")
        sh = steps.train_state_shardings(cfg, opt, dm)
        params, _, ostate, _ = steps.abstract_train_state(cfg, opt)
        mgr = checkpoint.CheckpointManager(d)
        placed = mgr.restore(0, {"params": params, "opt": ostate}, sh)
        host = mgr.restore(0, {"params": params, "opt": ostate},
                           device="cpu")
        lm_block_checks(out, f"{mtag}/{arch}/restore", placed, host)
        p, o = steps.init_train_state(cfg, opt,
                                      torch.Generator().manual_seed(0),
                                      shardings=sh)
        p0, o0 = steps.init_train_state(cfg, opt,
                                        torch.Generator().manual_seed(0),
                                        device="cpu")
        lm_block_checks(out, f"{mtag}/{arch}/init", {"params": p, "opt": o},
                        {"params": p0, "opt": o0})
        res = train.train(cfg, opt, loop(d), dcfg, mesh=dm)
        out[f"{mtag}/{arch}/losses"] = np.array(res.losses)
        out[f"{mtag}/{arch}/restored"] = np.array(res.restored_from)


def lm_serve_program(dm, mtag, archs, out, directory):
    """Each config's step-0 parameters on the mesh: a prefill of LM_B x
    LM_PROMPT tokens and one decode step; rank 0's logits, gathered."""
    import torch
    from repro_torch import checkpoint
    from repro_torch import sharding as shd
    from repro_torch.models import decode, steps
    for arch in archs:
        cfg, opt, _, _ = lm_setup(arch)
        params, _, ostate, _ = steps.abstract_train_state(cfg, opt)
        sh = steps.train_state_shardings(cfg, opt, dm)
        st = checkpoint.CheckpointManager(os.path.join(
            directory, f"init-{arch}")).restore(
            0, {"params": params, "opt": ostate}, sh)
        tok = torch.from_numpy(lm_prompt(cfg))
        with torch.no_grad(), shd.use_mesh(dm):
            logits, cache = decode.prefill(
                cfg, st["params"], tokens=steps.place_batch(
                    {"tokens": tok}, dm)["tokens"], total_len=LM_PROMPT + 4)
            nt = tok[:, -1:]
            step, _ = decode.decode_step(
                cfg, st["params"], cache, shd.place_tensor(
                    nt, dm, shd.placements_of(("batch", None), nt.shape)),
                LM_PROMPT)
        out[f"{mtag}/{arch}/prefill"] = shd.full(logits).numpy()
        out[f"{mtag}/{arch}/decode"] = shd.full(step).numpy()


def lm_prompt(cfg):
    return np.random.default_rng(5).integers(
        0, cfg.vocab, (LM_B, LM_PROMPT)).astype(np.int32)


def moe_grad_program(dm, out, directory):
    """The gradients of sum(y^2) + lb_loss through ``moe_apply_shardmap``
    on the (2, 2, 2) mesh, with ``test_moe_parity.py``'s inputs (every
    rank the same plain tensors: the replicated activations)."""
    import dataclasses
    import torch
    from repro_torch import sharding as shd
    from repro_torch.configs import get_config, smoke
    from repro_torch.models import moe
    z = dict(np.load(os.path.join(directory, "moe_grad.npz")))
    cfg = dataclasses.replace(smoke(get_config("granite-moe-3b-a800m")),
                              moe_capacity=64.0)
    p = {k: torch.from_numpy(z[k]).requires_grad_() for k in
         ("router", "w_gate", "w_up", "w_down")}
    with shd.use_mesh(dm):
        y, lb = moe.moe_apply_shardmap(cfg, p, torch.from_numpy(z["x"]))
        loss = y.square().sum() + lb
        grads = torch.autograd.grad(loss, list(p.values()))
    for k, g in zip(p, grads):
        out[f"moe_grad/{k}"] = g.numpy()
    out["moe_grad/loss"] = np.array(loss.item())


def lm_elastic_program(out, directory):
    """The 8-rank run's last checkpoint restored onto this mesh: every
    leaf gathered."""
    from repro_torch import checkpoint
    from repro_torch import sharding as shd
    from repro_torch.models import steps
    from repro_torch.optim import _leaves
    dm = lm_mesh("12")
    cfg, opt, _, _ = lm_setup("phi3-mini-3.8b")
    params, _, ostate, _ = steps.abstract_train_state(cfg, opt)
    mgr = checkpoint.CheckpointManager(os.path.join(directory, LM_ELASTIC))
    st = mgr.restore(mgr.latest_step(), {"params": params, "opt": ostate},
                     steps.train_state_shardings(cfg, opt, dm))
    for i, x in enumerate(_leaves(st)):
        out[f"elastic/leaf{i}"] = shd.full(x).numpy()


def lm_mesh(mtag):
    from repro_torch.launch import mesh as lmesh
    shape, names = LM_MESHES[mtag]
    return lmesh.make_mesh(shape, names, device_type="cpu", timeout=TIMEOUT)


def lm_programs(progs, out, directory):
    if "lm8" in progs or "lm2" in progs:
        patch_lm_batch()
    if "lm8" in progs:
        for mtag in ("42", "222"):
            dm = lm_mesh(mtag)
            lm_specs_program(dm, mtag, out)
            lm_train_program(dm, mtag, LM_ARCHS, out, directory)
        open(os.path.join(directory, "lm8.done"), "w").close()
        lm_serve_program(lm_mesh("42"), "42", LM_ARCHS, out, directory)
        moe_grad_program(lm_mesh("222"), out, directory)
    if "lm2" in progs:
        dm = lm_mesh("12")
        lm_train_program(dm, "12", LM_ARCHS[:1], out, directory)
        from repro_torch.launch import train
        cfg, opt, dcfg, loop = lm_setup("phi3-mini-3.8b", "adafactor")
        res = train.train(cfg, opt, loop(os.path.join(
            directory, "port-12-adafactor"), grad_accum=2), dcfg, mesh=dm)
        out["12/adafactor/losses"] = np.array(res.losses)
        lm_elastic_program(out, directory)
    if "train2" in progs:
        # training over a core.distributed.Mesh whose axis spans two ranks
        from repro_torch import data
        from repro_torch.core.distributed import make_mesh
        from repro_torch.launch import mesh as lmesh
        from repro_torch.launch import train
        cfg, opt, _, _ = lm_setup("phi3-mini-3.8b")
        dm = lmesh.make_mesh((2,), ("data",), device_type="cpu",
                             timeout=TIMEOUT)
        res = train.train(cfg, opt, train.TrainLoopConfig(
            steps=2, ckpt_every=50, ckpt_dir=os.path.join(directory,
                                                          "train2")),
            data.DataConfig(vocab=cfg.vocab, seq_len=16, global_batch=2),
            mesh=make_mesh((2,), ("data",), device="cpu", device_mesh=dm))
        out["train2/losses"] = np.array(res.losses)


# ---------------------------------------------------------------------------
# a rank
# ---------------------------------------------------------------------------

def main(args):
    import torch
    import torch.distributed as tdist
    torch.set_num_threads(1)
    rank, world = args["rank"], args["world"]
    directory = args["dir"]
    tdist.init_process_group(
        "gloo", store=tdist.FileStore(args["store"], world), rank=rank,
        world_size=world, timeout=TIMEOUT)
    from repro_torch.launch import mesh as lmesh
    out = {}
    try:
        progs = args["programs"]
        if "index" in progs:
            dm = lmesh.make_mesh((world,), ("data",), device_type="cpu",
                                 timeout=TIMEOUT)
            inp = dict(np.load(os.path.join(directory, "index.npz")))
            built, mesh = index_program(inp, dm, out, directory)
            if "durable" in progs:
                durable_program(built, mesh, inp, out, directory)
            if "recover" in progs:
                recover_program(mesh, out, directory, f"rec{world}")
            if "diverge" in progs:
                diverge_program(built, mesh, inp, out)
        if "mesh8" in progs:
            dm = lmesh.make_test_mesh(multi_pod=True, device_type="cpu",
                                      timeout=TIMEOUT)
            moe_program(dm, out, directory)
            pipe_dm = lmesh.make_mesh((PIPE["S"], 2), ("stage", "data"),
                                      device_type="cpu", timeout=TIMEOUT)
            pipe_program(pipe_dm, out, directory)
            psum_program(lmesh.make_mesh((world,), ("all",),
                                         device_type="cpu",
                                         timeout=TIMEOUT), out, directory)
            specs_program(out)
            mesh_checks(out)
        lm_programs(progs, out, directory)
        np.savez(os.path.join(directory, f"p{world}-rank{rank}.npz"), **out)
    finally:
        tdist.destroy_process_group()


def mesh_checks(out):
    """The mesh shapes, the refusals, and the GSPMD half under a mesh of
    several ranks: ``constrain`` of a DTensor, ``named_sharding``,
    ``tree_shardings``."""
    import torch
    from torch.distributed.tensor import Replicate
    from repro_torch import sharding as shd
    from repro_torch.launch import mesh as lmesh
    msgs = []
    try:
        lmesh.make_production_mesh(device_type="cpu")
    except ValueError as e:
        msgs.append(str(e))
    m = lmesh.make_test_mesh(multi_pod=False, device_type="cpu",
                             timeout=TIMEOUT)
    out["mesh/shape"] = np.array(list(m.mesh.shape))
    out["mesh/names"] = np.array(json.dumps(list(m.mesh_dim_names)))
    with shd.use_mesh(m):
        x = shd.place_tensor(torch.arange(32.0).reshape(8, 4), m,
                             (Replicate(), Replicate()))
        y = shd.constrain(x, "batch", "mlp")
        out["mesh/constrain"] = y.to_local().numpy()
        try:
            shd.constrain(torch.zeros(4), "batch")
        except TypeError as e:      # a plain tensor is never placed
            msgs.append(str(e))
        _, pl = shd.named_sharding(("batch", "mlp"), shape=(8, 4))
        tree = shd.tree_shardings({"w": ("batch",), "v": ("mlp", None)}, m)
        out["mesh/placements"] = np.array(json.dumps(
            [repr(y.placements), repr(pl), repr(tree["w"][1]),
             repr(tree["v"][1]), tree["w"][0] is m]))
        out["mesh/axis"] = np.array([shd.axis_size("data"),
                                     shd.axis_size("model")])
        # a rank's own block leaked out of its DTensor, and a plain
        # constant not declared replicated, meet a DTensor: both raise
        stray = []
        for other in (y.to_local(), torch.ones(8, 4)):
            try:
                y + other
                stray.append("")
            except RuntimeError as e:
                stray.append(str(e))
        out["mesh/stray"] = np.array(json.dumps(stray))
        out["mesh/declared"] = (y * shd.replicated(torch.full((8, 4), 2.0),
                                                   y)).to_local().numpy()
    out["mesh/refusals"] = np.array(json.dumps(msgs))


@contextlib.contextmanager
def one_rank(directory, axis_name):
    """This process as the one rank of a ``gloo`` group, with a mesh of
    one axis; the group is destroyed on exit."""
    import torch.distributed as tdist
    from repro_torch.launch import mesh as lmesh
    tdist.init_process_group(
        "gloo", store=tdist.FileStore(os.path.join(directory, "store-1"), 1),
        rank=0, world_size=1, timeout=TIMEOUT)
    try:
        yield lmesh.make_mesh((1,), (axis_name,), device_type="cpu",
                              timeout=TIMEOUT)
    finally:
        tdist.destroy_process_group()


def spawn(world, directory, programs, tag):
    """Start ``world`` rank processes; returns their handles."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([os.path.join(REPO, "src"), HERE])
    env["OMP_NUM_THREADS"] = "1"
    store = os.path.join(directory, f"store-{tag}")
    procs = []
    for r in range(world):
        args = dict(rank=r, world=world, dir=directory, store=store,
                    programs=programs)
        log = open(os.path.join(directory, f"log-{tag}-{r}.txt"), "w+")
        p = subprocess.Popen(
            [sys.executable, os.path.join(HERE, "torch_ranks.py"),
             json.dumps(args)], env=env, stdout=log,
            stderr=subprocess.STDOUT, text=True)
        p.log = log
        procs.append(p)
    return procs


def wait(procs, timeout):
    """Wait for every rank; on a failure or past ``timeout`` seconds kill
    them all and fail with their output."""
    t_end = time.monotonic() + timeout
    while True:
        codes = [p.poll() for p in procs]
        bad = any(c not in (None, 0) for c in codes)
        if bad or time.monotonic() > t_end:
            for p in procs:
                if p.poll() is None:
                    p.kill()
            logs = []
            for r, p in enumerate(procs):
                rc = p.wait()
                p.log.seek(0)
                logs.append(f"--- rank {r} (rc {rc}):\n{p.log.read()}")
            why = "failed" if bad else f"outlived {timeout} s"
            raise AssertionError(f"a rank {why}\n" + "\n".join(logs))
        if all(c == 0 for c in codes):
            for p in procs:
                p.log.close()
            return
        time.sleep(0.05)


if __name__ == "__main__":
    try:
        main(json.loads(sys.argv[1]))
    except BaseException:
        traceback.print_exc()
        sys.exit(1)
