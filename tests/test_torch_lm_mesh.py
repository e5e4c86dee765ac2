"""The language model across ranks against the JAX package's GSPMD runs.

Ranks are processes on the CPU, joined by ``gloo`` (``torch_ranks``: the
``lm8`` program on eight ranks, then ``lm2`` on two), one thread a rank.
The JAX side runs once, in one subprocess with 8 host devices, on meshes
built as ``jax.sharding.Mesh(np.array(jax.devices()).reshape(...))`` (on
jax 0.9.0 a ``jax.make_mesh`` mesh breaks the reference's
``with_sharding_constraint``).  Both packages' ``lm_batch`` are replaced
by one numpy batch function (``torch_ranks.lm_batch_np``), 8 x 16
tokens a step.  Every run resumes one step-0 checkpoint that the port
draws here (the ``smoke()`` configs, float32 moments, which JAX reads),
so the two packages start from one state; each trains steps 1-3.

* (i) placements: every rank's block of every leaf of every config's
  abstract train state (AdamW and Adafactor) on (4, 2) and (2, 2, 2)
  sits where JAX's ``NamedSharding.devices_indices_map`` puts the device
  of the same index; the state restored onto the mesh and the state drawn
  onto it by ``init_train_state`` hold, bit for bit, the whole leaf's
  values there;
* (ii) ``train(mesh=...)`` for phi3, granite-moe, deepseek-v3, mamba2 and
  recurrentgemma on both meshes: losses within ``RESUME_RTOL`` of JAX's
  ``train(mesh=Mesh(...))``, final parameters within ``STEP_ATOL`` of
  JAX's and of the port's run in one process; phi3 on (1, 2), and with
  Adafactor and ``grad_accum`` 2 there;
* (iii) the gradients of ``moe_apply_shardmap`` on (2, 2, 2) within 1e-5
  of each leaf's largest of JAX's ``jax.grad`` of the same function
  (``test_moe_parity.py``'s inputs);
* (iv) elastic restore: the checkpoint the eight ranks saved on (4, 2)
  restores on two ranks and in one process bit for bit its files, and
  JAX's ``restore`` onto a ``Mesh`` reads it;
* (v) on a one-rank ``DeviceMesh`` every config's losses and final state
  equal the run without a mesh bit for bit (a one-rank mesh runs the
  one-card program on its blocks: this holds the placing, the optimizer
  and the train loop on DTensors, not the model's DTensor path, which
  (ii)-(iv) and (vi) hold on several ranks);
* (vi) prefill logits and one decode step on (4, 2) within 1e-5 of the
  port without a mesh.
"""
import json
import os
import shutil
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

import torch_ranks as R
from conftest import REPO

RESUME_RTOL = 1e-5
STEP_ATOL = 1e-4            # a tenth of the learning rate
GRAD_RTOL = 1e-5
SERVE_ATOL = 1e-5
MESHES = ("42", "222")
# the JAX ids of the meshes' devices are the port's ranks (row-major)

JAX_SCRIPT = r"""
import json, os, time
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh
from repro import checkpoint as jck
from repro import data as jdata
from repro import optim as jopt
from repro import sharding
from repro.configs import ARCH_IDS, get_config, smoke
from repro.launch import train as jtrain
from repro.models import abstract_train_state
from repro.models import moe as moe_mod

d = ARGS["dir"]
devs = np.array(jax.devices())
out = {}


def lm_batch(cfg, step, host=0, n_hosts=1, **_):
    rng = np.random.default_rng((cfg.seed, step, host))
    ranks = np.minimum((rng.uniform(1e-6, 1, (cfg.global_batch // n_hosts,
                                              cfg.seq_len + 1))
                        ** (-1 / 1.1)).astype(np.int32), cfg.vocab - 1)
    return {"tokens": jnp.asarray(ranks[:, :-1]),
            "labels": jnp.asarray(ranks[:, 1:])}


jdata.lm_batch = lm_batch
meshes = {t: Mesh(devs.reshape(s), tuple(n))
          for t, (s, n) in ARGS["meshes"].items() if t != "12"}


def state_shardings(cfg, opt, mesh):
    params, pspecs, ostate, ospecs = abstract_train_state(cfg, opt)
    return ({"params": params, "opt": ostate},
            {"params": sharding.tree_shardings(pspecs, mesh,
                                               shape_tree=params),
             "opt": sharding.tree_shardings(ospecs, mesh,
                                            shape_tree=ostate)})


def blocks(tree, sh):
    rows = []
    for a, s in zip(jax.tree.leaves(tree), jax.tree.leaves(sh)):
        idx = s.devices_indices_map(a.shape)
        rows.append([[[sl.start or 0, n if sl.stop is None else sl.stop]
                      for sl, n in zip(idx[dev], a.shape)]
                     for dev in devs.flat])
    return rows


# (i) where each device's block of every leaf sits
for mtag in meshes:
    table = {}
    for arch in ARCH_IDS:
        for kind in ("adamw", "adafactor"):
            tree, sh = state_shardings(get_config(arch),
                                       jopt.OptConfig(kind=kind),
                                       meshes[mtag])
            for part in ("params", "opt"):
                for i, b in enumerate(blocks(tree[part], sh[part])):
                    table[f"{arch}/{kind}/{part}/{i}"] = b
    for arch in ARGS["archs"]:
        tree, sh = state_shardings(smoke(get_config(arch)),
                                   jopt.OptConfig(**ARGS["opt"]),
                                   meshes[mtag])
        table[f"smoke/{arch}"] = blocks(tree, sh)
    out[f"{mtag}/blocks"] = np.array(json.dumps(table))

# (ii) train(mesh=Mesh(...)) from the step-0 checkpoints
for mtag in ("42", "222"):
    for arch in ARGS["archs"]:
        cfg = smoke(get_config(arch))
        res = jtrain.train(
            cfg, jopt.OptConfig(**ARGS["opt"]),
            jtrain.TrainLoopConfig(steps=ARGS["steps"], ckpt_every=50,
                                   ckpt_dir=os.path.join(
                                       d, f"jax-{mtag}-{arch}"),
                                   sync_ckpt=True),
            jdata.DataConfig(vocab=cfg.vocab, seq_len=ARGS["S"],
                             global_batch=ARGS["B"]),
            mesh=meshes[mtag])
        out[f"{mtag}/{arch}/losses"] = np.array(res.losses)
        out[f"{mtag}/{arch}/restored"] = np.array(res.restored_from)

# (iii) the gradients of moe_apply_shardmap on (2, 2, 2)
import dataclasses
z = dict(np.load(os.path.join(d, "moe_grad.npz")))
mcfg = dataclasses.replace(smoke(get_config("granite-moe-3b-a800m")),
                           moe_capacity=64.0)
p = {k: jnp.asarray(z[k]) for k in ("router", "w_gate", "w_up", "w_down")}


def loss_sm(pp, xx):
    y, lb = moe_mod.moe_apply_shardmap(mcfg, pp, xx)
    return jnp.sum(jnp.square(y)) + lb


with sharding.use_mesh(meshes["222"]):
    g = jax.jit(jax.grad(loss_sm))(p, jnp.asarray(z["x"]))
for k, v in g.items():
    out[f"moe_grad/{k}"] = np.asarray(v)

# (iv) the eight ranks' checkpoint restored onto a Mesh
t_end = time.time() + ARGS["wait"]
while not os.path.exists(os.path.join(d, "lm8.done")):
    assert time.time() < t_end, "the port's eight ranks did not finish"
    time.sleep(0.2)
cfg = smoke(get_config("phi3-mini-3.8b"))
tree, sh = state_shardings(cfg, jopt.OptConfig(**ARGS["opt"]),
                           meshes["42"])
mgr = jck.CheckpointManager(os.path.join(d, ARGS["elastic"]))
step, st = mgr.restore_latest(tree, sh)
out["elastic/step"] = np.array(step)
for i, x in enumerate(jax.tree.leaves(st)):
    out[f"elastic/leaf{i}"] = np.asarray(x)
    out[f"elastic/n{i}"] = np.array(len(x.addressable_shards))
np.savez(os.path.join(d, "jax.npz"), **out)
"""


def load(*parts):
    with np.load(os.path.join(*parts)) as z:
        return {k: z[k] for k in z.files}


def ckpt_leaves(directory, step=None):
    """A checkpoint's leaves in order (``host0.npz``'s ``leaf_i``)."""
    from repro_torch.checkpoint import CheckpointManager
    mgr = CheckpointManager(directory)
    step = mgr.latest_step() if step is None else step
    z = load(directory, f"step_{step}", "host0.npz")
    return [z[f"leaf_{i}"] for i in range(len(z))]


def write_inputs(d):
    """The step-0 checkpoints (one a config, one for Adafactor) and their
    copies, one a run; the expert layer's inputs of ``test_moe_parity``'s
    GRAD_SCRIPT."""
    import jax
    from repro.configs import get_config as jget_config
    from repro.configs import smoke as jsmoke
    from repro.models.base import init_params
    from repro.models.transformer import model_layout
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.models import steps
    for arch, kind, runs in (
            [(a, "adamw", [f"{w}-{m}-{a}" for w in ("port", "jax")
                           for m in MESHES] + [f"one-{a}", f"r1-{a}"])
             for a in R.LM_ARCHS] +
            [("phi3-mini-3.8b", "adafactor",
              ["port-12-adafactor", "one-adafactor"])]):
        cfg, opt, _, _ = R.lm_setup(arch, kind)
        p, o = steps.init_train_state(cfg, opt,
                                      torch.Generator().manual_seed(0),
                                      device="cpu")
        src = os.path.join(d, f"init-{arch}" if kind == "adamw"
                           else f"init-{kind}")
        CheckpointManager(src).save(0, {"params": p, "opt": o},
                                    blocking=True)
        if arch == "phi3-mini-3.8b" and kind == "adamw":
            runs.append("port-12-phi3-mini-3.8b")
        for run in runs:
            shutil.copytree(src, os.path.join(d, run))
    jcfg = jsmoke(jget_config("granite-moe-3b-a800m"))
    params = init_params(model_layout(jcfg), jax.random.key(0),
                         jcfg.param_dtype)
    p = jax.tree.map(lambda a: np.asarray(a[0]),
                     params["blocks"]["moe"])["experts"]
    x = np.random.default_rng(1).normal(size=(8, 16, jcfg.d_model)) \
        .astype(np.float32)
    np.savez(os.path.join(d, "moe_grad.npz"), x=x,
             **{k: p[k] for k in R.MOE_LEAVES})


def one_process_runs(d):
    """The port without a mesh, and on a one-rank ``DeviceMesh``, from the
    same checkpoints: {run: TrainResult}."""
    from repro_torch.launch import train
    out = {}
    for arch in R.LM_ARCHS:
        cfg, opt, dcfg, loop = R.lm_setup(arch)
        out[f"one-{arch}"] = train.train(
            cfg, opt, loop(os.path.join(d, f"one-{arch}")), dcfg,
            device="cpu")
    cfg, opt, dcfg, loop = R.lm_setup("phi3-mini-3.8b", "adafactor")
    out["one-adafactor"] = train.train(
        cfg, opt, loop(os.path.join(d, "one-adafactor"), grad_accum=2),
        dcfg, device="cpu")
    with R.one_rank(d, "data") as dm:
        for arch in R.LM_ARCHS:
            cfg, opt, dcfg, loop = R.lm_setup(arch)
            out[f"r1-{arch}"] = train.train(
                cfg, opt, loop(os.path.join(d, f"r1-{arch}")), dcfg,
                mesh=dm)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("lm_mesh"))
    write_inputs(d)
    args = dict(dir=d, archs=list(R.LM_ARCHS), meshes=R.LM_MESHES,
                opt=R.LM_OPT, steps=R.LM_STEPS, B=R.LM_B, S=R.LM_S,
                elastic=R.LM_ELASTIC, wait=300)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.path.join(REPO, "src"))
    jax_log = open(os.path.join(d, "jax-log.txt"), "w+")
    jax_proc = subprocess.Popen(
        [sys.executable, "-c", f"ARGS = {json.dumps(args)}\n" + JAX_SCRIPT],
        env=env, stdout=jax_log, stderr=subprocess.STDOUT, text=True)
    threads = torch.get_num_threads()
    mp = pytest.MonkeyPatch()
    try:
        group = R.spawn(8, d, ["lm8"], "lm8")
        torch.set_num_threads(1)
        from repro_torch import data
        mp.setattr(data, "lm_batch", lambda *a, **k: {
            n: torch.from_numpy(np.ascontiguousarray(x))
            for n, x in R.lm_batch_np(*a, **k).items()})
        one = one_process_runs(d)
        R.wait(group, 300)
        R.wait(R.spawn(2, d, ["lm2"], "lm2"), 300)
        jax_proc.wait(timeout=300)
    finally:
        mp.undo()
        torch.set_num_threads(threads)
        if jax_proc.poll() is None:
            jax_proc.kill()
    jax_log.seek(0)
    assert jax_proc.returncode == 0, jax_log.read()
    return types.SimpleNamespace(
        dir=d, jax=load(d, "jax.npz"), one=one,
        ranks={P: [load(d, f"p{P}-rank{r}.npz") for r in range(P)]
               for P in (8, 2)})


def assert_leaves_close(got, want, atol, what):
    assert len(got) == len(want), what
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = np.asarray(g), np.asarray(w)
        if w.dtype.kind == "V":          # bfloat16 words
            assert np.array_equal(g, w), f"{what} leaf {i}"
            continue
        np.testing.assert_allclose(g.astype(np.float64), w.astype(np.float64),
                                   rtol=0, atol=atol,
                                   err_msg=f"{what} leaf {i}")


# ---------------------------------------------------------------------------
# (i) placements
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mtag", MESHES, ids=["(4,2)", "(2,2,2)"])
def test_placements_match_jax(runs, mtag):
    """Every config's abstract train state, AdamW and Adafactor: each
    rank's block (offset, shape) is JAX's for the device of its index;
    the trained configs' restored and drawn states hold the whole leaf's
    values there, bit for bit."""
    want = json.loads(str(runs.jax[f"{mtag}/blocks"]))
    n = 0
    for r, rk in enumerate(runs.ranks[8]):
        got = json.loads(str(rk[f"{mtag}/specs"]))
        for key, (off, shape) in got.items():
            blk = want[key][r]
            assert off == [a for a, _ in blk], (key, r)
            assert shape == [b - a for a, b in blk], (key, r)
            n += 1
        for arch in R.LM_ARCHS:
            jb = want[f"smoke/{arch}"]
            for how in ("restore", "init"):
                assert bool(rk[f"{mtag}/{arch}/{how}/blocks_equal"]), \
                    (arch, how, r)
                where = json.loads(str(rk[f"{mtag}/{arch}/{how}/where"]))
                assert where == [[[a for a, _ in b[r]],
                                  [y - x for x, y in b[r]]] for b in jb], \
                    (arch, how, r)
    assert n > 8 * 1000
    # some leaf is split over two mesh dims ("data" and "model")
    assert any(len({tuple(a for a, _ in blk[r]) for r in range(8)}) == 4
               for key, blk in want.items() if not key.startswith("smoke/"))


# ---------------------------------------------------------------------------
# (ii) training
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", R.LM_ARCHS)
@pytest.mark.parametrize("mtag", MESHES, ids=["(4,2)", "(2,2,2)"])
def test_train_on_mesh_matches_jax(runs, mtag, arch):
    """Steps 1-3 from one checkpoint: every rank's losses within
    ``RESUME_RTOL`` of JAX's on the same mesh; the final parameters and
    optimizer state within ``STEP_ATOL`` of JAX's and of the port's in
    one process."""
    want = runs.jax[f"{mtag}/{arch}/losses"]
    assert int(runs.jax[f"{mtag}/{arch}/restored"]) == 0
    for rk in runs.ranks[8]:
        assert int(rk[f"{mtag}/{arch}/restored"]) == 0
        np.testing.assert_allclose(rk[f"{mtag}/{arch}/losses"], want,
                                   rtol=RESUME_RTOL)
    np.testing.assert_allclose(runs.one[f"one-{arch}"].losses, want,
                               rtol=RESUME_RTOL)
    got = ckpt_leaves(os.path.join(runs.dir, f"port-{mtag}-{arch}"))
    assert_leaves_close(got, ckpt_leaves(os.path.join(
        runs.dir, f"jax-{mtag}-{arch}")), STEP_ATOL, "vs JAX")
    assert_leaves_close(got, ckpt_leaves(os.path.join(
        runs.dir, f"one-{arch}")), STEP_ATOL, "vs one process")


@pytest.mark.parametrize("kind", ["adamw", "adafactor"])
def test_train_on_two_ranks(runs, kind):
    """phi3 on a (1, 2) mesh (AdamW; Adafactor with ``grad_accum`` 2):
    losses within ``RESUME_RTOL`` and the final state within
    ``STEP_ATOL`` of the port in one process (and of JAX's (4, 2) run
    for AdamW)."""
    run = "phi3-mini-3.8b" if kind == "adamw" else "adafactor"
    ref = runs.one[f"one-{run}"].losses
    for rk in runs.ranks[2]:
        got = rk["12/phi3-mini-3.8b/losses"] if kind == "adamw" \
            else rk["12/adafactor/losses"]
        np.testing.assert_allclose(got, ref, rtol=RESUME_RTOL)
    if kind == "adamw":
        np.testing.assert_allclose(
            ref, runs.jax["42/phi3-mini-3.8b/losses"], rtol=RESUME_RTOL)
    assert_leaves_close(
        ckpt_leaves(os.path.join(runs.dir, f"port-12-{run}")),
        ckpt_leaves(os.path.join(runs.dir, f"one-{run}")), STEP_ATOL,
        "vs one process")


# ---------------------------------------------------------------------------
# (iii) the expert layer's gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("leaf", R.MOE_LEAVES)
def test_moe_shardmap_gradients_match_jax(runs, leaf):
    """granite-moe's smoke expert layer, drop-free, on (2, 2, 2): every
    rank's gradient of sum(y^2) + lb_loss within ``GRAD_RTOL`` of the
    leaf's largest of JAX's ``jax.grad`` through its ``shard_map``."""
    want = runs.jax[f"moe_grad/{leaf}"]
    for rk in runs.ranks[8]:
        np.testing.assert_allclose(rk[f"moe_grad/{leaf}"], want, rtol=0,
                                   atol=GRAD_RTOL * np.abs(want).max())


# ---------------------------------------------------------------------------
# (iv) elastic restore
# ---------------------------------------------------------------------------

def test_elastic_restore(runs):
    """The checkpoint eight ranks saved on (4, 2) after step 3: restored
    on a (1, 2) mesh of two ranks and gathered, in one process, and by
    JAX onto its (4, 2) ``Mesh`` (each leaf in 8 addressable shards):
    every leaf bit for bit the file's."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.models import steps
    from repro_torch.optim import _leaves
    d = os.path.join(runs.dir, R.LM_ELASTIC)
    assert CheckpointManager(d).latest_step() == R.LM_STEPS - 1
    disk = ckpt_leaves(d)
    cfg, opt, _, _ = R.lm_setup("phi3-mini-3.8b")
    params, _, ostate, _ = steps.abstract_train_state(cfg, opt)
    one = _leaves(CheckpointManager(d).restore(
        R.LM_STEPS - 1, {"params": params, "opt": ostate}, device="cpu"))
    assert int(runs.jax["elastic/step"]) == R.LM_STEPS - 1
    for i, w in enumerate(disk):
        np.testing.assert_array_equal(one[i].numpy(), w)
        np.testing.assert_array_equal(runs.jax[f"elastic/leaf{i}"], w)
        assert int(runs.jax[f"elastic/n{i}"]) == 8
        for rk in runs.ranks[2]:
            np.testing.assert_array_equal(rk[f"elastic/leaf{i}"], w)


# ---------------------------------------------------------------------------
# (v) one rank
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", R.LM_ARCHS)
def test_one_rank_mesh_is_the_one_card_path(runs, arch):
    """On a one-rank ``DeviceMesh`` (every leaf a DTensor; the step runs
    the one-card program on the blocks) the losses and the final state
    equal the run without a mesh bit for bit."""
    assert runs.one[f"r1-{arch}"].losses == runs.one[f"one-{arch}"].losses
    for a, b in zip(ckpt_leaves(os.path.join(runs.dir, f"r1-{arch}")),
                    ckpt_leaves(os.path.join(runs.dir, f"one-{arch}"))):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# (vi) prefill and decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", R.LM_ARCHS)
def test_prefill_and_decode_on_mesh(runs, arch):
    """The step-0 parameters on (4, 2): prefill logits of 8 x 12 tokens
    and one decode step within ``SERVE_ATOL`` of the port without a
    mesh."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.models import decode, steps
    cfg, opt, _, _ = R.lm_setup(arch)
    params, _, ostate, _ = steps.abstract_train_state(cfg, opt)
    st = CheckpointManager(os.path.join(runs.dir, f"init-{arch}")).restore(
        0, {"params": params, "opt": ostate}, device="cpu")
    tok = torch.from_numpy(R.lm_prompt(cfg))
    with torch.no_grad():
        logits, cache = decode.prefill(cfg, st["params"], tokens=tok,
                                       total_len=R.LM_PROMPT + 4)
        step, _ = decode.decode_step(cfg, st["params"], cache, tok[:, -1:],
                                     R.LM_PROMPT)
    rk = runs.ranks[8][0]
    np.testing.assert_allclose(rk[f"42/{arch}/prefill"], logits.numpy(),
                               rtol=0, atol=SERVE_ATOL)
    np.testing.assert_allclose(rk[f"42/{arch}/decode"], step.numpy(),
                               rtol=0, atol=SERVE_ATOL)
