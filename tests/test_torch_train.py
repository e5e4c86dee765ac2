"""The port's training path against the JAX package's, on the CPU.

For each of the six dense ``ARCH_IDS`` at ``smoke()`` size (two layers,
d 64, float32) both packages get one set of weights (the JAX
``init_params`` carried by ``params_from_numpy``) and one batch made with
numpy.  The bars, each measured on this CPU:

* ``loss_fn``: ``LOSS_ATOL = 2e-5`` (measured at most 4.8e-7), and every
  gradient leaf against ``jax.value_and_grad(loss_fn)`` within
  ``GRAD_RTOL = 1e-5`` of the leaf's largest |gradient| (measured at
  most 1.5e-6), with ``remat`` off (the smoke configs) and on;
* one ``make_train_step`` step, AdamW and Adafactor, ``grad_accum`` 1 and
  2: the loss and gradient norm within ``GRAD_RTOL`` (measured at most
  2.8e-7), every optimizer leaf within ``GRAD_RTOL`` of its leaf's
  largest value (measured at most 2.5e-6), every updated parameter
  within ``STEP_ATOL = 1e-4``, a tenth of the learning rate (measured at
  most 0.024 of it).  A parameter moves by up to lr a step whatever its
  gradient's size, and Adam's first step, g / (|g| + eps), turns the
  relative error of a gradient near eps = 1e-8 into a like share of lr;
* ``train()``: the loss falls, a run resumes after an injected failure
  with the losses of an uninterrupted run, exactly, the straggler
  watchdog flags a slow step;
* resume across the packages: JAX trains, fails and checkpoints (with
  bfloat16 moments, which only the port can read back), the port
  resumes from JAX's directory, and its losses match an uninterrupted
  JAX run within ``RESUME_RTOL = 1e-5`` (measured at most 1.5e-7); then
  the reverse with float32 moments, since the JAX ``restore`` refuses
  bfloat16.

Both packages' ``lm_batch`` are replaced by one numpy batch function in
the loop tests (the port's draws on a ``torch.Generator``, not on
``jax.random``).
"""
import dataclasses
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_ranks as R
from torch_parity import one_thread  # noqa: F401  (autouse)
from repro import data as jdata
from repro import optim as jopt
from repro.configs import get_config as jget_config
from repro.configs import smoke as jsmoke
from repro.launch import train as jtrain
from repro.models import steps as jsteps
from repro.models.base import init_params as jinit_params
from repro.models.transformer import loss_fn as jloss_fn
from repro.models.transformer import model_layout as jmodel_layout
from repro_torch import data as tdata
from repro_torch import optim as topt
from repro_torch.configs import ARCH_IDS, get_config, smoke
from repro_torch.core.distributed import make_mesh
from repro_torch.launch import train as ttrain
from repro_torch.models import steps as tsteps
from repro_torch.models.base import params_from_numpy
from repro_torch.models.transformer import loss_fn

LOSS_ATOL = 2e-5
GRAD_RTOL = 1e-5
STEP_ATOL = 1e-4           # a tenth of OPT.lr
RESUME_RTOL = 1e-5
DENSE = [a for a in ARCH_IDS if get_config(a).family == "dense"]
B, S = 2, 24
OPT = topt.OptConfig(lr=1e-3, warmup_steps=2, total_steps=50)


def configs(arch, **kw):
    return (dataclasses.replace(jsmoke(jget_config(arch)), **kw),
            dataclasses.replace(smoke(get_config(arch)), **kw))


def weights(jcfg, seed=0):
    jparams = jinit_params(jmodel_layout(jcfg), jax.random.key(seed),
                           jcfg.param_dtype)
    return jparams, params_from_numpy(jax.tree.map(np.asarray, jparams),
                                      device="cpu")


def np_batch(cfg, rng, b=B, s=S):
    if cfg.input_mode == "embeddings":
        x = {"embeds": rng.normal(size=(b, s, cfg.d_model))
             .astype(np.float32)}
    else:
        x = {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}
    x["labels"] = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    return x


def both(batch):
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(v) for k, v in batch.items()})


def assert_tree_close(got, want, what, rtol=0.0, atol=0.0):
    """Every leaf of the port's tree within ``atol`` + ``rtol`` times the
    largest |value| of the JAX leaf."""
    for path, w in jax.tree_util.tree_leaves_with_path(want):
        g = got
        for p in path:
            g = g[p.key]
        w = np.asarray(w, np.float32)
        g = g.float().numpy() if g.dtype == torch.bfloat16 else g.numpy()
        bar = atol + rtol * float(np.abs(w).max())
        np.testing.assert_allclose(g, w, rtol=0, atol=bar, err_msg=(
            f"{what} {jax.tree_util.keystr(path)}"))


# ---------------------------------------------------------------------------
# loss and gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,remat", [(a, False) for a in DENSE] +
                         [("phi3-mini-3.8b", True)])
def test_loss_and_grads(arch, remat, rng):
    jcfg, tcfg = configs(arch, remat=remat)
    jparams, tparams = weights(jcfg)
    jb, tb = both(np_batch(tcfg, rng))
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p, b: jloss_fn(jcfg, p, b), has_aux=True))(jparams, jb)
    (tl, tm), tg = tsteps.loss_and_grad(tcfg, tparams, tb)
    assert sorted(tm) == sorted(jm) == ["loss", "nll"]
    np.testing.assert_allclose(tl.item(), float(jl), rtol=0, atol=LOSS_ATOL)
    np.testing.assert_allclose(tm["nll"].item(), float(jm["nll"]), rtol=0,
                               atol=LOSS_ATOL)
    assert_tree_close(tg, jg, "gradient", rtol=GRAD_RTOL)
    # loss_fn itself, without gradients, and with a mask
    mask = np.ones((B, S), np.float32)
    mask[:, S // 2:] = 0
    jl2, _ = jloss_fn(jcfg, jparams, dict(jb, mask=jnp.asarray(mask)))
    with torch.no_grad():
        tl2, _ = loss_fn(tcfg, tparams, dict(tb, mask=torch.from_numpy(mask)))
    np.testing.assert_allclose(tl2.item(), float(jl2), rtol=0, atol=LOSS_ATOL)


def test_remat_gives_the_same_gradients(rng):
    """Rematerialized layers recompute what they dropped: the gradients
    are bit for bit those without remat."""
    jcfg, tcfg = configs("phi3-mini-3.8b")
    _, tparams = weights(jcfg)
    _, tb = both(np_batch(tcfg, rng))
    (l0, _), g0 = tsteps.loss_and_grad(tcfg, tparams, tb)
    (l1, _), g1 = tsteps.loss_and_grad(
        dataclasses.replace(tcfg, remat=True), tparams, tb)
    assert l0.item() == l1.item()
    jax.tree.map(lambda a, b: torch.testing.assert_close(a, b, rtol=0,
                                                         atol=0), g0, g1)


# ---------------------------------------------------------------------------
# one train step
# ---------------------------------------------------------------------------

STEP_CASES = [(a, "adamw", 1) for a in DENSE] + \
    [(a, "adafactor", 2) for a in DENSE] + \
    [("phi3-mini-3.8b", "adamw", 2), ("phi3-mini-3.8b", "adafactor", 1)]


@pytest.mark.parametrize("arch,kind,accum", STEP_CASES)
def test_train_step(arch, kind, accum, rng):
    jcfg, tcfg = configs(arch)
    opt = dataclasses.replace(OPT, kind=kind)
    jopt_cfg = jopt.OptConfig(**dataclasses.asdict(opt))
    jparams, tparams = weights(jcfg)
    jb, tb = both(np_batch(tcfg, rng, b=4))
    jstate = jopt.init(jopt_cfg, jparams)
    jp, js, jmet = jax.jit(jsteps.make_train_step(jcfg, jopt_cfg, accum))(
        jparams, jstate, jb)
    tstate = topt.init(opt, tparams)
    tp, ts, tmet = tsteps.make_train_step(tcfg, opt, accum)(
        tparams, tstate, tb)
    assert tp is tparams, "the step updates the parameters in place"
    assert sorted(tmet) == sorted(jmet)
    for k in jmet:
        np.testing.assert_allclose(tmet[k].item(), float(jmet[k]),
                                   rtol=GRAD_RTOL, err_msg=k)
    assert_tree_close(tp, jp, "params", atol=STEP_ATOL)
    assert int(ts["count"]) == int(js["count"]) == 1
    assert_tree_close({k: v for k, v in ts.items() if k != "count"},
                      {k: v for k, v in js.items() if k != "count"},
                      "optimizer state", rtol=GRAD_RTOL)


# ---------------------------------------------------------------------------
# specs and state
# ---------------------------------------------------------------------------

def shapes_of(tree):
    """(shape, dtype name) of every leaf of either package's tree."""
    return jax.tree.map(
        lambda x: (tuple(x.shape), str(x.dtype).replace("torch.", "")),
        tree, is_leaf=lambda x: hasattr(x, "shape"))


@pytest.mark.parametrize("kind", ["adamw", "adafactor"])
def test_abstract_train_state_matches_jax(kind):
    cfg = get_config("phi3-mini-3.8b")
    opt = dataclasses.replace(OPT, kind=kind, moment_dtype="bfloat16")
    jp, jps, jo, jos = jsteps.abstract_train_state(
        jget_config("phi3-mini-3.8b"),
        jopt.OptConfig(**dataclasses.asdict(opt)))
    tp, tps, to, tos = tsteps.abstract_train_state(cfg, opt)
    assert all(x.device.type == "meta" for x in jax.tree.leaves(
        (tp, to), is_leaf=lambda x: isinstance(x, torch.Tensor)))
    assert shapes_of(jp) == shapes_of(tp)
    assert shapes_of(jo) == shapes_of(to)
    is_axes = lambda x: isinstance(x, tuple)  # noqa: E731
    assert jax.tree.leaves(jps, is_leaf=is_axes) == \
        jax.tree.leaves(tps, is_leaf=is_axes)
    assert jax.tree.structure(jos, is_leaf=is_axes) == \
        jax.tree.structure(tos, is_leaf=is_axes)
    assert jax.tree.leaves(jos, is_leaf=is_axes) == \
        jax.tree.leaves(tos, is_leaf=is_axes)


@pytest.mark.parametrize("arch", ["phi3-mini-3.8b", "musicgen-medium",
                                  "granite-moe-3b-a800m", "deepseek-v3-671b",
                                  "mamba2-2.7b", "recurrentgemma-9b"])
@pytest.mark.parametrize("shape", list(tsteps.SHAPES))
def test_input_specs_match_jax(arch, shape):
    jcfg, tcfg = jget_config(arch), get_config(arch)
    if not tsteps.shape_applicable(tcfg, shape):
        assert not jsteps.shape_applicable(jcfg, shape)
        return
    jb, jl = jsteps.input_specs(jcfg, shape)
    tb, tl = tsteps.input_specs(tcfg, shape)
    assert shapes_of(jb) == shapes_of(tb)
    is_axes = lambda x: isinstance(x, tuple)  # noqa: E731
    assert jax.tree.structure(jl, is_leaf=is_axes) == \
        jax.tree.structure(tl, is_leaf=is_axes)
    assert jax.tree.leaves(jl, is_leaf=is_axes) == \
        jax.tree.leaves(tl, is_leaf=is_axes)


def test_init_train_state_on_a_generator():
    cfg = smoke(get_config("phi3-mini-3.8b"))
    a, sa = tsteps.init_train_state(cfg, OPT, torch.Generator().manual_seed(1),
                                    "cpu")
    b, _ = tsteps.init_train_state(cfg, OPT, torch.Generator().manual_seed(1),
                                   "cpu")
    assert torch.equal(a["blocks"]["attn"]["wq"], b["blocks"]["attn"]["wq"])
    assert sorted(sa) == ["count", "m", "v"] and int(sa["count"]) == 0
    assert not sa["m"]["blocks"]["attn"]["wq"].any()


def test_init_params_draw_order():
    """``init_params``' draw order, pinned: the leaves in sorted name
    order, a leaf of three or more dims one slab of its leading dim at a
    time, a smaller one whole, each a float32 normal on the CPU generator
    times its scale, cast to the dtype; zeros take no draw."""
    from repro_torch.models.base import init_params
    cfg = smoke(get_config("granite-moe-3b-a800m"))
    layout = tsteps.model_layout(cfg)
    got = init_params(layout, torch.Generator().manual_seed(5), "bfloat16",
                      "cpu")
    g = torch.Generator().manual_seed(5)
    for name in sorted(layout):
        d = layout[name]
        leaf = got
        for part in name.split("/"):
            leaf = leaf[part]
        assert leaf.dtype == torch.bfloat16 and leaf.shape == d.shape
        if d.init == "zeros":
            assert not leaf.any(), name
            continue
        scale = 0.02 if d.init == "small" else 1 / np.sqrt(d.shape[-2])
        slabs = [d.shape[1:]] * d.shape[0] if len(d.shape) >= 3 \
            else [d.shape]
        want = torch.stack([torch.randn(s, generator=g) * scale
                            for s in slabs]).reshape(d.shape)
        assert torch.equal(leaf, want.to(torch.bfloat16)), name


@pytest.mark.gpu
def test_seeded_state_is_device_independent():
    """One seed gives the same batch and the same weights on the CPU and
    on the card: ``lm_batch`` (tokens and embeddings) and ``init_params``
    / ``init_train_state`` draw on the CPU and copy."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the card's draw needs one")
    cfg = tdata.DataConfig(vocab=49155, seq_len=64, global_batch=4, seed=7)
    for c in (cfg, dataclasses.replace(cfg, input_mode="embeddings",
                                       d_model=16)):
        for step in (0, 3):
            host = tdata.lm_batch(c, step, device="cpu")
            card = tdata.lm_batch(c, step, device="cuda")
            assert sorted(host) == sorted(card)
            for k in host:
                assert card[k].is_cuda and torch.equal(card[k].cpu(),
                                                       host[k]), k
    from repro_torch.models.base import init_params, tree_leaves
    mcfg = smoke(get_config("granite-moe-3b-a800m"))
    layout = tsteps.model_layout(mcfg)
    for dt in ("float32", "bfloat16"):
        host = init_params(layout, torch.Generator().manual_seed(2), dt, "cpu")
        card = init_params(layout, torch.Generator().manual_seed(2), dt,
                           "cuda")
        for a, b in zip(tree_leaves(host), tree_leaves(card)):
            assert b.is_cuda and torch.equal(b.cpu(), a)
    hp, _ = tsteps.init_train_state(mcfg, OPT, torch.Generator().manual_seed(
        4), "cpu")
    cp, _ = tsteps.init_train_state(mcfg, OPT, torch.Generator().manual_seed(
        4), "cuda")
    assert all(torch.equal(a, b.cpu()) for a, b in zip(tree_leaves(hp),
                                                       tree_leaves(cp)))


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

def test_lm_batch_deterministic_and_distinct():
    cfg = tdata.DataConfig(vocab=100, seq_len=16, global_batch=4)
    b1 = tdata.lm_batch(cfg, step=3, device="cpu")
    b2 = tdata.lm_batch(cfg, step=3, device="cpu")
    b3 = tdata.lm_batch(cfg, step=4, device="cpu")
    h1 = tdata.lm_batch(cfg, step=3, host=1, n_hosts=2, device="cpu")
    assert torch.equal(b1["tokens"], b2["tokens"])
    assert not torch.equal(b1["tokens"], b3["tokens"])
    assert h1["tokens"].shape == (2, 16)
    for b in (b1, b3):
        assert b["tokens"].dtype == b["labels"].dtype == torch.int32
        assert 0 <= int(b["tokens"].min()) and int(b["tokens"].max()) < 100
        assert torch.equal(b["tokens"][:, 1:], b["labels"][:, :-1])
    # zipf-ish marginals: rank 1 is the commonest token
    assert torch.bincount(b1["tokens"].flatten().long()).argmax() == 1
    emb = tdata.lm_batch(dataclasses.replace(cfg, input_mode="embeddings",
                                             d_model=8), 0, device="cpu")
    assert sorted(emb) == ["embeds", "labels"]
    assert emb["embeds"].shape == (4, 16, 8)
    assert emb["embeds"].dtype == torch.float32


@pytest.mark.parametrize("granularity", [1, 100])
def test_range_batch_bit_for_bit(granularity):
    ycfg = tdata.YCSBConfig(n_keys=1 << 12, seed=3)
    jcfg = jdata.YCSBConfig(**dataclasses.asdict(ycfg))
    keys, _ = tdata.ycsb_dataset(ycfg)
    for step in range(3):
        for a, b in zip(tdata.range_batch(ycfg, keys, step, granularity),
                        jdata.range_batch(jcfg, keys, step, granularity)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# the train loop
# ---------------------------------------------------------------------------

def numpy_lm_batch(to):
    """A stand-in for both packages' ``lm_batch``: the batch of (seed,
    step) from numpy, as ``to``'s arrays."""
    def lm_batch(cfg, step, host=0, n_hosts=1, **_):
        rng = np.random.default_rng((cfg.seed, step, host))
        ranks = np.minimum((rng.uniform(1e-6, 1, (cfg.global_batch // n_hosts,
                                                  cfg.seq_len + 1))
                            ** (-1 / 1.1)).astype(np.int32), cfg.vocab - 1)
        return {"tokens": to(ranks[:, :-1]), "labels": to(ranks[:, 1:])}
    return lm_batch


@pytest.fixture
def same_batches(monkeypatch):
    monkeypatch.setattr(jdata, "lm_batch", numpy_lm_batch(jnp.asarray))
    monkeypatch.setattr(tdata, "lm_batch", numpy_lm_batch(
        lambda a: torch.from_numpy(np.ascontiguousarray(a))))


def dcfg(cfg):
    return tdata.DataConfig(vocab=cfg.vocab, seq_len=16, global_batch=2)


def jdcfg(cfg):
    return jdata.DataConfig(vocab=cfg.vocab, seq_len=16, global_batch=2)


TINY = smoke(get_config("phi3-mini-3.8b"))


def test_train_loss_decreases(tmp_path):
    loop = ttrain.TrainLoopConfig(steps=12, ckpt_every=50,
                                  ckpt_dir=str(tmp_path))
    res = ttrain.train(TINY, OPT, loop, dcfg(TINY), device="cpu")
    assert res.final_step == 11 and res.restored_from is None
    assert np.mean(res.losses[-3:]) < np.mean(res.losses[:3])


def test_restart_resumes_from_checkpoint(tmp_path):
    loop = ttrain.TrainLoopConfig(steps=10, ckpt_every=3,
                                  ckpt_dir=str(tmp_path), fail_at_step=7,
                                  sync_ckpt=True)
    with pytest.raises(RuntimeError, match="injected failure"):
        ttrain.train(TINY, OPT, loop, dcfg(TINY), device="cpu")
    loop2 = dataclasses.replace(loop, fail_at_step=None)
    res = ttrain.train(TINY, OPT, loop2, dcfg(TINY), device="cpu")
    assert res.restored_from == 6
    assert res.final_step == 9 and len(res.losses) == 3
    # a clean run over the same batches: the resumed steps took up its
    # state bit for bit
    clean = ttrain.train(TINY, OPT, dataclasses.replace(
        loop2, ckpt_dir=str(tmp_path / "clean")), dcfg(TINY), device="cpu")
    assert res.losses == clean.losses[7:]


def test_straggler_watchdog(tmp_path):
    import time
    loop = ttrain.TrainLoopConfig(steps=10, ckpt_every=50,
                                  ckpt_dir=str(tmp_path),
                                  straggler_factor=2.5)
    logged, starts = [], []

    def pre_step(step):
        starts.append(time.perf_counter())
        if step == 8:   # a synthetic straggler: 5x the steps so far, >= 1 s
            time.sleep(max(1.0, 5 * float(np.median(np.diff(starts)))))
    res = ttrain.train(TINY, OPT, loop, dcfg(TINY), device="cpu",
                       hooks={"pre_step": pre_step,
                              "log": lambda *a: logged.append(a)})
    assert 8 in res.straggler_steps
    assert [a[0] for a in logged] == list(range(10))


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "deepseek-v3-671b",
                                  "mamba2-2.7b", "recurrentgemma-9b"])
def test_train_loop_moe_families(tmp_path, arch):
    """``train()`` on a moe, an mla_moe, an ssm and a griffin config:
    finite losses, and a run resumed after an injected failure takes up an
    uninterrupted run's losses exactly."""
    cfg = smoke(get_config(arch))
    loop = ttrain.TrainLoopConfig(steps=6, ckpt_every=3,
                                  ckpt_dir=str(tmp_path / "run"),
                                  fail_at_step=4, sync_ckpt=True)
    with pytest.raises(RuntimeError, match="injected failure"):
        ttrain.train(cfg, OPT, loop, dcfg(cfg), device="cpu")
    res = ttrain.train(cfg, OPT, dataclasses.replace(loop, fail_at_step=None),
                       dcfg(cfg), device="cpu")
    clean = ttrain.train(cfg, OPT, dataclasses.replace(
        loop, fail_at_step=None, ckpt_dir=str(tmp_path / "clean")),
        dcfg(cfg), device="cpu")
    assert res.restored_from == 3 and res.losses == clean.losses[4:]
    assert all(np.isfinite(clean.losses))


def test_train_mesh_one_device_and_more(tmp_path):
    """A one-device mesh; several devices in one process refused; and a
    ``core.distributed.Mesh`` whose data axis spans two ``gloo`` ranks
    (``torch_ranks``' ``train2``): both ranks' losses within
    ``RESUME_RTOL`` of one process's."""
    loop = ttrain.TrainLoopConfig(steps=2, ckpt_every=50,
                                  ckpt_dir=str(tmp_path))
    res = ttrain.train(TINY, OPT, loop, dcfg(TINY),
                       mesh=make_mesh((1,), ("data",), device="cpu"))
    assert res.final_step == 1
    with pytest.raises(ValueError, match="process group"):
        ttrain.train(TINY, OPT, loop, dcfg(TINY), mesh=["cpu", "meta"])
    d = str(tmp_path / "ranks")
    os.makedirs(d)
    R.wait(R.spawn(2, d, ["train2"], "t2"), 120)
    one = ttrain.train(TINY, OPT, dataclasses.replace(
        loop, ckpt_dir=str(tmp_path / "one")), dcfg(TINY), device="cpu")
    for r in range(2):
        got = np.load(os.path.join(d, f"p2-rank{r}.npz"))["train2/losses"]
        np.testing.assert_allclose(got, one.losses, rtol=RESUME_RTOL)


@pytest.mark.parametrize("moments", ["bfloat16", "float32"])
def test_port_resumes_a_jax_run(tmp_path, same_batches, moments):
    """JAX trains 8 steps, failing at step 5 after its checkpoint at step
    3; the port resumes from JAX's directory and its losses for steps 4-7
    match an uninterrupted JAX run's."""
    opt = dataclasses.replace(OPT, moment_dtype=moments)
    jopt_cfg = jopt.OptConfig(**dataclasses.asdict(opt))
    jcfg = jsmoke(jget_config("phi3-mini-3.8b"))
    loop = dict(steps=8, ckpt_every=3, sync_ckpt=True)
    with pytest.raises(RuntimeError, match="injected failure"):
        jtrain.train(jcfg, jopt_cfg, jtrain.TrainLoopConfig(
            ckpt_dir=str(tmp_path / "jax"), fail_at_step=5, **loop),
            jdcfg(jcfg))
    clean = jtrain.train(jcfg, jopt_cfg, jtrain.TrainLoopConfig(
        ckpt_dir=str(tmp_path / "clean"), **loop), jdcfg(jcfg))
    res = ttrain.train(TINY, opt, ttrain.TrainLoopConfig(
        ckpt_dir=str(tmp_path / "jax"), **loop), dcfg(TINY), device="cpu")
    assert res.restored_from == 3 and res.final_step == 7
    np.testing.assert_allclose(res.losses, clean.losses[4:],
                               rtol=RESUME_RTOL)


def test_jax_resumes_a_port_run(tmp_path, same_batches):
    """The reverse, with float32 moments: the port fails at step 5, JAX
    resumes from its directory and matches the port's own uninterrupted
    run."""
    jopt_cfg = jopt.OptConfig(**dataclasses.asdict(OPT))
    jcfg = jsmoke(jget_config("phi3-mini-3.8b"))
    loop = dict(steps=8, ckpt_every=3, sync_ckpt=True)
    with pytest.raises(RuntimeError, match="injected failure"):
        ttrain.train(TINY, OPT, ttrain.TrainLoopConfig(
            ckpt_dir=str(tmp_path / "port"), fail_at_step=5, **loop),
            dcfg(TINY), device="cpu")
    shutil.copytree(tmp_path / "port", tmp_path / "port2")
    clean = ttrain.train(TINY, OPT, ttrain.TrainLoopConfig(
        ckpt_dir=str(tmp_path / "clean"), **loop), dcfg(TINY), device="cpu")
    res = jtrain.train(jcfg, jopt_cfg, jtrain.TrainLoopConfig(
        ckpt_dir=str(tmp_path / "port2"), **loop), jdcfg(jcfg))
    assert res.restored_from == 3 and res.final_step == 7
    np.testing.assert_allclose(res.losses, clean.losses[4:],
                               rtol=RESUME_RTOL)
