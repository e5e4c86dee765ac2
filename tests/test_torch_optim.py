"""The port's optimizers against the JAX package's, on the CPU.

Both packages get the same numpy parameters and gradients.  The bars:

* ``schedule`` at every step 0..``total_steps`` and the global norm of
  ``clip_by_global_norm``: ``RTOL = 1e-6`` (float32 ``cos`` and sums of
  squares in other orders; measured at most 1.1e-7);
* AdamW with float32 moments, three steps: parameters and moments within
  ``RTOL`` of the largest value of their leaf (measured at most 3.1e-7);
  with bfloat16 moments at most one bfloat16 ulp apart in the moments
  (measured: equal) and ``RTOL`` in the parameters;
* Adafactor on rank-1, rank-2 and rank-3 leaves, three steps: ``RTOL``
  (measured at most 2.4e-7);
* ``quantize_int8``: the same int8 codes and scale, exactly;
* the reference's quadratic-descent cases (``tests/test_substrates.py``),
  as parametrised cases: the port's loss falls as JAX's does, and its
  parameters track JAX's within ``QUAD_ATOL = 1e-5`` over 60 steps
  (measured at most 1.5e-8).

The port updates in place, so every call gets fresh copies.
"""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro import optim as jopt
from repro_torch import optim as topt
from repro_torch import sharding as tshd
from repro_torch.models.base import params_from_numpy

RTOL = 1e-6
QUAD_ATOL = 1e-5
CFG = topt.OptConfig(lr=1e-2, warmup_steps=2, total_steps=20)


def jcfg(cfg):
    return jopt.OptConfig(**dataclasses.asdict(cfg))


def t_tree(tree):
    return params_from_numpy(tree, device="cpu")


def j_tree(tree):
    return jax.tree.map(jnp.asarray, tree)


def np_tree(tree):
    """A tree of either package as float32/int numpy arrays."""
    def host(x):
        if isinstance(x, torch.Tensor):
            return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
        x = np.asarray(x)
        return x.astype(np.float32) if x.dtype == ml_dtypes.bfloat16 else x
    return jax.tree.map(host, tree, is_leaf=lambda x: isinstance(
        x, torch.Tensor))


def assert_close_tree(got, want, what, rtol=RTOL):
    got, want = np_tree(got), np_tree(want)
    assert jax.tree.structure(got) == jax.tree.structure(want), what
    for path, w in jax.tree_util.tree_leaves_with_path(want):
        g = got
        for p in path:
            g = g[p.key]
        scale = max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(g, w, rtol=0, atol=rtol * scale,
                                   err_msg=f"{what} {path}")


def params_and_grads(rng, shapes):
    p = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    g = {k: (0.1 * rng.normal(size=s)).astype(np.float32)
         for k, s in shapes.items()}
    return {"blocks": {k: v for k, v in p.items() if k != "b"},
            "b": p["b"]}, \
        {"blocks": {k: v for k, v in g.items() if k != "b"}, "b": g["b"]}


SHAPES = {"w3": (3, 6, 5), "w2": (4, 7), "b": (5,)}


@pytest.mark.parametrize("cfg", [CFG, dataclasses.replace(
    CFG, warmup_steps=0, total_steps=7, min_lr_frac=0.0)])
def test_schedule_every_step(cfg):
    steps = np.arange(cfg.total_steps + 1, dtype=np.int32)
    want = np.asarray(jopt.schedule(jcfg(cfg), jnp.asarray(steps)))
    got = topt.schedule(cfg, torch.from_numpy(steps)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)


@pytest.mark.parametrize("max_norm", [1.0, 1e3])
def test_clip_by_global_norm(rng, max_norm):
    _, g = params_and_grads(rng, SHAPES)
    want, jn = jopt.clip_by_global_norm(j_tree(g), max_norm)
    tg = t_tree(g)
    got, tn = topt.clip_by_global_norm(tg, max_norm)
    assert got is tg, "the port scales the gradients in place"
    np.testing.assert_allclose(tn.item(), float(jn), rtol=RTOL)
    assert_close_tree(got, want, "clipped")


def run_both(cfg, rng, shapes=SHAPES, steps=3):
    """``steps`` updates of both packages from the same state and the
    same gradients; returns (port params, port state, JAX params, JAX
    state)."""
    p, _ = params_and_grads(rng, shapes)
    jp, tp = j_tree(p), t_tree(p)
    js, ts = jopt.init(jcfg(cfg), jp), topt.init(cfg, tp)
    for _ in range(steps):
        _, g = params_and_grads(rng, shapes)
        jp, js, jn = jopt.update(jcfg(cfg), j_tree(g), js, jp)
        tp2, ts, tn = topt.update(cfg, t_tree(g), ts, tp)
        assert tp2 is tp, "the port updates the parameters in place"
        np.testing.assert_allclose(tn.item(), float(jn), rtol=RTOL)
    assert ts["count"].item() == int(js["count"]) == steps
    return tp, ts, jp, js


def test_adamw_float32_moments(rng):
    tp, ts, jp, js = run_both(CFG, rng)
    assert ts["m"]["b"].dtype == torch.float32
    assert_close_tree(tp, jp, "params")
    for name in ("m", "v"):
        assert_close_tree(ts[name], js[name], name)


def test_adamw_bfloat16_moments(rng):
    cfg = dataclasses.replace(CFG, moment_dtype="bfloat16")
    tp, ts, jp, js = run_both(cfg, rng)
    assert_close_tree(tp, jp, "params")
    for name in ("m", "v"):
        for path, w in jax.tree_util.tree_leaves_with_path(js[name]):
            g = ts[name]
            for p in path:
                g = g[p.key]
            assert g.dtype == torch.bfloat16
            words = np.asarray(w).view(np.int16).astype(np.int32)
            got = g.view(torch.int16).numpy().astype(np.int32)
            assert np.abs(got - words).max() <= 1, f"{name} {path}"


@pytest.mark.parametrize("shapes", [{"b": (6,)}, {"w2": (4, 7), "b": (5,)},
                                    {"w3": (3, 6, 5), "b": (5,)}],
                         ids=["rank1", "rank2", "rank3"])
def test_adafactor(rng, shapes):
    cfg = dataclasses.replace(CFG, kind="adafactor")
    tp, ts, jp, js = run_both(cfg, rng, shapes)
    assert_close_tree(tp, jp, "params")
    assert_close_tree(ts["f"], js["f"], "factors")
    if "w3" in shapes:
        assert tuple(ts["f"]["blocks"]["w3"]["row"].shape) == (3, 6)
        assert tuple(ts["f"]["blocks"]["w3"]["col"].shape) == (3, 5)


def test_quantize_int8(rng):
    x = rng.normal(size=512).astype(np.float32)
    jq, js = jopt.quantize_int8(jnp.asarray(x))
    tq, ts = topt.quantize_int8(torch.from_numpy(x))
    assert tq.dtype == torch.int8
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert ts.item() == float(js)


def test_compressed_psum_names_its_roadmap_item(tmp_path):
    """On a one-rank "pod" axis (a ``gloo`` group of this process) the
    reference's one-device result: ``q`` bit for bit, the mean over one
    rank and the carried error within 1e-6."""
    from repro import sharding as jshd
    from torch_ranks import one_rank
    rng = np.random.default_rng(5)
    x = rng.normal(size=(3, 40)).astype(np.float32)
    err = (1e-3 * rng.normal(size=(3, 40))).astype(np.float32)
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]), ("pod",))
    body = jshd.shard_map(lambda a, e: jopt.compressed_psum(a, "pod", e),
                          mesh=mesh, in_specs=(jax.sharding.PartitionSpec(),
                                               jax.sharding.PartitionSpec()),
                          out_specs=(jax.sharding.PartitionSpec(),
                                     jax.sharding.PartitionSpec()),
                          check_vma=False)
    jmean, jerr = jax.jit(body)(jnp.asarray(x), jnp.asarray(err))
    with one_rank(str(tmp_path), "pod") as m, tshd.use_mesh(m):
        mean, new_err = topt.compressed_psum(torch.from_numpy(x), "pod",
                                             torch.from_numpy(err))
    # XLA contracts xf - q * scale into a fused multiply-add: the error is
    # held within 1e-6, as across ranks (tests/test_torch_mesh.py)
    np.testing.assert_allclose(mean.numpy(), np.asarray(jmean), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(new_err.numpy(), np.asarray(jerr), rtol=0,
                               atol=1e-6)
    np.testing.assert_array_equal(
        topt.quantize_int8(torch.from_numpy(x + err))[0].numpy(),
        np.asarray(jopt.quantize_int8(jnp.asarray(x) + jnp.asarray(err))[0]))


def quad_loss(p):
    return (p["w"] ** 2).sum() + p["b"] ** 2


@pytest.mark.parametrize("kind", ["adamw", "adafactor"])
def test_optimizer_reduces_quadratic(kind):
    """``test_substrates.py::test_optimizer_reduces_quadratic`` in both
    packages, step for step."""
    cfg = topt.OptConfig(kind=kind, lr=0.05, weight_decay=0.0,
                         warmup_steps=1, total_steps=200)
    p = {"w": np.array([2.0, -3.0, 1.0], np.float32),
         "b": np.float32(0.5)}
    jp, tp = j_tree(p), t_tree(p)
    js, ts = jopt.init(jcfg(cfg), jp), topt.init(cfg, tp)
    l0 = float(quad_loss(tp))
    for _ in range(60):
        jp, js, _ = jopt.update(jcfg(cfg), jax.grad(quad_loss)(jp), js, jp)
        live = {k: v.detach().requires_grad_() for k, v in tp.items()}
        grads = dict(zip(live, torch.autograd.grad(quad_loss(live),
                                                   list(live.values()))))
        tp, ts, _ = topt.update(cfg, grads, ts, tp)
        for k in p:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       rtol=0, atol=QUAD_ATOL)
    assert float(quad_loss(tp)) < 0.2 * l0


def test_adamw_bf16_moments_tracks_fp32():
    """``test_substrates.py::test_adamw_bf16_moments_tracks_fp32`` on the
    port."""
    k32 = topt.OptConfig(kind="adamw", lr=0.05, weight_decay=0.0)
    k16 = dataclasses.replace(k32, moment_dtype="bfloat16")

    def start():
        return t_tree({"w": np.array([2.0, -3.0, 1.0], np.float32),
                       "b": np.float32(0.5)})
    p32, p16 = start(), start()
    s32, s16 = topt.init(k32, p32), topt.init(k16, p16)
    for _ in range(30):
        p32, s32, _ = topt.update(k32, {k: 2 * v for k, v in p32.items()},
                                  s32, p32)
        p16, s16, _ = topt.update(k16, {k: 2 * v for k, v in p16.items()},
                                  s16, p16)
    assert s16["m"]["w"].dtype == torch.bfloat16
    np.testing.assert_allclose(p32["w"].numpy(), p16["w"].numpy(), atol=0.05)


@pytest.mark.parametrize("kind,moments", [("adamw", "float32"),
                                          ("adamw", "bfloat16"),
                                          ("adafactor", "float32")])
def test_opt_state_from_numpy(rng, kind, moments):
    """A JAX state (after one update) carried into the port leaf for leaf,
    bfloat16 moments included, and the next update of both agrees."""
    cfg = dataclasses.replace(CFG, kind=kind, moment_dtype=moments)
    p, g = params_and_grads(rng, SHAPES)
    jp, js, _ = jopt.update(jcfg(cfg), j_tree(g), jopt.init(jcfg(cfg),
                                                            j_tree(p)),
                            j_tree(p))
    host = jax.tree.map(np.asarray, js)
    ts = topt.opt_state_from_numpy(host, device="cpu")
    for path, w in jax.tree_util.tree_leaves_with_path(host):
        got = ts
        for q in path:
            got = got[q.key]
        assert str(got.dtype).endswith(str(w.dtype)), path
        np.testing.assert_array_equal(np_tree(got), np_tree(w))
    tp = t_tree(jax.tree.map(np.asarray, jp))
    _, g2 = params_and_grads(rng, SHAPES)
    jp, js, _ = jopt.update(jcfg(cfg), j_tree(g2), js, jp)
    tp, ts, _ = topt.update(cfg, t_tree(g2), ts, tp)
    assert_close_tree(tp, jp, "params after the carried state's update")
    with pytest.raises(ValueError, match="AdamW or Adafactor"):
        topt.opt_state_from_numpy({"m": host.get("m")}, device="cpu")
