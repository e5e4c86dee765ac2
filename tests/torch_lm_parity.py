"""One LM family's JAX results at a small config, and the checks that hold
the port to them: ``forward``, ``prefill`` with every cache leaf, three
decode steps, ``loss_fn`` with every gradient leaf, one AdamW step.
Shared by the parity tests of the recurrent families
(``test_torch_ssm.py``, ``test_torch_griffin.py``)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro import optim as jopt
from repro.models import decode as jdec
from repro.models import steps as jsteps
from repro.models.base import init_params as jinit_params
from repro.models.transformer import forward as jforward
from repro.models.transformer import loss_fn as jloss_fn
from repro.models.transformer import model_layout as jmodel_layout
from repro_torch import optim as topt
from repro_torch.models import steps as tsteps
from repro_torch.models.base import params_from_numpy, tree_map
from repro_torch.models.transformer import DenseLM, forward

ATOL = 2e-5
GRAD_RTOL = 1e-5
STEP_ATOL = 1e-4           # a tenth of OPT.lr
OPT = topt.OptConfig(lr=1e-3, warmup_steps=2, total_steps=50)


def t_(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def close(got, want, what, atol=ATOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=0, err_msg=what)


def assert_tree_close(got, want, what, rtol=0.0, atol=0.0):
    """Every leaf of the port's tree within ``atol`` + ``rtol`` times the
    largest |value| of the JAX leaf; integer leaves equal."""
    for path, w in jax.tree_util.tree_leaves_with_path(want):
        g = got
        for p in path:
            g = g[p.key]
        w = np.asarray(w)
        g = g.detach().numpy()
        where = f"{what} {jax.tree_util.keystr(path)}"
        assert g.shape == w.shape, (where, g.shape, w.shape)
        if not np.issubdtype(w.dtype, np.floating):
            np.testing.assert_array_equal(g, w, err_msg=where)
            continue
        bar = atol + rtol * float(np.abs(w).max())
        np.testing.assert_allclose(g, w, rtol=0, atol=bar, err_msg=where)


def family_results(jcfg, tcfg, B, S, extra, seed=0):
    """Weights (JAX ``init_params``, carried by ``params_from_numpy``),
    numpy inputs and every JAX result the checks below hold the port to,
    each computed once under ``jax.jit``."""
    jparams = jinit_params(jmodel_layout(jcfg), jax.random.key(seed),
                           jcfg.param_dtype)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams),
                                device="cpu")
    rng = np.random.default_rng(seed)
    np_in = dict(
        tokens=rng.integers(0, jcfg.vocab, (B, S)).astype(np.int32),
        labels=rng.integers(0, jcfg.vocab, (B, S)).astype(np.int32),
        steps=rng.integers(0, jcfg.vocab, (3, B, 1)).astype(np.int32))
    toks = jnp.asarray(np_in["tokens"])
    batch = {"tokens": toks, "labels": jnp.asarray(np_in["labels"])}
    out = {"forward": jax.jit(lambda p, t: jforward(jcfg, p, tokens=t))(
        jparams, toks)}
    out["prefill"] = jax.jit(lambda p, t: jdec.prefill(
        jcfg, p, tokens=t, total_len=S + extra))(jparams, toks)
    step = jax.jit(lambda p, c, t, i: jdec.decode_step(jcfg, p, c, t, i))
    cache, decoded = out["prefill"][1], []
    for i in range(3):
        logits, cache = step(jparams, cache, jnp.asarray(np_in["steps"][i]),
                             jnp.int32(S + i))
        decoded.append((logits, cache))
    out["decode"] = decoded
    out["loss"] = jax.jit(jax.value_and_grad(
        lambda p, b: jloss_fn(jcfg, p, b), has_aux=True))(jparams, batch)
    # the train step of ``steps.make_train_step`` (grad_accum 1): these
    # gradients, then the optimizer, which alone is compiled again
    jopt_cfg = jopt.OptConfig(**dataclasses.asdict(OPT))
    (_, metrics), grads = out["loss"]
    new_params, new_opt, gnorm = jax.jit(
        lambda g, o, p: jopt.update(jopt_cfg, g, o, p))(
        grads, jopt.init(jopt_cfg, jparams), jparams)
    out["train"] = new_params, new_opt, dict(metrics, grad_norm=gnorm)
    return dict(jcfg=jcfg, tcfg=tcfg, jparams=jparams, tparams=tparams,
                np_in=np_in, out=out, S=S, extra=extra)


def check_forward(fam):
    logits_j, aux_j = fam["out"]["forward"]
    tokens = t_(fam["np_in"]["tokens"])
    logits, aux = forward(fam["tcfg"], fam["tparams"], tokens=tokens)
    close(logits, logits_j, "forward logits")
    assert aux == aux_j == {}
    lm = DenseLM(fam["tcfg"], fam["tparams"])
    assert sorted(lm.tree()) == sorted(fam["jparams"])
    close(lm(tokens=tokens), logits_j, "DenseLM logits")


def check_prefill_and_decode(fam):
    """Prefill logits and every cache leaf, then three decode steps (their
    logits, next tokens and every cache leaf after each), the cache
    written in place."""
    tcfg, out, np_in, S = fam["tcfg"], fam["out"], fam["np_in"], fam["S"]
    logits_j, cache_j = out["prefill"]
    step = tsteps.make_prefill_step(tcfg, total_len=S + fam["extra"])
    logits, cache = step(fam["tparams"], {"tokens": t_(np_in["tokens"])})
    close(logits, logits_j, "prefill logits")
    assert jax.tree.structure(cache_j) == jax.tree.structure(
        tree_map(lambda a: 0, cache))
    assert_tree_close(cache, cache_j, "prefill cache", atol=ATOL)
    decode = tsteps.make_decode_step(tcfg)
    for i, (dl_j, dcache_j) in enumerate(out["decode"]):
        nxt, dl, cache2 = decode(fam["tparams"], {
            "cache": cache, "idx": S + i, "tokens": t_(np_in["steps"][i])})
        assert cache2 is cache
        close(dl, dl_j, f"decode step {i} logits")
        np.testing.assert_array_equal(
            nxt.numpy(), np.argmax(np.asarray(dl_j)[:, -1], -1))
        assert_tree_close(cache, dcache_j, f"decode step {i} cache",
                          atol=ATOL)


def check_loss_and_gradients(fam, remat=False):
    (jl, jm), jg = fam["out"]["loss"]
    tcfg = dataclasses.replace(fam["tcfg"], remat=remat)
    batch = {k: t_(fam["np_in"][k]) for k in ("tokens", "labels")}
    (tl, tm), tg = tsteps.loss_and_grad(tcfg, fam["tparams"], batch)
    assert sorted(tm) == sorted(jm) == ["loss", "nll"]
    for k in jm:
        close(tm[k], jm[k], k)
    close(tl, jl, "loss")
    assert_tree_close(tg, jg, "gradient", rtol=GRAD_RTOL)


def check_adamw_step(fam):
    jp, js, jmet = fam["out"]["train"]
    tparams = tree_map(lambda a: a.clone(), fam["tparams"])
    batch = {k: t_(fam["np_in"][k]) for k in ("tokens", "labels")}
    tp, ts, tmet = tsteps.make_train_step(fam["tcfg"], OPT)(
        tparams, topt.init(OPT, tparams), batch)
    assert sorted(tmet) == sorted(jmet)
    for k in jmet:
        np.testing.assert_allclose(tmet[k].item(), float(jmet[k]),
                                   rtol=GRAD_RTOL, err_msg=k)
    assert_tree_close(tp, jp, "params", atol=STEP_ATOL)
    assert int(ts["count"]) == int(js["count"]) == 1
    assert_tree_close({k: v for k, v in ts.items() if k != "count"},
                      {k: v for k, v in js.items() if k != "count"},
                      "optimizer state", rtol=GRAD_RTOL)


def shapes_of(tree):
    return jax.tree.map(
        lambda x: (tuple(x.shape), str(x.dtype).replace("torch.", "")),
        tree, is_leaf=lambda x: hasattr(x, "shape"))


def check_abstract_state(jcfg, tcfg):
    """The full config's abstract train state (AdamW, bfloat16 moments):
    the JAX package's shapes, dtypes and logical axes."""
    opt = dataclasses.replace(OPT, moment_dtype="bfloat16")
    jp, jps, jo, jos = jsteps.abstract_train_state(
        jcfg, jopt.OptConfig(**dataclasses.asdict(opt)))
    tp, tps, to, tos = tsteps.abstract_train_state(tcfg, opt)
    assert shapes_of(jp) == shapes_of(tp)
    assert shapes_of(jo) == shapes_of(to)
    is_axes = lambda x: isinstance(x, tuple)  # noqa: E731
    for j, t in ((jps, tps), (jos, tos)):
        assert jax.tree.structure(j, is_leaf=is_axes) == \
            jax.tree.structure(t, is_leaf=is_axes)
        assert jax.tree.leaves(j, is_leaf=is_axes) == \
            jax.tree.leaves(t, is_leaf=is_axes)
    return tp
