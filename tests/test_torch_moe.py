"""The port's moe and mla_moe families against the JAX package's, on the CPU.

For granite-moe-3b-a800m (moe: softmax routing over 8 experts, 16 padded,
top 2) and deepseek-v3-671b (mla_moe: MLA, sigmoid routing with
deepseek's normalisation, a shared expert, one leading dense layer, MTP)
at ``smoke()`` size in float32, both packages get one set of weights (the
JAX ``init_params`` carried by ``params_from_numpy``) and the same inputs,
made with numpy from a seed.  The JAX side of each family is computed
once for the module, under ``jax.jit``.  Within ``ATOL = 2e-5``:

* ``moe_apply`` drop-free (capacity factor 64) and at a capacity factor
  of 0.5, which drops copies: the output, ``lb_loss`` and the count of
  dropped copies (the port's ``record_drops`` against the JAX
  ``dispatch_plan`` of JAX's routing);
* a zeroed router, where every score ties: the port picks the experts
  JAX picks (``jax.lax.top_k`` puts the lower index first; ``torch.topk``
  does not);
* ``mla_apply`` over a prompt and then one position of a cache;
* ``forward`` logits (and ``DenseLM``'s, over the moe tree), ``prefill``
  logits and every cache leaf, three decode steps;
* ``loss_fn`` (``nll``, ``lb_loss`` and deepseek's ``mtp_loss``) and
  every gradient leaf within ``GRAD_RTOL = 1e-5`` of the leaf's largest
  |gradient|; one AdamW train step (parameters within a tenth of the
  learning rate, as ``test_torch_train.py``);
* ``init_cache`` and the full configs' ``abstract_train_state`` against
  the JAX trees.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as jopt
from repro.configs import get_config as jget_config
from repro.configs import smoke as jsmoke
from repro.core.distributed import dispatch_plan as jdispatch_plan
from repro.models import decode as jdec
from repro.models import moe as jmoe
from repro.models import steps as jsteps
from repro.models.base import init_params as jinit_params
from repro.models.transformer import forward as jforward
from repro.models.transformer import loss_fn as jloss_fn
from repro.models.transformer import model_layout as jmodel_layout
from repro_torch import optim as topt
from repro_torch.configs import get_config, smoke
from repro_torch.models import decode as tdec
from repro_torch.models import moe as tmoe
from repro_torch.models import steps as tsteps
from repro_torch.models.base import params_from_numpy, tree_map
from repro_torch.models.transformer import DenseLM, forward, model_layout

ATOL = 2e-5
GRAD_RTOL = 1e-5
STEP_ATOL = 1e-4           # a tenth of OPT.lr
ARCHS = ["granite-moe-3b-a800m", "deepseek-v3-671b"]
B, S, EXTRA = 2, 24, 4
DROP_CF = 0.5              # cap = 8 rows for 48 tokens x 2 copies / 8 experts
OPT = topt.OptConfig(lr=1e-3, warmup_steps=2, total_steps=50)


def close(got, want, what, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=atol, rtol=0, err_msg=what)


def assert_tree_close(got, want, what, rtol=0.0, atol=0.0):
    """Every leaf of the port's tree within ``atol`` + ``rtol`` times the
    largest |value| of the JAX leaf; integer leaves equal."""
    for path, w in jax.tree_util.tree_leaves_with_path(want):
        g = got
        for p in path:
            g = g[p.key]
        w = np.asarray(w)
        g = g.detach().numpy()
        if not np.issubdtype(w.dtype, np.floating):
            np.testing.assert_array_equal(g, w, err_msg=f"{what} "
                                          f"{jax.tree_util.keystr(path)}")
            continue
        bar = atol + rtol * float(np.abs(w).max())
        np.testing.assert_allclose(g, w, rtol=0, atol=bar, err_msg=(
            f"{what} {jax.tree_util.keystr(path)}"))


def layer0(params, stack="moe"):
    """Layer 0 of a stack of either package's tree."""
    return jax.tree.map(lambda a: a[0], params["blocks"][stack])


@pytest.fixture(scope="module", params=ARCHS)
def family(request):
    """The JAX side of one family, computed once: configs, weights, inputs
    and every result the tests below hold the port to."""
    jcfg = jsmoke(jget_config(request.param))
    tcfg = smoke(get_config(request.param))
    jparams = jinit_params(jmodel_layout(jcfg), jax.random.key(0),
                           jcfg.param_dtype)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams),
                                device="cpu")
    rng = np.random.default_rng(0)
    np_in = dict(
        x=rng.normal(size=(B, S, jcfg.d_model)).astype(np.float32),
        tokens=rng.integers(0, jcfg.vocab, (B, S)).astype(np.int32),
        labels=rng.integers(0, jcfg.vocab, (B, S)).astype(np.int32),
        steps=rng.integers(0, jcfg.vocab, (3, B, 1)).astype(np.int32))
    x = jnp.asarray(np_in["x"])
    toks = jnp.asarray(np_in["tokens"])
    batch = {"tokens": toks, "labels": jnp.asarray(np_in["labels"])}
    p_e = layer0(jparams)["experts"]
    out = {}
    for cf in (None, DROP_CF):
        y, lb = jax.jit(lambda p, xx, cf=cf: jmoe.moe_apply(jcfg, p, xx, cf))(
            p_e, x)
        # JAX's dropped copies: its own plan over its own routing
        _, ids, _ = jmoe._route(jcfg, p_e, x.reshape(B * S, -1))
        N, K, E = B * S, jcfg.top_k, jcfg.n_experts
        c = jcfg.moe_capacity if cf is None else cf
        cap = max(8, min(int(np.ceil(N * K / E * c)), N))
        *_, dropped = jdispatch_plan(ids.reshape(-1).astype(jnp.int32),
                                     jcfg.experts_padded, cap)
        out[("moe_apply", cf)] = (y, lb, int(dropped))
    zero = dict(p_e, router=jnp.zeros_like(p_e["router"]))
    out["tied"] = jax.jit(lambda p, xx: jmoe._route(
        jcfg, p, xx.reshape(B * S, -1)))(zero, x)[1], \
        jax.jit(lambda p, xx: jmoe.moe_apply(jcfg, p, xx))(zero, x)
    out["forward"] = jax.jit(lambda p, t: jforward(jcfg, p, tokens=t))(
        jparams, toks)
    prefill = jax.jit(lambda p, t: jdec.prefill(jcfg, p, tokens=t,
                                                total_len=S + EXTRA))
    out["prefill"] = prefill(jparams, toks)
    step = jax.jit(lambda p, c, t, i: jdec.decode_step(jcfg, p, c, t, i))
    cache, decoded = out["prefill"][1], []
    for i in range(3):
        logits, cache = step(jparams, cache, jnp.asarray(np_in["steps"][i]),
                             jnp.int32(S + i))
        decoded.append((logits, cache))
    out["decode"] = decoded
    out["loss"] = jax.jit(jax.value_and_grad(
        lambda p, b: jloss_fn(jcfg, p, b), has_aux=True))(jparams, batch)
    jopt_cfg = jopt.OptConfig(**dataclasses.asdict(OPT))
    out["train"] = jax.jit(jsteps.make_train_step(jcfg, jopt_cfg))(
        jparams, jopt.init(jopt_cfg, jparams), batch)
    if jcfg.use_mla:
        p_a = layer0(jparams)["attn"]
        pos = jnp.broadcast_to(jnp.arange(S), (B, S))
        o, (c_kv, k_rope) = jax.jit(lambda p, xx: jmoe.mla_apply(
            jcfg, p, xx, pos))(p_a, x)
        T = S + EXTRA
        mla_cache = {"c_kv": jnp.zeros((B, T, jcfg.kv_lora_rank)).at[:, :S]
                     .set(c_kv),
                     "k_rope": jnp.zeros((B, T, 1, jcfg.qk_rope_dim))
                     .at[:, :S].set(k_rope), "idx": jnp.int32(S)}
        x1 = x[:, :1] * 0.5
        out["mla"] = (o, c_kv, k_rope, jax.jit(lambda p, xx, c: jmoe.mla_apply(
            jcfg, p, xx, jnp.full((B, 1), S), cache=c))(p_a, x1, mla_cache))
    return dict(jcfg=jcfg, tcfg=tcfg, jparams=jparams, tparams=tparams,
                np_in=np_in, out=out)


def t_(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("cf", [None, DROP_CF], ids=["drop-free", "dropping"])
def test_moe_apply(family, cf):
    tcfg, out = family["tcfg"], family["out"]
    y_j, lb_j, dropped_j = out[("moe_apply", cf)]
    p_e = layer0(family["tparams"])["experts"]
    with tmoe.record_drops() as drops:
        y, lb = tmoe.moe_apply(tcfg, p_e, t_(family["np_in"]["x"]), cf)
    close(y, y_j, "moe_apply output")
    close(lb, lb_j, "lb_loss")
    assert len(drops) == 1 and int(drops[0]) == dropped_j
    assert (dropped_j > 0) == (cf == DROP_CF), dropped_j


def test_tied_router_picks_jax_experts(family):
    """A zeroed router: every expert's score ties.  The port's top k is
    JAX's (the lower ids first) and so is the layer's output."""
    tcfg, (ids_j, (y_j, lb_j)) = family["tcfg"], family["out"]["tied"]
    p_e = dict(layer0(family["tparams"])["experts"])
    p_e["router"] = torch.zeros_like(p_e["router"])
    x = t_(family["np_in"]["x"])
    _, ids, _ = tmoe._route(tcfg, p_e, x.reshape(B * S, -1))
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ids_j))
    assert (ids.numpy() == np.arange(tcfg.top_k)).all()
    y, lb = tmoe.moe_apply(tcfg, p_e, x)
    close(y, y_j, "tied moe_apply output")
    close(lb, lb_j, "tied lb_loss")


def test_mla_prefill_and_decode(family):
    tcfg, out = family["tcfg"], family["out"]
    if not tcfg.use_mla:
        assert "mla" not in out
        return
    o_j, c_kv_j, k_rope_j, (o1_j, (c1_j, kr1_j)) = out["mla"]
    p_a = layer0(family["tparams"])["attn"]
    x = t_(family["np_in"]["x"])
    pos = torch.arange(S).expand(B, S)
    o, (c_kv, k_rope) = tmoe.mla_apply(tcfg, p_a, x, pos)
    close(o, o_j, "mla prefill")
    close(c_kv, c_kv_j, "c_kv")
    close(k_rope, k_rope_j, "k_rope")
    T = S + EXTRA
    cache = {"c_kv": torch.zeros(B, T, tcfg.kv_lora_rank),
             "k_rope": torch.zeros(B, T, 1, tcfg.qk_rope_dim), "idx": S}
    cache["c_kv"][:, :S] = c_kv
    cache["k_rope"][:, :S] = k_rope
    o1, (c1, kr1) = tmoe.mla_apply(tcfg, p_a, x[:, :1] * 0.5,
                                   torch.full((B, 1), S), cache=cache)
    assert c1 is cache["c_kv"] and kr1 is cache["k_rope"], "written in place"
    close(o1, o1_j, "mla decode")
    close(c1, c1_j, "c_kv after decode")
    close(kr1, kr1_j, "k_rope after decode")


def test_forward_logits(family):
    tcfg, out = family["tcfg"], family["out"]
    logits_j, aux_j = out["forward"]
    logits, aux = forward(tcfg, family["tparams"],
                          tokens=t_(family["np_in"]["tokens"]))
    close(logits, logits_j, "forward logits")
    assert sorted(aux) == sorted(aux_j) == ["h_final", "lb_loss"]
    close(aux["lb_loss"], aux_j["lb_loss"], "aux lb_loss")
    close(aux["h_final"], aux_j["h_final"], "aux h_final")
    lm = DenseLM(tcfg, family["tparams"])
    assert sorted(lm.tree()) == sorted(family["jparams"])
    close(lm(tokens=t_(family["np_in"]["tokens"])), logits_j,
          "DenseLM logits")


def test_prefill_and_three_decode_steps(family):
    """Prefill logits and every cache leaf, then three decode steps (their
    logits and every cache leaf after each), the cache written in
    place."""
    tcfg, out, np_in = family["tcfg"], family["out"], family["np_in"]
    tparams = family["tparams"]
    logits_j, cache_j = out["prefill"]
    step = tsteps.make_prefill_step(tcfg, total_len=S + EXTRA)
    logits, cache = step(tparams, {"tokens": t_(np_in["tokens"])})
    close(logits, logits_j, "prefill logits")
    assert jax.tree.structure(cache_j) == jax.tree.structure(
        tree_map(lambda a: 0, cache))
    assert_tree_close(cache, cache_j, "prefill cache", atol=ATOL)
    decode = tsteps.make_decode_step(tcfg)
    for i, (dl_j, dcache_j) in enumerate(out["decode"]):
        nxt, dl, cache2 = decode(tparams, {"cache": cache, "idx": S + i,
                                           "tokens": t_(np_in["steps"][i])})
        assert cache2 is cache
        close(dl, dl_j, f"decode step {i} logits")
        np.testing.assert_array_equal(
            nxt.numpy(), np.argmax(np.asarray(dl_j)[:, -1], -1))
        assert_tree_close(cache, dcache_j, f"decode step {i} cache",
                          atol=ATOL)


def test_loss_and_gradients(family):
    tcfg, (jl, jm), jg = family["tcfg"], *family["out"]["loss"]
    np_in = family["np_in"]
    batch = {"tokens": t_(np_in["tokens"]), "labels": t_(np_in["labels"])}
    (tl, tm), tg = tsteps.loss_and_grad(tcfg, family["tparams"], batch)
    want = ["lb_loss", "loss", "nll"] + (["mtp_loss"] if tcfg.mtp_depth
                                         else [])
    assert sorted(tm) == sorted(jm) == sorted(want)
    for k in jm:
        close(tm[k], jm[k], k)
    close(tl, jl, "loss")
    assert tcfg.mtp_depth == 0 or "mtp" in tg
    assert_tree_close(tg, jg, "gradient", rtol=GRAD_RTOL)


def test_adamw_train_step(family):
    tcfg, (jp, js, jmet) = family["tcfg"], family["out"]["train"]
    np_in = family["np_in"]
    tparams = tree_map(lambda a: a.clone(), family["tparams"])
    batch = {"tokens": t_(np_in["tokens"]), "labels": t_(np_in["labels"])}
    tp, ts, tmet = tsteps.make_train_step(tcfg, OPT)(
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


@pytest.mark.parametrize("arch", ARCHS)
def test_init_cache_and_abstract_state_match_jax(arch):
    jcfg, tcfg = jsmoke(jget_config(arch)), smoke(get_config(arch))
    jc = jdec.init_cache(jcfg, B, S)
    tc = tdec.init_cache(tcfg, B, S, device="cpu")
    assert shapes_of(jc) == shapes_of(tc)
    assert_tree_close(tc, jc, "init_cache")
    opt = dataclasses.replace(OPT, moment_dtype="bfloat16")
    jp, jps, jo, jos = jsteps.abstract_train_state(
        jget_config(arch), jopt.OptConfig(**dataclasses.asdict(opt)))
    tp, tps, to, tos = tsteps.abstract_train_state(get_config(arch), opt)
    assert shapes_of(jp) == shapes_of(tp)
    assert shapes_of(jo) == shapes_of(to)
    is_axes = lambda x: isinstance(x, tuple)  # noqa: E731
    assert jax.tree.structure(jps, is_leaf=is_axes) == \
        jax.tree.structure(tps, is_leaf=is_axes)
    assert jax.tree.leaves(jps, is_leaf=is_axes) == \
        jax.tree.leaves(tps, is_leaf=is_axes)
    assert jax.tree.leaves(jos, is_leaf=is_axes) == \
        jax.tree.leaves(tos, is_leaf=is_axes)


def test_granite_full_width_count():
    """granite-moe-3b-a800m at its published widths: 3,903,161,856
    parameters by the layout (48 padded experts), where ``param_count``
    counts the 40 real ones."""
    from repro_torch.models.base import abstract_params, tree_bytes
    cfg = get_config("granite-moe-3b-a800m")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.hd,
            cfg.n_experts, cfg.experts_padded, cfg.top_k, cfg.d_ff_expert,
            cfg.vocab_padded) == (32, 1536, 24, 8, 64, 40, 48, 8, 512, 49408)
    tree = abstract_params(model_layout(cfg), cfg.param_dtype)
    assert tree_bytes(tree) == 4 * 3_903_161_856
    assert cfg.param_count() == 3_298_793_472


def test_capacity_is_the_reference_formula():
    cfg = get_config("granite-moe-3b-a800m")
    assert tmoe.capacity(cfg, 8 * 2048) == 4096       # the prefill
    assert tmoe.capacity(cfg, 8) == 8                 # a decode step
    assert tmoe.capacity(cfg, 4 * 2048) == 2048       # a train step
    assert tmoe.capacity(cfg, 512, 5.0) == 512        # drop-free: cap = N


@pytest.mark.parametrize("dt", ["bfloat16", "float32"])
def test_combine_reproduces_the_reference_scatter_add(dt):
    """``combine`` against the reference's combine (``moe.py:250-255``:
    a gather by slot, the gates in the activation dtype, ``.at[tok_of]
    .add``) at granite's top 8 of 40 experts and 48 padded, a capacity
    that drops copies: equal bit for bit on the CPU."""
    from repro.core.distributed import dispatch_plan
    from repro_torch.core.distributed import dispatch_plan as tdispatch_plan
    rng = np.random.default_rng(0)
    N, K, Ep, d, cap = 512, 8, 48, 64, 100
    ids = np.stack([rng.permutation(40)[:K] for _ in range(N)]) \
        .astype(np.int32)
    gates = rng.random((N, K)).astype(np.float32)
    y = rng.normal(size=(Ep * cap, d)).astype(np.float32)

    @jax.jit
    def reference(ids, gates, y):
        order, slot, keep, _ = dispatch_plan(ids.reshape(-1), Ep, cap)
        tok_of = (jnp.arange(N * K, dtype=jnp.int32) // K)[order]
        g = gates.reshape(-1).astype(dt)
        contrib = y[jnp.where(keep, slot, 0)] * \
            jnp.where(keep, g[order], 0.0)[:, None]
        return jnp.zeros((N, d), dt).at[tok_of].add(contrib), keep
    want, keep = reference(jnp.asarray(ids), jnp.asarray(gates),
                           jnp.asarray(y).astype(dt))
    assert not bool(keep.all())
    tids = t_(ids).long()
    order, slot, _, _ = tdispatch_plan(tids.reshape(-1).int(), Ep, cap)
    rows = torch.empty_like(slot).scatter_(0, order.long(), slot).long()
    got = tmoe.combine(t_(y).to(getattr(torch, dt)), rows.view(N, K), tids,
                       t_(gates))
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))
