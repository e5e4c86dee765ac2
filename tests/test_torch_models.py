"""The port's dense LM against the JAX package's, on the CPU.

For each of the six dense ``ARCH_IDS`` at ``smoke()`` size (two layers,
d 64, float32) both packages get one set of weights — the JAX
``init_params`` carried leaf for leaf with ``params_from_numpy`` — and
the same inputs, made with numpy from a seed: ``forward`` logits,
``prefill`` logits and every cache leaf, then three ``decode_step``s
(logits and every cache leaf after each) must agree within
``ATOL = 2e-5`` in float32 (measured: at most 3.1e-6; the two packages
sum in other orders).  The cache positions are integers and must be
equal.  ``ModelConfig``'s derived fields and parameter counts equal the
JAX package's for all ten configs, and a family the port does not serve
yet raises with its ROADMAP item.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS as JAX_ARCH_IDS
from repro.configs import get_config as jget_config
from repro.configs import smoke as jsmoke
from repro.models import decode as jdec
from repro.models import steps as jsteps
from repro.models.base import init_params as jinit_params
from repro.models.transformer import forward as jforward
from repro.models.transformer import model_layout as jmodel_layout
from repro_torch.configs import ARCH_IDS, get_config, smoke
from repro_torch.models import decode as tdec
from repro_torch.models import steps as tsteps
from repro_torch.models.base import (cast_floats, init_params,
                                     params_from_numpy, params_to_numpy,
                                     tree_bytes)
from repro_torch.models.transformer import DenseLM, forward, model_layout

ATOL = 2e-5
DENSE = [a for a in ARCH_IDS if get_config(a).family == "dense"]
B, S, EXTRA = 2, 24, 4


def test_dense_arch_ids():
    assert ARCH_IDS == JAX_ARCH_IDS
    assert DENSE == ["musicgen-medium", "command-r-plus-104b", "yi-34b",
                     "phi3-mini-3.8b", "gemma-7b", "chameleon-34b"]


@pytest.fixture(scope="module", params=DENSE)
def arch(request):
    """(JAX smoke config, the port's, JAX params, the port's copy)."""
    jcfg = jsmoke(jget_config(request.param))
    tcfg = smoke(get_config(request.param))
    jparams = jinit_params(jmodel_layout(jcfg), jax.random.key(0),
                           jcfg.param_dtype)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams),
                                device="cpu")
    return jcfg, tcfg, jparams, tparams


def inputs(cfg, rng, s):
    """{"tokens": (B, s) ids} or {"embeds": (B, s, d)}, as numpy."""
    if cfg.input_mode == "embeddings":
        return {"embeds": rng.normal(size=(B, s, cfg.d_model))
                .astype(np.float32)}
    return {"tokens": rng.integers(0, cfg.vocab, (B, s)).astype(np.int32)}


def both(batch):
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(v) for k, v in batch.items()})


def close(got, want, what):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0, err_msg=what)


def assert_cache(tcache, jcache, what):
    assert sorted(tcache) == sorted(jcache) == ["k", "pos", "v"]
    for name in ("k", "v"):
        close(tcache[name], jcache[name], f"{what}: cache {name}")
    np.testing.assert_array_equal(tcache["pos"].numpy(),
                                  np.asarray(jcache["pos"]))


def test_forward_logits(arch, rng):
    jcfg, tcfg, jparams, tparams = arch
    jb, tb = both(inputs(tcfg, rng, S))
    want, _ = jforward(jcfg, jparams, **jb)
    got, aux = forward(tcfg, tparams, **tb)
    assert aux == {} and got.shape == want.shape
    close(got, want, "forward logits")
    close(DenseLM(tcfg, tparams)(**tb), want, "DenseLM logits")


def test_prefill_logits_and_cache(arch, rng):
    jcfg, tcfg, jparams, tparams = arch
    jb, tb = both(inputs(tcfg, rng, S))
    jl, jcache = jsteps.make_prefill_step(jcfg, total_len=S + EXTRA)(
        jparams, jb)
    tl, tcache = tsteps.make_prefill_step(tcfg, total_len=S + EXTRA)(
        tparams, tb)
    close(tl, jl, "prefill logits")
    assert_cache(tcache, jcache, "prefill")


def test_three_decode_steps(arch, rng):
    jcfg, tcfg, jparams, tparams = arch
    jb, tb = both(inputs(tcfg, rng, S))
    _, jcache = jdec.prefill(jcfg, jparams, total_len=S + EXTRA, **jb)
    _, tcache = tdec.prefill(tcfg, tparams, total_len=S + EXTRA, **tb)
    jstep, tstep = jsteps.make_decode_step(jcfg), \
        tsteps.make_decode_step(tcfg)
    for i in range(3):
        one = inputs(tcfg, rng, 1)
        jx, tx = both(one)
        jx, tx = next(iter(jx.values())), next(iter(tx.values()))
        jn, jl, jcache = jstep(jparams, {"cache": jcache, "tokens": jx,
                                         "idx": jnp.int32(S + i)})
        tn, tl, tcache2 = tstep(tparams, {"cache": tcache, "tokens": tx,
                                          "idx": S + i})
        assert tcache2 is tcache, "the decode step writes the cache in place"
        close(tl, jl, f"decode step {i} logits")
        np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
        assert tn.dtype == torch.int32
        assert_cache(tcache, jcache, f"decode step {i}")


def test_sliding_window_ring_cache(rng):
    """A prompt longer than the window fills the ring as the JAX
    ``_fill_ring`` does, and decoding wraps around it (the smoke configs
    have no window, so one is set here)."""
    jcfg = dataclasses.replace(jsmoke(jget_config("phi3-mini-3.8b")),
                               sliding_window=8)
    tcfg = dataclasses.replace(smoke(get_config("phi3-mini-3.8b")),
                               sliding_window=8)
    jparams = jinit_params(jmodel_layout(jcfg), jax.random.key(1), "float32")
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    jb, tb = both(inputs(tcfg, rng, 13))
    jl, jcache = jdec.prefill(jcfg, jparams, total_len=20, **jb)
    tl, tcache = tdec.prefill(tcfg, tparams, total_len=20, **tb)
    close(tl, jl, "windowed prefill logits")
    assert_cache(tcache, jcache, "windowed prefill")
    for i in range(3):
        tok = rng.integers(0, tcfg.vocab, (B, 1)).astype(np.int32)
        jl, jcache = jdec.decode_step(jcfg, jparams, jcache,
                                      jnp.asarray(tok), jnp.int32(13 + i))
        tl, tcache = tdec.decode_step(tcfg, tparams, tcache,
                                      torch.from_numpy(tok), 13 + i)
        close(tl, jl, f"windowed decode {i}")
        assert_cache(tcache, jcache, f"windowed decode {i}")


@pytest.mark.parametrize("arch_id", JAX_ARCH_IDS)
def test_config_derived_fields(arch_id):
    j, t = jget_config(arch_id), get_config(arch_id)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    for cfg_j, cfg_t in ((j, t), (jsmoke(j), smoke(t))):
        assert (cfg_t.hd, cfg_t.vocab_padded, cfg_t.experts_padded) == \
            (cfg_j.hd, cfg_j.vocab_padded, cfg_j.experts_padded)
        assert cfg_t.param_count() == cfg_j.param_count()
        assert cfg_t.active_param_count() == cfg_j.active_param_count()


def test_phi3_full_width_count():
    cfg = get_config("phi3-mini-3.8b")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.hd,
            cfg.d_ff, cfg.vocab, cfg.vocab_padded) == \
        (32, 3072, 32, 32, 96, 8192, 32064, 32256)
    # the layout's leaves, from the meta-device stand-in: no storage
    from repro_torch.models.base import abstract_params
    tree = abstract_params(model_layout(cfg), cfg.param_dtype)
    assert tree_bytes(tree) == 4 * 3_822_259_200


@pytest.mark.parametrize("arch_id", [a for a in ARCH_IDS if a not in DENSE])
def test_other_families_raise_with_roadmap_item(arch_id):
    cfg = smoke(get_config(arch_id))
    with pytest.raises(NotImplementedError, match="ROADMAP A10"):
        model_layout(cfg)
    with pytest.raises(NotImplementedError, match="ROADMAP A10"):
        tdec.init_cache(cfg, 2, 8, device="cpu")


def test_init_params_layout_and_generator():
    """``init_params`` on a generator: the JAX layout's shapes, zeros and
    the 0.02 / 1/sqrt(fan_in) scales, the same numbers from the same
    seed; ``cast_floats`` returns a leaf of the right dtype as itself."""
    cfg = smoke(get_config("gemma-7b"))
    layout = model_layout(cfg)
    a = init_params(layout, torch.Generator().manual_seed(3), "float32")
    b = init_params(layout, torch.Generator().manual_seed(3), "float32")
    jtree = jax.eval_shape(lambda: jinit_params(
        jmodel_layout(jsmoke(jget_config("gemma-7b"))), jax.random.key(0),
        "float32"))
    assert jax.tree.map(lambda s: tuple(s.shape), jtree) == \
        jax.tree.map(lambda x: tuple(x.shape), params_to_numpy(a))
    assert torch.equal(a["embed"]["tok"], b["embed"]["tok"])
    assert not a["blocks"]["ln1"].any()
    assert abs(a["embed"]["tok"].std().item() - 0.02) < 2e-3
    wq = a["blocks"]["attn"]["wq"]
    assert abs(wq.std().item() - 1 / 8) < 1e-2          # 1/sqrt(d = 64)
    assert cast_floats(a, "float32")["blocks"]["attn"]["wq"] is wq
    half = cast_floats(a, torch.bfloat16)
    assert half["blocks"]["attn"]["wq"].dtype == torch.bfloat16


def test_params_numpy_roundtrip(arch):
    _, _, jparams, tparams = arch
    back = params_to_numpy(tparams)
    jax.tree.map(np.testing.assert_array_equal, jax.tree.map(np.asarray,
                                                             jparams), back)


def test_default_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        params_from_numpy({"w": np.zeros(2, np.float32)})
    with pytest.raises(RuntimeError, match="CUDA"):
        tdec.init_cache(smoke(get_config("phi3-mini-3.8b")), 1, 4)
