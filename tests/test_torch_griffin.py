"""The port's griffin family (recurrentgemma) against the JAX package's,
on the CPU.

recurrentgemma-9b at ``smoke()`` size with 5 layers (one (rec, rec,
attn) group and a tail of 2 recurrent layers; ``smoke()``'s 3 layers
have no tail), d 64, 4 heads of 16 over one KV head, a window of 16,
lru width 64, in float32: both packages get one set of weights (the JAX
``init_params`` carried by ``params_from_numpy``) and the same inputs,
made with numpy from a seed; the JAX side is computed once for the
module, under ``jax.jit``.

* ``_rg_lru_scan`` equals the jitted ``jax.lax.associative_scan`` bit for
  bit at S = 1, 2, 37, 256 and 2048 (the port runs JAX's odd/even
  recursion and rounds ``a2 * b1 + b2`` once, as XLA's fused
  multiply-add does): the states, and the prefix products of the decays
  where XLA does not flush them to zero as denormals;
* ``rec_apply`` over a prompt and then token by token from a zero state
  (``h`` float32, the conv tail), within ``ATOL = 2e-5``;
* ``forward`` (and ``DenseLM``), ``prefill`` at S = 40 (the ring of 16
  wraps) with every cache leaf, three decode steps, ``loss_fn`` with every
  gradient leaf within ``GRAD_RTOL = 1e-5`` of the leaf's largest, with
  and without remat, one AdamW step; within ``ATOL``;
* ``init_cache`` and the full config's abstract train state against the
  JAX trees.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import smoke as jsmoke
from repro.models import decode as jdec
from repro.models import griffin as jgr
from repro_torch.configs import get_config, smoke
from repro_torch.models import decode as tdec
from repro_torch.models import griffin as tgr
from torch_lm_parity import (assert_tree_close, check_abstract_state,
                             check_adamw_step, check_forward,
                             check_loss_and_gradients,
                             check_prefill_and_decode, close,
                             family_results, shapes_of, t_)

ARCH = "recurrentgemma-9b"
LAYERS = 5                       # one group and a tail of two
B, S, EXTRA = 2, 40, 3           # 40 tokens: the ring of 16 wraps


def configs():
    return (dataclasses.replace(jsmoke(jget_config(ARCH)), n_layers=LAYERS),
            dataclasses.replace(smoke(get_config(ARCH)), n_layers=LAYERS))


@pytest.fixture(scope="module")
def fam():
    jcfg, tcfg = configs()
    assert tcfg.n_layers % tcfg.attn_every == 2 and tcfg.sliding_window < S
    return family_results(jcfg, tcfg, B, S, EXTRA)


@pytest.mark.parametrize("s", [1, 2, 37, 256, 2048])
def test_rg_lru_scan_bit_for_bit(s):
    """h_t = a_t h_{t-1} + b_t, equal to the jitted JAX scan bit for bit,
    and so are the prefix products of a wherever they are normal float32
    numbers: XLA on the CPU flushes denormal results to zero, which the
    products of 2048 decays reach, and PyTorch keeps them."""
    rng = np.random.default_rng(s)
    a = rng.uniform(0.5, 1.0, (B, s, 64)).astype(np.float32)
    b = rng.normal(size=(B, s, 64)).astype(np.float32)
    ja, jh = jax.jit(jgr._rg_lru_scan)(a, b)
    ta, th = tgr._rg_lru_scan(t_(a), t_(b))
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    ja, ta = np.asarray(ja), ta.numpy()
    tiny = np.finfo(np.float32).tiny
    flushed = (ja == 0) & (ta < tiny)
    assert (ta[ja == 0] < tiny).all()
    np.testing.assert_array_equal(np.where(flushed, 0, ta), ja)


def test_rec_apply_prompt_and_steps(fam):
    """The recurrent block over 40 tokens, then 6 decode steps from a
    zero state (the conv window fills, the state carries) against JAX."""
    jcfg, tcfg = fam["jcfg"], fam["tcfg"]
    x = np.random.default_rng(3).normal(size=(B, S, tcfg.d_model)) \
        .astype(np.float32)
    p_j = jax.tree.map(lambda a: a[0], fam["jparams"]["blocks"]["g_rec0"])
    p_t = jax.tree.map(lambda a: a[0], fam["tparams"]["blocks"]["g_rec0"])
    y_j, (h_j, conv_j) = jax.jit(lambda p, xx: jgr.rec_apply(
        jcfg, p, xx))(p_j["rec"], x)
    y, (h, conv) = tgr.rec_apply(tcfg, p_t["rec"], t_(x))
    close(y, y_j, "rec_apply output")
    close(h, h_j, "carried h")
    close(conv, conv_j, "conv tail")
    c0 = tdec.init_cache(tcfg, B, S, device="cpu")["g_rec0"]
    cache = {k: v[0] for k, v in c0.items()}
    assert cache["h"].dtype == torch.float32
    jcache = {k: jnp.asarray(v.numpy()) for k, v in cache.items()}
    jstep = jax.jit(lambda p, xx, c: jgr.rec_apply(jcfg, p, xx, c))
    for i in range(6):
        yi, (hi, ci) = tgr.rec_apply(tcfg, p_t["rec"], t_(x[:, i:i + 1]),
                                     cache)
        yi_j, (hj, cj) = jstep(p_j["rec"], x[:, i:i + 1], jcache)
        close(yi, yi_j, f"decode step {i}")
        close(hi, hj, f"h after step {i}")
        close(yi, y[:, i:i + 1].detach(), f"step {i} vs the scan")
        cache, jcache = {"h": hi, "conv": ci}, {"h": hj, "conv": cj}


def test_forward(fam):
    check_forward(fam)


def test_prefill_and_three_decode_steps(fam):
    check_prefill_and_decode(fam)


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_loss_and_gradients(fam, remat):
    check_loss_and_gradients(fam, remat)


def test_adamw_train_step(fam):
    check_adamw_step(fam)


def test_init_cache_and_abstract_state_match_jax():
    jcfg, tcfg = configs()
    jc = jdec.init_cache(jcfg, B, S)
    tc = tdec.init_cache(tcfg, B, S, device="cpu")
    assert shapes_of(jc) == shapes_of(tc)
    assert tc["g_attn"]["k"].shape[2] == tcfg.sliding_window
    assert sorted(tc) == ["g_attn", "g_rec0", "g_rec1", "tail0", "tail1"]
    assert_tree_close(tc, jc, "init_cache")
    tp = check_abstract_state(jget_config(ARCH), get_config(ARCH))
    assert sorted(tp["blocks"]) == ["g_attn", "g_rec0", "g_rec1", "tail0",
                                    "tail1"]
    n = sum(x.numel() for x in jax.tree.leaves(
        tp, is_leaf=lambda x: isinstance(x, torch.Tensor)))
    assert n == 8_524_206_080          # 12 groups + 2 tail layers, tied
