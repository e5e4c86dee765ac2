"""The port's ssm family (mamba2) against the JAX package's, on the CPU.

mamba2-2.7b at ``smoke()`` size (2 layers, d 64, 8 heads of 16, state
16, chunk 8, conv 4) in float32: both packages get one set of weights
(the JAX ``init_params`` carried by ``params_from_numpy``) and the same
inputs, made with numpy from a seed; the JAX side is computed once for
the module, under ``jax.jit``.  Within ``ATOL = 2e-5`` (the elementwise
functions of the two libraries differ in the last bits, so the models are
held to a tolerance, not to bit-identity):

* ``ssd_chunked`` over two chunks: the output and the final state; a
  chunk whose decays overflow ``exp`` in the masked half, where the
  port's gradient stays finite and the reference's is NaN;
* ``block_apply`` at S = 13, which the block pads to two chunks of 8
  with dt = 0: the output, the carried state and conv tail; the decode
  branch from a zero state, token by token, reaches the same outputs and
  the same state as the chunked form;
* ``forward`` (and ``DenseLM``), ``prefill`` with every cache leaf (the
  float32 ``ssm`` state and the ``conv`` tail), three decode steps;
* ``loss_fn`` with every gradient leaf within ``GRAD_RTOL = 1e-5`` of the
  leaf's largest, with and without remat; one AdamW step;
* ``init_cache`` and the full config's abstract train state against the
  JAX trees.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import smoke as jsmoke
from repro.models import decode as jdec
from repro.models import ssm as jssm
from repro_torch.configs import get_config, smoke
from repro_torch.models import decode as tdec
from repro_torch.models import ssm as tssm
from torch_lm_parity import (assert_tree_close, check_abstract_state,
                             check_adamw_step, check_forward,
                             check_loss_and_gradients,
                             check_prefill_and_decode, close,
                             family_results, shapes_of, t_)

ARCH = "mamba2-2.7b"
B, S, EXTRA = 2, 21, 4           # 21 tokens: two chunks of 8 and a pad


@pytest.fixture(scope="module")
def fam():
    return family_results(jsmoke(jget_config(ARCH)), smoke(get_config(ARCH)),
                          B, S, EXTRA)


def layer0(params):
    return jax.tree.map(lambda a: a[0], params["blocks"])


def test_ssd_chunked_two_chunks():
    cfg = smoke(get_config(ARCH))
    din, nh, _ = tssm._dims(cfg)
    chunk, n, hp = cfg.ssm_chunk, cfg.ssm_state, cfg.ssm_headdim
    rng = np.random.default_rng(1)
    s = 2 * chunk
    xh = rng.normal(size=(B, s, nh, hp)).astype(np.float32)
    dt = rng.uniform(0.01, 0.5, (B, s, nh)).astype(np.float32)
    A = -rng.uniform(0.5, 2.0, nh).astype(np.float32)
    Bm = rng.normal(size=(B, s, n)).astype(np.float32)
    Cm = rng.normal(size=(B, s, n)).astype(np.float32)
    y_j, st_j = jax.jit(lambda *a: jssm.ssd_chunked(*a, chunk))(
        xh, dt, A, Bm, Cm)
    y, st = tssm.ssd_chunked(*map(t_, (xh, dt, A, Bm, Cm)), chunk)
    close(y, y_j, "ssd_chunked output")
    close(st, st_j, "ssd_chunked final state")


def test_ssd_gradient_finite_where_decays_overflow():
    """A chunk whose decays sum past 88: exp of the masked segment sums
    overflows, and the reference's gradient with respect to dt is NaN (0 *
    inf through its ``where``; ROADMAP §C).  The port's output equals
    JAX's, its gradient with respect to x too, and its gradient with
    respect to dt is finite."""
    rng = np.random.default_rng(4)
    s, nh, hp, n = 16, 2, 4, 4
    xh = rng.normal(size=(1, s, nh, hp)).astype(np.float32)
    dt = np.full((1, s, nh), 8.0, np.float32)
    A = -np.ones(nh, np.float32)
    Bm = rng.normal(size=(1, s, n)).astype(np.float32)
    Cm = rng.normal(size=(1, s, n)).astype(np.float32)

    def jsum(x, d):
        return jssm.ssd_chunked(x, d, A, Bm, Cm, s)[0].sum()

    jgx, jgdt = jax.jit(jax.grad(jsum, argnums=(0, 1)))(xh, dt)
    assert not np.isfinite(np.asarray(jgdt)).all()
    x_t, dt_t = t_(xh).requires_grad_(), t_(dt).requires_grad_()
    y, _ = tssm.ssd_chunked(x_t, dt_t, t_(A), t_(Bm), t_(Cm), s)
    gx, gdt = torch.autograd.grad(y.sum(), (x_t, dt_t))
    close(y, jssm.ssd_chunked(xh, dt, A, Bm, Cm, s)[0], "output")
    close(gx, jgx, "gradient with respect to x")
    assert torch.isfinite(gdt).all()


def test_block_padding_and_decode_recurrence(fam):
    """``block_apply`` at 13 tokens (padded to 16 with dt = 0) against
    JAX; then 13 decode steps from a zero state against the chunked form
    (outputs and the final state) and against JAX's decode steps."""
    jcfg, tcfg = fam["jcfg"], fam["tcfg"]
    s = 13
    assert s % tcfg.ssm_chunk
    x = np.random.default_rng(2).normal(size=(B, s, tcfg.d_model)) \
        .astype(np.float32)
    p_j, p_t = layer0(fam["jparams"]), layer0(fam["tparams"])
    y_j, (st_j, conv_j) = jax.jit(lambda p, xx: jssm.block_apply(
        jcfg, p, xx))(p_j, x)
    y, (st, conv) = tssm.block_apply(tcfg, p_t, t_(x))
    close(y, y_j, "block output")
    close(st, st_j, "carried state")
    close(conv, conv_j, "conv tail")

    c0 = tdec.init_cache(tcfg, B, s, device="cpu")
    cache = {"ssm": c0["ssm"][0], "conv": c0["conv"][0]}
    jcache = {"ssm": jnp.asarray(cache["ssm"].numpy()),
              "conv": jnp.asarray(cache["conv"].numpy()), "idx": 0}
    jstep = jax.jit(lambda p, xx, c: jssm.block_apply(jcfg, p, xx, c))
    for i in range(s):
        yi, (st_i, conv_i) = tssm.block_apply(tcfg, p_t, t_(x[:, i:i + 1]),
                                              cache)
        yi_j, (jst, jconv) = jstep(p_j, x[:, i:i + 1], jcache)
        close(yi, yi_j, f"decode step {i}")
        close(yi, y[:, i:i + 1].detach(), f"decode step {i} vs chunked",
              atol=1e-4)
        cache = {"ssm": st_i, "conv": conv_i}
        jcache = {"ssm": jst, "conv": jconv, "idx": i + 1}
    close(cache["ssm"], st_j, "decoded state vs chunked", atol=1e-4)
    close(cache["conv"], conv_j, "decoded conv tail vs chunked")
    close(cache["ssm"], jcache["ssm"], "decoded state")


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
    jcfg, tcfg = jsmoke(jget_config(ARCH)), smoke(get_config(ARCH))
    jc = jdec.init_cache(jcfg, B, S)
    tc = tdec.init_cache(tcfg, B, S, device="cpu")
    assert shapes_of(jc) == shapes_of(tc)
    assert tc["ssm"].dtype == torch.float32
    assert_tree_close(tc, jc, "init_cache")
    tp = check_abstract_state(jget_config(ARCH), get_config(ARCH))
    n = sum(x.numel() for x in jax.tree.leaves(
        tp, is_leaf=lambda x: isinstance(x, torch.Tensor)))
    assert n == 2_702_968_320          # vocab padded to 50432, tied
