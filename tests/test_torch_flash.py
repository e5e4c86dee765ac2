"""The port's flash attention against the JAX package's, on the CPU.

On CPU tensors ``flash_attention_fwd`` runs its plain version (the
chunked online softmax over the kernel's key tiles of 64).  It must
match the JAX Pallas kernel in interpret mode and the JAX model function
``transformer.flash_attention`` over the matrix of
``tests/test_flash_kernel.py``, within that file's bars: atol 2e-3 in
float32, 3e-2 in bfloat16 (the two packages round bfloat16 at the same
places but sum in other orders).  Ragged lengths, which the Pallas
kernel refuses, are held to the JAX model function and to a naive
softmax.  The CUDA kernel runs only on a card: the ``gpu``-marked test
holds it to its plain version there and needs neither JAX nor the JAX
package (``python -m pytest -m gpu``), so JAX comes in through a fixture.
"""
import types

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels.ref import flash_attention_ref
from repro_torch.models.transformer import flash_attention

ATOL = {np.float32: 2e-3, "bfloat16": 3e-2}
TORCH_DT = {np.float32: torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture(scope="module")
def jx():
    """The JAX side: jnp, bfloat16, the Pallas kernel, the model function
    and the traffic model."""
    import jax.numpy as jnp
    import ml_dtypes
    from repro.kernels.flash_attention import flash_attention_fwd
    from repro.kernels.flash_attention import flash_hbm_bytes
    from repro.models.transformer import flash_attention as model
    return types.SimpleNamespace(jnp=jnp, bf16=ml_dtypes.bfloat16,
                                 pallas=flash_attention_fwd, model=model,
                                 hbm_bytes=flash_hbm_bytes)


MATRIX = [(2, 128, 4, 2, 32, True, None),
          (1, 256, 4, 4, 64, True, None),
          (2, 128, 8, 1, 32, True, 64),      # MQA + sliding window
          (1, 64, 2, 2, 16, False, None),
          (1, 128, 4, 2, 128, True, None)]


def qkv(rng, B, Sq, Sk, H, KV, D, dt):
    """q, k, v as numpy float32 already rounded to ``dt`` (torch's
    round-to-nearest-even, as ml_dtypes and JAX round)."""
    out = []
    for shape in ((B, Sq, H, D), (B, Sk, KV, D), (B, Sk, KV, D)):
        a = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
        out.append(a.to(TORCH_DT[dt]).float().numpy())
    return out


def to_jax(jx, a, dt):
    return jx.jnp.asarray(a).astype(jx.bf16 if dt == "bfloat16" else dt)


def to_torch(a, dt):
    return torch.from_numpy(a).to(TORCH_DT[dt])


def f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x).astype(np.float32)


@pytest.mark.parametrize("dt", [np.float32, "bfloat16"])
@pytest.mark.parametrize("B,S,H,KV,D,causal,window", MATRIX)
def test_flash_matches_pallas_and_model(jx, rng, B, S, H, KV, D, causal,
                                        window, dt):
    q, k, v = qkv(rng, B, S, S, H, KV, D, dt)
    jq, jk, jv = (to_jax(jx, a, dt) for a in (q, k, v))
    tq, tk, tv = (to_torch(a, dt) for a in (q, k, v))
    got = FA.flash_attention_fwd(tq, tk, tv, causal=causal, window=window)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    pallas = jx.pallas(jq, jk, jv, causal=causal, window=window,
                       tq=64, tk=64, interpret=True)
    model = jx.model(jq, jk, jv, causal=causal, window=window)
    for want in (pallas, model):
        np.testing.assert_allclose(f32(got), f32(want), atol=ATOL[dt],
                                   rtol=ATOL[dt])
    # the port's own model function is the same code at its chunk of 1024
    np.testing.assert_allclose(
        f32(flash_attention(tq, tk, tv, causal=causal, window=window)),
        f32(model), atol=ATOL[dt], rtol=ATOL[dt])


@pytest.mark.parametrize("S", [100, 200])
@pytest.mark.parametrize("D", [96, 256])
def test_flash_ragged_lengths(jx, rng, S, D):
    """Lengths that are no multiple of the 64-key tile: the tail is masked,
    as the model function pads and masks it."""
    q, k, v = qkv(rng, 1, S, S, 4, 2, D, np.float32)
    got = FA.flash_attention_fwd(*(to_torch(a, np.float32) for a in (q, k, v)))
    want = jx.model(*(jx.jnp.asarray(a) for a in (q, k, v)), causal=True)
    np.testing.assert_allclose(f32(got), np.asarray(want), atol=2e-3,
                               rtol=2e-3)
    naive = flash_attention_ref(*(torch.from_numpy(a) for a in (q, k, v)))
    np.testing.assert_allclose(f32(got), f32(naive), atol=2e-3, rtol=2e-3)


@pytest.mark.parametrize("dt", [np.float32, "bfloat16"])
def test_flash_softcap(jx, rng, dt):
    q, k, v = qkv(rng, 1, 128, 128, 4, 2, 32, dt)
    q = q * 8.0         # scores large enough for the cap to bite
    got = FA.flash_attention_fwd(*(to_torch(a, dt) for a in (q, k, v)),
                                 softcap=5.0)
    want = jx.model(*(to_jax(jx, a, dt) for a in (q, k, v)), causal=True,
                    softcap=5.0)
    np.testing.assert_allclose(f32(got), f32(want), atol=ATOL[dt],
                               rtol=ATOL[dt])
    uncapped = FA.flash_attention_fwd(*(to_torch(a, dt) for a in (q, k, v)))
    assert np.abs(f32(uncapped) - f32(got)).max() > 10 * ATOL[dt]


@pytest.mark.parametrize("D", [96, 256])
def test_flash_head_dims_against_pallas(jx, rng, D):
    """phi3's head dim (no power of two) and gemma's (256), in both
    dtypes, against the Pallas kernel in interpret mode."""
    for dt in (np.float32, "bfloat16"):
        q, k, v = qkv(rng, 1, 128, 128, 2, 1, D, dt)
        got = FA.flash_attention_fwd(*(to_torch(a, dt) for a in (q, k, v)))
        want = jx.pallas(*(to_jax(jx, a, dt) for a in (q, k, v)), tq=64,
                         tk=64, interpret=True)
        np.testing.assert_allclose(f32(got), f32(want), atol=ATOL[dt],
                                   rtol=ATOL[dt])


@pytest.mark.parametrize("shape", [(1, 1024, 1024, 8, 8, 128, 128),
                                   (8, 2048, 2048, 32, 32, 96, 96),
                                   (1, 1000, 1000, 56, 8, 128, 128)])
def test_flash_hbm_bytes_equal_jax(jx, shape):
    assert FA.flash_hbm_bytes(*shape) == jx.hbm_bytes(*shape)
    assert FA.flash_hbm_bytes(*shape, itemsize=4) == \
        jx.hbm_bytes(*shape, itemsize=4)


def test_flash_wrapper_checks_and_cpu_count(rng):
    q, k, v = (torch.from_numpy(a) for a in
               qkv(rng, 1, 64, 64, 4, 3, 16, np.float32))
    with pytest.raises(ValueError, match="heads"):
        FA.flash_attention_fwd(q, k, v)
    q, k, v = (torch.from_numpy(a) for a in
               qkv(rng, 1, 64, 64, 4, 2, 16, np.float32))
    with pytest.raises(ValueError, match="window"):
        FA.flash_attention_fwd(q, k, v, window=0)
    FA.reset_launch_counts()
    FA.flash_attention_fwd(q, k, v)
    assert FA.LAUNCHES == {"flash_attention_fwd": 0}, \
        "a CPU call ran the plain version and launched nothing"


@pytest.mark.parametrize("case", ["other order", "dropped tail",
                                  "bfloat16 inside"])
def test_card_tolerance_separates_right_from_wrong(rng, case):
    """``CARD_TOL``, the bar the kernel is held to on the card, takes a
    version that only sums the scores in another order (the head dim
    permuted) and refuses one that drops the last partial key tile or
    computes a float32 call in bfloat16."""
    dt = np.float32 if case == "bfloat16 inside" else "bfloat16"
    q, k, v = (to_torch(a, dt) for a in qkv(rng, 2, 1000, 1000, 4, 2, 96,
                                            dt))
    want = FA.flash_attention_fwd_plain(q, k, v)
    if case == "other order":
        perm = torch.from_numpy(rng.permutation(96))
        got = FA.flash_attention_fwd_plain(q[..., perm], k[..., perm], v)
    elif case == "dropped tail":
        got = FA.flash_attention_fwd_plain(q, k[:, :960], v[:, :960])
    else:
        got = FA.flash_attention_fwd_plain(
            *(x.to(torch.bfloat16) for x in (q, k, v))).float()
    _, share = FA.card_error(got, want)
    assert (share <= 1.0) == (case == "other order"), share


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.gpu
def test_flash_kernel_matches_plain_on_card():
    """The CUDA kernel against its plain version on the card, in both
    dtypes, at every head dim, with GQA, a window, a softcap and ragged
    lengths, within ``CARD_TOL`` (one rounding of the output); one launch
    a call; unsupported head dims raise."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the kernel runs only on one")
    g = torch.Generator(device="cuda").manual_seed(0)
    FA.reset_launch_counts()
    cases = [((2, 128, 4, 2, 32), torch.float32, True, None, None),
             ((1, 100, 4, 4, 96), torch.float32, True, None, None),
             ((1, 200, 8, 1, 64), torch.bfloat16, True, 64, None),
             ((1, 130, 4, 2, 128), torch.bfloat16, True, None, 50.0),
             ((1, 300, 2, 2, 256), torch.bfloat16, True, None, None),
             ((2, 64, 2, 2, 16), torch.float32, False, None, None)]
    for (B, S, H, KV, D), dt, causal, window, cap in cases:
        q = torch.randn(B, S, H, D, generator=g, device="cuda").to(dt)
        k = torch.randn(B, S, KV, D, generator=g, device="cuda").to(dt)
        v = torch.randn(B, S, KV, D, generator=g, device="cuda").to(dt)
        got = FA.flash_attention_fwd(q, k, v, causal=causal, window=window,
                                     softcap=cap)
        torch.cuda.synchronize()
        want = FA.flash_attention_fwd_plain(q, k, v, causal=causal,
                                            window=window, softcap=cap)
        e, share = FA.card_error(got, want)
        assert share <= 1.0, (D, dt, e, share, FA.CARD_TOL[dt])
    assert FA.LAUNCHES == {"flash_attention_fwd": len(cases)}
    with pytest.raises(ValueError, match="head dim"):
        FA.flash_attention_fwd(*(torch.zeros(1, 8, 2, 48, device="cuda")
                                 for _ in range(3)))
