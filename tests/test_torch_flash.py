"""The port's flash attention against the JAX package's, on the CPU.

On CPU tensors ``flash_attention_fwd`` runs its plain version (the
chunked online softmax over the kernel's key tiles, ``kv_tile``).  It must
match the JAX Pallas kernel in interpret mode and the JAX model function
``transformer.flash_attention`` over the matrix of
``tests/test_flash_kernel.py``, within that file's bars: atol 2e-3 in
float32, 3e-2 in bfloat16 (the two packages round bfloat16 at the same
places but sum in other orders).  Ragged lengths, which the Pallas
kernel refuses, are held to the JAX model function and to a naive
softmax.  ``FlashAttention``'s gradient is autograd through the plain
version at the model's chunk of 1024, bit for bit, and within
``GRAD_ATOL`` of the JAX model function's ``jax.vjp``: 2e-5 in float32,
8e-3 in bfloat16 (measured: 1.7e-6 and 9.8e-4, one bfloat16 step of a
gradient near 0.25).  The CUDA kernel runs only on a card: the ``gpu``-marked test
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
GRAD_ATOL = {np.float32: 2e-5, "bfloat16": 8e-3}
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
def test_card_tolerance_separates_right_from_wrong(rng, monkeypatch, case):
    """``CARD_TOL``, the bar the kernel is held to on the card, takes a
    version that sums the scores in float32 in another order (the head dim
    permuted; the plain version rounds exact sums) and refuses one that
    drops the last partial key tile (keys 896..999 at the bfloat16 tile of
    128) or computes a float32 call in bfloat16."""
    dt = np.float32 if case == "bfloat16 inside" else "bfloat16"
    q, k, v = (to_torch(a, dt) for a in qkv(rng, 2, 1000, 1000, 4, 2, 96,
                                            dt))
    want = FA.flash_attention_fwd_plain(q, k, v)
    if case == "other order":   # float32 score sums, head dim permuted
        einsum = torch.einsum

        def float32_scores(eq, a, b):
            if eq == "bqhd,bkhd->bhqk":
                return einsum(eq, a.float(), b.float()).double()
            return einsum(eq, a, b)
        monkeypatch.setattr(torch, "einsum", float32_scores)
        perm = torch.from_numpy(rng.permutation(96))
        got = FA.flash_attention_fwd_plain(q[..., perm], k[..., perm], v)
    elif case == "dropped tail":     # the last, partial key tile
        keep = 999 // FA.kv_tile(96, q.dtype) * FA.kv_tile(96, q.dtype)
        got = FA.flash_attention_fwd_plain(q, k[:, :keep], v[:, :keep])
    else:
        got = FA.flash_attention_fwd_plain(
            *(x.to(torch.bfloat16) for x in (q, k, v))).float()
    _, share = FA.card_error(got, want)
    assert (share <= 1.0) == (case == "other order"), share


@pytest.mark.parametrize("D", list(FA.HEAD_DIMS))
@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32])
def test_kv_tile_by_dtype_and_head_dim(D, dt):
    """The key tile of each kernel: the tensor-core kernel (bfloat16) takes
    128 keys up to D = 96 and 64 above, the scalar one (float32) 64 and 32
    at D = 256."""
    want = {torch.bfloat16: 128 if D <= 96 else 64,
            torch.float32: 32 if D == 256 else 64}[dt]
    assert FA.kv_tile(D, dt) == want


@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32])
def test_plain_default_chunk_is_the_kernel_tile(rng, dt):
    """The plain version walks the kernel's own key tiles by default: at
    phi3's head dim the bfloat16 default is the 128-key tile, not 64."""
    npdt = "bfloat16" if dt == torch.bfloat16 else np.float32
    q, k, v = (to_torch(a, npdt) for a in qkv(rng, 1, 300, 300, 4, 2, 96,
                                              npdt))
    got = FA.flash_attention_fwd_plain(q, k, v, window=100)
    tile = FA.kv_tile(96, dt)
    assert torch.equal(got, FA.flash_attention_fwd_plain(
        q, k, v, window=100, kv_chunk=tile))
    other = 64 if tile == 128 else 128
    assert not torch.equal(got, FA.flash_attention_fwd_plain(
        q, k, v, window=100, kv_chunk=other))


@pytest.mark.parametrize("D", [96, 128])
def test_plain_at_bf16_tile_matches_pallas(jx, rng, D):
    """At the tensor-core kernel's tiles (128 keys at D = 96, 64 at
    D = 128) the plain version still agrees with the Pallas kernel in
    interpret mode within the bfloat16 bar, over several tiles and GQA."""
    q, k, v = qkv(rng, 1, 256, 256, 4, 2, D, "bfloat16")
    got = FA.flash_attention_fwd_plain(*(to_torch(a, "bfloat16")
                                         for a in (q, k, v)))
    want = jx.pallas(*(to_jax(jx, a, "bfloat16") for a in (q, k, v)),
                     tq=64, tk=64, interpret=True)
    np.testing.assert_allclose(f32(got), f32(want), atol=ATOL["bfloat16"],
                               rtol=ATOL["bfloat16"])


def test_unaligned_tensor_is_copied():
    """TMA reads only 16-byte aligned bases: the wrapper hands the kernel
    a fresh copy of a view that starts mid-row, and an aligned tensor as
    it is."""
    buf = torch.arange(1 + 2 * 8 * 2 * 16, dtype=torch.float32) \
        .to(torch.bfloat16)
    view = buf[1:].view(2, 8, 2, 16)
    assert view.data_ptr() % 16
    copy = FA._aligned(view)
    assert copy.data_ptr() % 16 == 0 and torch.equal(copy, view)
    aligned = torch.zeros(2, 8, 2, 16, dtype=torch.bfloat16)
    assert FA._aligned(aligned) is aligned


# ---------------------------------------------------------------------------
# the gradient: FlashAttention
# ---------------------------------------------------------------------------

GRAD_CASES = [(1, 1100, 2, 1, 16, True, None, None),   # two 1024-key chunks
              (2, 96, 4, 2, 32, True, 40, None),
              (1, 64, 2, 2, 16, False, None, 30.0)]


def plain_grads(q, k, v, g, **opts):
    q, k, v = (x.detach().requires_grad_() for x in (q, k, v))
    out = FA.flash_attention_fwd_plain(q, k, v, kv_chunk=1024, **opts)
    return out, torch.autograd.grad(out, (q, k, v), g)


@pytest.mark.parametrize("dt", [np.float32, "bfloat16"])
@pytest.mark.parametrize("B,S,H,KV,D,causal,window,cap", GRAD_CASES)
def test_flash_function_gradient(jx, rng, dt, B, S, H, KV, D, causal,
                                 window, cap):
    """``FlashAttention``: its forward is ``flash_attention_fwd`` (no
    launch counted on the CPU), its gradient is autograd through the
    plain version at the model's chunk of 1024, bit for bit, and within
    ``GRAD_ATOL`` of the JAX model function's ``jax.vjp``."""
    import jax
    q, k, v = (torch.from_numpy(a).to(TORCH_DT[dt])
               for a in qkv(rng, B, S, S, H, KV, D, dt))
    g = torch.from_numpy(rng.normal(size=(B, S, H, D)).astype(np.float32)) \
        .to(TORCH_DT[dt])
    opts = dict(causal=causal, window=window, softcap=cap)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    FA.reset_launch_counts()
    out = FA.FlashAttention.apply(*leaves, causal, window, cap)
    assert torch.equal(out, FA.flash_attention_fwd(q, k, v, **opts))
    assert FA.LAUNCHES["flash_attention_fwd"] == 0
    got = torch.autograd.grad(out, leaves, g)
    _, want = plain_grads(q, k, v, g, **opts)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)
    jq, jk, jv, jg = (to_jax(jx, x.float().numpy(), dt) for x in (q, k, v, g))
    _, vjp = jax.vjp(lambda a, b, c: jx.model(a, b, c, causal=causal,
                                              window=window, softcap=cap),
                     jq, jk, jv)
    for name, a, b in zip("qkv", got, vjp(jg)):
        np.testing.assert_allclose(a.float().numpy(),
                                   np.asarray(b, np.float32), rtol=0,
                                   atol=GRAD_ATOL[dt], err_msg=f"d{name}")


def test_flash_function_without_grad_is_the_forward(rng):
    q, k, v = (torch.from_numpy(a) for a in qkv(rng, 1, 40, 40, 2, 2, 16,
                                                np.float32))
    with torch.no_grad():
        out = FA.FlashAttention.apply(q, k, v, True, None, None)
    assert not out.requires_grad
    assert torch.equal(out, FA.flash_attention_fwd(q, k, v))


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.gpu
def test_flash_kernel_matches_plain_on_card():
    """The CUDA kernels against their plain version on the card within
    ``CARD_TOL``: bfloat16 (the tensor-core kernel) at every head dim,
    lengths below one key tile (1, 17) and ragged above it, a window
    crossing tile boundaries, a softcap, GQA with 7 query heads a KV head
    (56 over 8), MQA, no causal mask, and q, k, v views whose base is not
    16-byte aligned, granite-moe's prefill (8 x 2048, 24 heads over 8 of
    64), recurrentgemma's (8 x 2048 and 2 x 4096, 16 heads over one of 256,
    a window of 2048) and 16 heads of 256 at 8 x 2048 (many short causal
    rows, where one probability rounded the other way would show);
    float32 (the FFMA kernel) at every head dim and on every path it
    has: GQA (7 query heads a KV head; granite's 3 at (2, 512, 24, 8,
    64)), MQA with a window,
    a softcap, S = 1000 at D = 16 and 256, S = 1 and 17, no causal mask
    and unaligned views.  One launch a call; unsupported head dims raise."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the kernel runs only on one")
    g = torch.Generator(device="cuda").manual_seed(0)
    FA.reset_launch_counts()
    bf = torch.bfloat16
    f32 = torch.float32
    cases = [((2, 128, 4, 2, 32), f32, True, None, None),
             ((1, 100, 4, 4, 96), f32, True, None, None),
             ((2, 64, 2, 2, 16), f32, False, None, None),
             ((1, 300, 4, 4, 64), f32, True, None, None),
             ((1, 200, 4, 2, 128), f32, True, None, None),
             ((1, 1000, 56, 8, 128), f32, True, None, None),
             ((2, 700, 16, 1, 96), f32, True, 64, None),
             ((1, 260, 8, 8, 96), f32, True, None, 50.0),
             ((1, 1000, 4, 4, 16), f32, True, None, None),
             ((1, 1000, 4, 4, 256), f32, True, None, None),
             ((1, 260, 4, 1, 256), f32, True, 100, 30.0),
             ((2, 17, 8, 8, 96), f32, True, None, None),
             ((4, 1, 8, 8, 96), f32, True, None, None),
             ((1, 333, 8, 8, 96), f32, False, None, None),
             ((2, 300, 4, 2, 16), bf, True, None, None),
             ((1, 257, 4, 4, 32), bf, True, None, None),
             ((1, 200, 8, 1, 64), bf, True, 64, None),
             ((2, 384, 8, 8, 96), bf, True, None, None),
             ((1, 130, 4, 2, 128), bf, True, None, 50.0),
             ((1, 300, 2, 2, 256), bf, True, None, None),
             ((1, 1, 4, 4, 64), bf, True, None, None),
             ((2, 17, 4, 2, 96), bf, True, None, None),
             ((1, 1000, 56, 8, 128), bf, True, None, None),
             ((1, 333, 4, 4, 96), bf, False, None, None),
             ((1, 500, 8, 2, 96), bf, True, 200, None),
             ((1, 260, 4, 1, 256), bf, True, 100, 30.0),
             ((8, 2048, 24, 8, 64), bf, True, None, None),
             ((8, 2048, 16, 1, 256), bf, True, 2048, None),
             ((2, 4096, 16, 1, 256), bf, True, 2048, None),
             ((8, 2048, 16, 16, 256), bf, True, None, None),
             ((2, 512, 24, 8, 64), f32, True, None, None)]
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
        assert share <= 1.0, ((B, S, H, KV, D), dt, e, share)
    # views one element into their buffers: 2-byte aligned, copied by
    # the wrapper before TMA reads them
    shape = (2, 150, 4, 64)
    views = [torch.randn(1 + 2 * 150 * 4 * 64, generator=g, device="cuda")
             .to(bf)[1:].view(shape) for _ in range(3)]
    assert all(x.data_ptr() % 16 for x in views)
    got = FA.flash_attention_fwd(*views)
    torch.cuda.synchronize()
    e, share = FA.card_error(got, FA.flash_attention_fwd_plain(*views))
    assert share <= 1.0, ("misaligned", e, share)
    views = [torch.randn(1 + 2 * 150 * 4 * 64, generator=g, device="cuda")
             [1:].view(shape) for _ in range(3)]
    assert all(x.data_ptr() % 16 for x in views)
    got = FA.flash_attention_fwd(*views)
    torch.cuda.synchronize()
    e, share = FA.card_error(got, FA.flash_attention_fwd_plain(*views))
    assert share <= 1.0, ("misaligned float32", e, share)
    assert FA.LAUNCHES == {"flash_attention_fwd": len(cases) + 2}
    with pytest.raises(ValueError, match="head dim"):
        FA.flash_attention_fwd(*(torch.zeros(1, 8, 2, 48, device="cuda")
                                 for _ in range(3)))


@pytest.mark.gpu
def test_flash_function_on_card():
    """``FlashAttention`` on the card: one kernel launch a forward, within
    ``CARD_TOL`` of the plain version, and a gradient equal bit for bit to
    autograd through the plain version at the model's chunk of 1024."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the kernel runs only on one")
    g = torch.Generator(device="cuda").manual_seed(1)
    for dt in (torch.bfloat16, torch.float32):
        q, k, v, go = (torch.randn(2, 1100, 8, 96, generator=g,
                                   device="cuda").to(dt) for _ in range(4))
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        FA.reset_launch_counts()
        out = FA.FlashAttention.apply(*leaves, True, None, None)
        assert FA.LAUNCHES["flash_attention_fwd"] == 1
        got = torch.autograd.grad(out, leaves, go)
        _, share = FA.card_error(out.detach(),
                                 FA.flash_attention_fwd_plain(q, k, v))
        assert share <= 1.0, (dt, share)
        _, want = plain_grads(q, k, v, go, causal=True)
        for a, b in zip(got, want):
            assert torch.equal(a, b), dt
