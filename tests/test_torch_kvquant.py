"""The port's int8 KV-cache quantization against the JAX package's, on
the CPU: the three cases of ``tests/test_kvquant.py``, with the int8
values, the scales and the dequantized cache equal to JAX's bit for bit
(``torch.round`` and ``jnp.round`` both round half to even)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import kvquant as jkv
from repro.models.transformer import flash_attention as jflash_attention
from repro_torch.models import kvquant as tkv
from repro_torch.models.transformer import flash_attention


def t_(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_roundtrip_error_bound(rng, dtype):
    x = rng.normal(size=(4, 128, 8, 64)).astype(np.float32)
    x[0, 0, 0] = 0.0                        # an all-zero row: scale 1e-12
    x[0, 1, 0, :3] = [2.5, -2.5, 0.5]       # halves to round to even
    jx = jnp.asarray(x).astype(dtype)
    tx = t_(x).to(getattr(torch, dtype))
    jq, js = jkv.quantize_kv(jx)
    q, s = tkv.quantize_kv(tx)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    for out in ("float32", "bfloat16"):
        back = tkv.dequantize_kv(q, s, getattr(torch, out))
        jback = jkv.dequantize_kv(jq, js, getattr(jnp, out))
        np.testing.assert_array_equal(back.float().numpy(),
                                      np.asarray(jback, np.float32))
    # per-row max error <= scale/2
    back = tkv.dequantize_kv(q, s, torch.float32)
    err = (back - tx.float()).abs()
    assert bool((err <= s * 0.51).all())


def test_attention_with_quantized_cache_close(rng):
    B, S, H, KV, D = 2, 256, 8, 4, 64
    q, k, v = (t_(rng.normal(size=(B, S, h, D)).astype(np.float32))
               for h in (H, KV, KV))
    ref = flash_attention(q, k, v, causal=True)
    kq, ks = tkv.quantize_kv(k)
    vq, vs = tkv.quantize_kv(v)
    kd = tkv.dequantize_kv(kq, ks, torch.float32)
    vd = tkv.dequantize_kv(vq, vs, torch.float32)
    jk, jks = jkv.quantize_kv(jnp.asarray(k.numpy()))
    np.testing.assert_array_equal(
        kd.numpy(), np.asarray(jkv.dequantize_kv(jk, jks, jnp.float32)))
    got = flash_attention(q, kd, vd, causal=True)
    want = jflash_attention(*(jnp.asarray(a.numpy()) for a in (q, kd, vd)),
                            causal=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=0)
    rel = (got - ref).abs() / (ref.abs() + 1e-3)
    assert float(rel.median()) < 1e-2
    assert float((got - ref).abs().max()) < 0.2


@pytest.mark.parametrize("shape", [(60, 8, 32768, 8, 128), (2, 3, 16),
                                   (12, 8, 2048, 1, 256)])
def test_cache_bytes(shape):
    for quantized in (False, True):
        assert tkv.cache_bytes(shape, quantized) == \
            jkv.cache_bytes(shape, quantized)
    if shape[-1] >= 64:
        assert tkv.cache_bytes(shape, True) / \
            tkv.cache_bytes(shape, False) < 0.52
    # the tensors' own bytes, at the shape's last two dims
    part = (2,) + shape[-2:]
    q, s = tkv.quantize_kv(torch.zeros(part, dtype=torch.bfloat16))
    assert q.nbytes + s.nbytes == tkv.cache_bytes(part, True)
    assert torch.zeros(part, dtype=torch.bfloat16).nbytes == \
        tkv.cache_bytes(part, False)
