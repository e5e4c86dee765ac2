"""The port's batch utilities against ``repro.core.batch``, bit for bit.

The JAX scan is an associative scan; the port's is written in closed form
with running maxima of lane indices.  All six outputs must agree,
including the lanes of segments that hold no write.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import batch as jb
from repro_torch.core import batch as tb
from torch_parity import t


def _scan_inputs(rng, B, n_distinct, write_p):
    keys = np.sort(rng.integers(0, n_distinct, B)).astype(np.int32)
    newseg = np.concatenate([[True], keys[1:] != keys[:-1]])
    is_write = rng.random(B) < write_p
    val = rng.integers(-1000, 1000, B).astype(np.int32)
    tomb = rng.random(B) < 0.3
    return newseg, is_write, val, tomb


@pytest.mark.parametrize("B,n_distinct,write_p", [
    (1, 1, 0.5), (7, 3, 0.5), (64, 8, 0.2), (64, 64, 0.9),
    (512, 40, 0.5), (512, 500, 0.05), (333, 5, 0.0), (256, 16, 1.0)])
def test_seg_last_write_scan_matches_jax(rng, B, n_distinct, write_p):
    newseg, is_write, val, tomb = _scan_inputs(rng, B, n_distinct, write_p)
    want = jb.seg_last_write_scan(*map(jnp.asarray,
                                       (newseg, is_write, val, tomb)))
    got = tb.seg_last_write_scan(*map(t, (newseg, is_write, val, tomb)))
    for w3, g3 in zip(want, got):
        for w, g in zip(w3, g3):
            w = np.asarray(w)
            assert g.numpy().dtype == w.dtype
            np.testing.assert_array_equal(g.numpy(), w)


def test_seg_scan_lanes_without_writes(rng):
    """A segment with no write: has=False, and val/tomb come from the
    segment's first lane, as the JAX combine leaves them."""
    newseg = np.array([1, 0, 0, 1, 0, 1], bool)
    is_write = np.array([0, 0, 0, 0, 1, 0], bool)
    val = np.array([10, 11, 12, 13, 14, 15], np.int32)
    tomb = np.array([1, 0, 0, 0, 1, 0], bool)
    (h, v, tm), (eh, ev, et) = tb.seg_last_write_scan(
        *map(t, (newseg, is_write, val, tomb)))
    np.testing.assert_array_equal(h.numpy(), [0, 0, 0, 0, 1, 0])
    np.testing.assert_array_equal(v.numpy(), [10, 10, 10, 13, 14, 15])
    np.testing.assert_array_equal(tm.numpy(), [1, 1, 1, 0, 1, 0])
    np.testing.assert_array_equal(eh.numpy(), [0, 0, 0, 0, 0, 0])
    want = jb.seg_last_write_scan(*map(jnp.asarray,
                                       (newseg, is_write, val, tomb)))
    for w, g in zip(want[0] + want[1], (h, v, tm, eh, ev, et)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("B", [1, 16, 300])
def test_sort_queries_is_stable_and_matches_jax(rng, B):
    ops = rng.integers(0, 3, B).astype(np.int32)
    keys = rng.integers(0, max(2, B // 8), B).astype(np.int32)
    vals = rng.integers(0, 50, B).astype(np.int32)
    want = jb.sort_queries(*map(jnp.asarray, (ops, keys, vals)))
    got = tb.sort_queries(*map(t, (ops, keys, vals)))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    perm = got[0].numpy()
    np.testing.assert_array_equal(perm, np.argsort(keys, kind="stable"))


@pytest.mark.parametrize("B,out_size,p", [
    (0, 4, 0.5), (32, 64, 0.5), (64, 16, 0.5), (50, 50, 1.0), (40, 8, 0.0)])
def test_compact_matches_jax(rng, B, out_size, p):
    mask = rng.random(B) < p
    a = rng.integers(0, 100, B).astype(np.int32)
    b = rng.random(B) < 0.5
    w_count, w_drop, w_outs = jb.compact(
        jnp.asarray(mask), out_size, jnp.asarray(a), jnp.asarray(b),
        fill_values=(-1, False))
    g_count, g_drop, g_outs = tb.compact(t(mask), out_size, t(a), t(b),
                                         fill_values=(-1, False))
    assert int(g_count) == int(w_count)
    assert g_count.dtype == torch.int32
    assert bool(g_drop) == bool(w_drop)
    for w, g in zip(w_outs, g_outs):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
