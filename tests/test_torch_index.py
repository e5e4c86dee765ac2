"""The port's PI shard against ``repro.core.index``, leaf for leaf.

Build, execute (results and all 11 leaves, dead pending lanes included),
``needs_rebuild``, both rebuild tiers, lookup and traverse must be
bit-identical to the JAX package, for each pair of backends: JAX ``xla``
and ``pallas-interpret`` against the port's ``torch`` and ``cuda`` (whose
kernels run their plain versions on a CPU tensor).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import index as jpi
from repro_torch.core import RefIndex
from repro_torch.core import index as tpi
from torch_parity import assert_same_state, configs, ref_results, t

jax_execute = jax.jit(jpi.execute_impl)   # un-donated: keeps the pre-state


def mk_pair(rng, n=150, key_space=10_000, backend="pallas-interpret",
            **geometry):
    geometry = {"capacity": 512, "pending_capacity": 96, "fanout": 4,
                "tile_q": 64, **geometry}
    jcfg, tcfg = configs(backend=backend, **geometry)
    keys = rng.choice(key_space, size=n, replace=False).astype(np.int32)
    vals = np.arange(n, dtype=np.int32)
    jidx = jpi.build(jcfg, jnp.asarray(keys), jnp.asarray(vals))
    tidx = tpi.build(tcfg, keys, vals, device="cpu")
    return jidx, tidx, keys, vals


def run_both(jidx, tidx, ops, keys, vals):
    jidx, (jf, jv) = jax_execute(jidx, jnp.asarray(ops), jnp.asarray(keys),
                                 jnp.asarray(vals))
    tidx, (tf, tv) = tpi.execute(tidx, t(ops), t(keys), t(vals))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert tv.dtype == torch.int32 and tf.dtype == torch.bool
    return jidx, tidx, (tf.numpy(), tv.numpy())


# ---------------------------------------------------------------------------
# geometry and build
# ---------------------------------------------------------------------------

GEOMETRIES = [(1 << 16, 4, 0), (1024, 4, 0), (256, 4, 0), (512, 8, 0),
              (300, 2, 0), (326, 16, 0), (2, 4, 0), (1024, 4, 64),
              (1024, 4, 1024), (4096, 8, 512)]


@pytest.mark.parametrize("cap,fanout,seg_width", GEOMETRIES)
def test_geometry_matches_jax(cap, fanout, seg_width):
    jcfg, tcfg = configs(capacity=cap, pending_capacity=32, fanout=fanout,
                         seg_width=seg_width)
    for name in ("num_levels", "seg_width_eff", "num_segments",
                 "max_dirty"):
        assert getattr(tcfg, name) == getattr(jcfg, name), name
    for lvl in range(jcfg.num_levels + 2):
        assert tcfg.level_size(lvl) == jcfg.level_size(lvl)


def test_explicit_seg_width_validated():
    _, tcfg = configs(capacity=1024, pending_capacity=32, fanout=4,
                      seg_width=64)
    with pytest.raises(ValueError, match="divide"):
        dataclasses.replace(tcfg, seg_width=48)
    with pytest.raises(ValueError, match="power of fanout"):
        dataclasses.replace(tcfg, seg_width=128)
    with pytest.raises(ValueError, match="backend"):
        dataclasses.replace(tcfg, backend="xla")


@pytest.mark.parametrize("cap,fanout,seg_width,n", [
    (1024, 4, 0, 400), (1000, 8, 0, 300), (4096, 16, 0, 2000),
    (300, 2, 0, 100), (326, 16, 0, 326), (1024, 4, 64, 500),
    (1024, 4, 1024, 500), (256, 4, 0, 0), (64, 4, 16, 1)])
def test_build_matches_jax(rng, cap, fanout, seg_width, n):
    jidx, tidx, _, _ = mk_pair(rng, n=n, key_space=100_000, capacity=cap,
                               fanout=fanout, seg_width=seg_width,
                               pending_capacity=64)
    assert_same_state(jidx, tidx, "build")
    assert tpi.validate_layout(tidx)


def test_empty_matches_jax():
    jcfg, tcfg = configs(capacity=256, pending_capacity=32, fanout=4)
    assert_same_state(jpi.empty(jcfg), tpi.empty(tcfg, device="cpu"))


# ---------------------------------------------------------------------------
# execute
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("jax_backend,port_backend", [
    ("xla", "torch"), ("xla", "cuda"), ("pallas-interpret", "torch"),
    ("pallas-interpret", "cuda")])
def test_execute_batches_match_jax(rng, jax_backend, port_backend):
    jidx, tidx, keys, _ = mk_pair(rng, backend=jax_backend)
    tidx = tpi.with_backend(tidx, port_backend)
    ref = RefIndex.build(keys, np.arange(len(keys)))
    fresh = np.empty(0, np.int32)
    for step in range(5):
        B = 64
        ops = rng.integers(0, 3, B).astype(np.int32)
        ks = np.concatenate([rng.choice(keys, B // 2),
                             rng.integers(0, 10_000, B - B // 2)])
        ks = ks.astype(np.int32)
        vs = rng.integers(0, 1000, B).astype(np.int32)
        # delete keys that earlier batches put into the pending buffer
        gone = fresh[:8]
        ops[:gone.size], ks[:gone.size] = 2, gone
        fresh = np.setdiff1d(ks[ops == 1], keys)
        jidx, tidx, (f, v) = run_both(jidx, tidx, ops, ks, vs)
        assert_same_state(jidx, tidx, f"batch {step}")
        assert int(tidx.live_count) == int(jidx.live_count)
        rf, rv = ref_results(ref, ops, ks, vs)
        np.testing.assert_array_equal(f, rf)
        np.testing.assert_array_equal(v, rv)
    # dead pending lanes (deleted pending keys) were exercised
    assert bool(tidx.ptomb.any())


def test_intra_batch_visibility_and_reinsert(rng):
    """Each query sees earlier writes to its key in the same batch;
    delete then reinsert, in one batch and across batches."""
    jidx, tidx, keys, _ = mk_pair(rng)
    k0, k1 = int(keys[0]), 99_999
    S, I, D = 0, 1, 2
    batches = [
        ([S, I, S, D, S, I, S], [k1, k1, k1, k1, k1, k1, k1],
         [0, 5, 0, 0, 0, 6, 0]),
        ([D, S, I, S, D], [k0, k0, k0, k0, k1], [0, 0, 7, 0, 0]),
        ([S, S, I, I, S], [k1, k0, k1, k0, k1], [0, 0, 8, 9, 0]),
    ]
    ref = RefIndex.build(keys, np.arange(len(keys)))
    for ops, ks, vs in batches:
        ops, ks, vs = (np.array(a, np.int32) for a in (ops, ks, vs))
        jidx, tidx, (f, v) = run_both(jidx, tidx, ops, ks, vs)
        rf, rv = ref_results(ref, ops, ks, vs)
        np.testing.assert_array_equal(f, rf)
        np.testing.assert_array_equal(v, rv)
        assert_same_state(jidx, tidx)


@pytest.mark.parametrize("backend", ["xla", "pallas-interpret"])
def test_execute_on_empty_index(rng, backend):
    jcfg, tcfg = configs(backend=backend, capacity=256, pending_capacity=64,
                         fanout=4, tile_q=64)
    jidx, tidx = jpi.empty(jcfg), tpi.empty(tcfg, device="cpu")
    ops = rng.integers(0, 3, 40).astype(np.int32)
    ks = rng.integers(0, 50, 40).astype(np.int32)
    vs = rng.integers(0, 9, 40).astype(np.int32)
    for _ in range(2):
        jidx, tidx, _ = run_both(jidx, tidx, ops, ks, vs)
        assert_same_state(jidx, tidx)


def test_execute_leaves_its_input_untouched(rng):
    _, tidx, keys, _ = mk_pair(rng)
    before = tpi.to_numpy_leaves(tidx)
    ops = np.array([1, 2, 1, 0], np.int32)
    ks = np.array([keys[0], keys[1], 77_777, keys[2]], np.int32)
    tpi.execute(tidx, t(ops), t(ks), t(np.arange(4, dtype=np.int32)))
    for a, b in zip(before, tpi.to_numpy_leaves(tidx)):
        for x, y in zip(a if isinstance(a, tuple) else (a,),
                        b if isinstance(b, tuple) else (b,)):
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("backend", ["xla", "pallas-interpret"])
def test_lookup_and_traverse_match_jax(rng, backend):
    jidx, tidx, keys, _ = mk_pair(rng, backend=backend)
    newk = np.setdiff1d(rng.integers(0, 10_000, 30), keys).astype(np.int32)
    jidx, tidx, _ = run_both(jidx, tidx, np.ones(newk.size, np.int32), newk,
                             newk)
    q = np.concatenate([keys[:20], keys[:5], newk[:10],
                        np.array([-1, np.iinfo(np.int32).min,
                                  np.iinfo(np.int32).max], np.int32),
                        rng.integers(0, 10_000, 40).astype(np.int32)])
    for got, want in zip(tpi.lookup(tidx, t(q)),
                         jpi.lookup(jidx, jnp.asarray(q))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(tpi.traverse(tidx, t(q)).numpy(),
                                  np.asarray(jpi.traverse(jidx,
                                                          jnp.asarray(q))))


# ---------------------------------------------------------------------------
# rebuild
# ---------------------------------------------------------------------------

def test_needs_rebuild_integer_precision_matches_jax():
    """float32 rounds n = 2**25 + 2 down; the threshold must stay exact."""
    jcfg, tcfg = configs(capacity=256, pending_capacity=64, fanout=4,
                         rebuild_frac=0.5)
    keys = np.arange(8, dtype=np.int32)
    tidx = tpi.build(tcfg, keys, keys, device="cpu")
    jidx = jpi.build(jcfg, jnp.asarray(keys), jnp.asarray(keys))
    big_n = (1 << 25) + 2
    exact = -(-big_n // 2)
    for upd, due in ((exact - 1, False), (exact, True)):
        tb = dataclasses.replace(tidx, n=torch.tensor(big_n, dtype=torch.int32),
                                 n_updates=torch.tensor(upd,
                                                        dtype=torch.int32))
        jb = dataclasses.replace(jidx, n=jnp.array(big_n, jnp.int32),
                                 n_updates=jnp.array(upd, jnp.int32))
        assert bool(tpi.needs_rebuild(tb)) is due
        assert bool(jpi.needs_rebuild(jb)) is due


def _churn(rng, keys, local):
    if local:   # clustered new keys: a few dirty segments
        return np.setdiff1d((60_000 + np.arange(40) * 3).astype(np.int32),
                            keys)[:32]
    return np.setdiff1d(rng.choice(100_000, 120, replace=False)
                        .astype(np.int32), keys)[:100]


@pytest.mark.parametrize("local", [True, False], ids=["incremental",
                                                       "repack"])
@pytest.mark.parametrize("backend", ["xla", "pallas-interpret"])
def test_rebuild_tiers_match_jax(rng, local, backend):
    jidx, tidx, keys, _ = mk_pair(rng, n=400, key_space=100_000,
                                  backend=backend, capacity=1024,
                                  pending_capacity=128)
    # some tombstones in storage and in the pending buffer first
    dels = np.concatenate([np.sort(keys)[100:110]]).astype(np.int32)
    jidx, tidx, _ = run_both(jidx, tidx, np.full(dels.size, 2, np.int32),
                             dels, np.zeros(dels.size, np.int32))
    newk = _churn(rng, keys, local)
    jidx, tidx, _ = run_both(jidx, tidx, np.ones(newk.size, np.int32), newk,
                             np.full(newk.size, 7, np.int32))
    gone = newk[:3]
    jidx, tidx, _ = run_both(jidx, tidx, np.full(3, 2, np.int32), gone,
                             np.zeros(3, np.int32))
    assert bool(tpi.incremental_fits(tidx)) is local
    assert bool(jpi.incremental_fits(jidx)) is local
    assert bool(tpi.needs_rebuild(tidx)) == bool(jpi.needs_rebuild(jidx))
    new_t, incremental = tpi.rebuild_tier(tidx)
    assert incremental is local
    assert_same_state(jpi.rebuild(jidx), new_t, "rebuild")
    assert_same_state(jpi.repack(jidx), tpi.repack(tidx), "repack")
    assert_same_state(jpi.maybe_rebuild(jidx), tpi.maybe_rebuild(tidx),
                      "maybe_rebuild")
    assert tpi.validate_layout(new_t)
    ref = RefIndex.build(keys, np.arange(len(keys)))
    for k in dels:
        ref.data.pop(int(k))
    ref.data.update({int(k): 7 for k in newk[3:]})
    k, v = tpi.live_items(new_t)
    np.testing.assert_array_equal(k, np.array(sorted(ref.data), np.int32))
    np.testing.assert_array_equal(v, [ref.data[int(x)] for x in k])


def test_repack_flags_capacity_truncation_like_jax():
    jcfg, tcfg = configs(capacity=64, pending_capacity=64, fanout=4)
    keys = np.arange(60, dtype=np.int32) * 7
    jidx = jpi.build(jcfg, jnp.asarray(keys), jnp.asarray(keys))
    tidx = tpi.build(tcfg, keys, keys, device="cpu")
    newk = np.arange(10, dtype=np.int32) * 7 + 1
    jidx, tidx, _ = run_both(jidx, tidx, np.ones(10, np.int32), newk, newk)
    assert not bool(tidx.overflow)
    t2 = tpi.rebuild(tidx)            # 70 live > 64 slots
    assert bool(t2.overflow) and int(t2.n) == 64
    assert_same_state(jpi.rebuild(jidx), t2)
    k2, _ = tpi.live_items(t2)
    np.testing.assert_array_equal(k2, np.sort(np.concatenate([keys,
                                                              newk]))[:64])
    assert bool(tpi.needs_rebuild(t2))
    t3, incremental = tpi.rebuild_tier(t2)
    assert not incremental and not bool(t3.overflow)
    assert_same_state(jpi.rebuild(jpi.rebuild(jidx)), t3)


def test_validate_layout_rejects_broken_state(rng):
    _, tidx, _, _ = mk_pair(rng)
    assert tpi.validate_layout(tidx)
    keys = tidx.keys.clone()
    keys[[0, 1]] = keys[[1, 0]]
    with pytest.raises(AssertionError, match="L2"):
        tpi.validate_layout(dataclasses.replace(tidx, keys=keys))
    with pytest.raises(AssertionError, match="n != occupied"):
        tpi.validate_layout(dataclasses.replace(
            tidx, n=tidx.n + 1))


# ---------------------------------------------------------------------------
# state transfer and devices
# ---------------------------------------------------------------------------

def test_numpy_leaves_round_trip(rng):
    jidx, tidx, keys, _ = mk_pair(rng)
    newk = np.setdiff1d(rng.integers(0, 10_000, 20), keys).astype(np.int32)
    jidx, tidx, _ = run_both(jidx, tidx, np.ones(newk.size, np.int32), newk,
                             newk)
    back = tpi.from_numpy_leaves(tidx.config, tpi.to_numpy_leaves(tidx),
                                 device="cpu")
    assert_same_state(jidx, back)
    # and a JAX index rebuilt from the port's leaves is the same pytree
    leaves = tpi.to_numpy_leaves(tidx)
    again = jpi.PIIndex.tree_unflatten(
        jidx.config, [tuple(map(jnp.asarray, x)) if isinstance(x, tuple)
                      else jnp.asarray(x) for x in leaves])
    assert_same_state(again, tidx)


def test_entry_points_default_to_the_card():
    """build/empty go to the card unless asked, and never fall back."""
    _, tcfg = configs(capacity=64, pending_capacity=16, fanout=4)
    keys = np.arange(5, dtype=np.int32)
    if torch.cuda.is_available():
        assert tpi.build(tcfg, keys, keys).keys.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tpi.build(tcfg, keys, keys)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tpi.empty(tcfg)
    assert tpi.empty(tcfg, device="cpu").keys.device.type == "cpu"
