"""The port's descent kernels against the JAX package's Pallas kernels.

``pi_search_plain`` / ``pi_probe_plain`` (and the wrappers, which take the
plain version for a CPU tensor) must equal the JAX ``pi_search`` /
``pi_probe`` run in interpret mode, bit for bit, over a sweep of
capacities, fanouts and key dtypes, with ragged batches of duplicates,
misses, keys below the minimum and sentinel keys, on random and on sorted
(window) lanes, with float32 probes too.  ``group_bounds_plain``, the
model of the kernels' G-ary pending search, must count what
``torch.searchsorted`` counts at every group size the kernels can be built
with.  The CUDA kernels themselves run only on a card:
``test_kernels_match_plain_on_card``,
which needs neither JAX nor the JAX package, so that it also runs where
only PyTorch is installed (``python -m pytest -m gpu``).
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.analysis import launch_guard
from repro_torch.core import index as tpi
from repro_torch.kernels import pi_search as K

I32 = np.iinfo(np.int32)
GROUPS = (8, 16, 32)   # the group sizes csrc/pi_search.cu builds with


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture
def jx():
    """The JAX side: jnp, the Pallas kernels, build/insert, the bridge."""
    import jax.numpy as jnp
    from repro.core import build, insert_batch
    from repro.kernels.pi_search import pi_probe, pi_search
    import torch_parity
    return dict(jnp=jnp, probe=pi_probe, search=pi_search, build=build,
                insert=insert_batch, parity=torch_parity)


def make_storage(rng, C, dt, fill=0.9):
    """A dense sorted storage array with a sentinel tail."""
    if np.issubdtype(dt, np.integer):
        sent = I32.max
        keys = np.sort(rng.choice(C * 10, size=int(C * fill),
                                  replace=False)).astype(dt)
    else:
        sent = np.inf
        keys = np.unique(rng.uniform(0, 1e6, size=int(C * fill)).astype(dt))
    storage = np.full(C, sent, dt)
    storage[:len(keys)] = keys
    return storage


def mixed_queries(rng, stored, B, hi, dt):
    """Ragged batch: stored keys, duplicates, misses, below-min, sentinels."""
    big = I32.max if np.issubdtype(dt, np.integer) else np.inf
    low = I32.min if np.issubdtype(dt, np.integer) else -np.inf
    q = np.concatenate([
        stored[: B // 4], stored[: B // 8],
        rng.uniform(-10, hi, B // 2).astype(dt),
        np.array([stored.min() - 1, low, big, big], dt)])
    q = np.concatenate([q, rng.uniform(0, hi, B - q.size).astype(dt)])
    return rng.permutation(q.astype(dt))


@pytest.mark.parametrize("C", [64, 1000, 4096])
@pytest.mark.parametrize("fanout", [4, 8, 16])
@pytest.mark.parametrize("dt", [np.int32, np.float32])
def test_pi_search_plain_matches_jax(rng, jx, C, fanout, dt):
    storage = make_storage(rng, C, dt)
    q = mixed_queries(rng, storage[storage < storage.max()], 301, C * 10, dt)
    jnp = jx["jnp"]
    want = np.asarray(jx["search"](jnp.asarray(storage), jnp.asarray(q),
                                   fanout=fanout, tile_q=64, interpret=True))
    got = K.pi_search_plain(t(storage), t(q), fanout=fanout)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # the wrapper takes the plain version for a CPU tensor
    np.testing.assert_array_equal(
        K.pi_search(t(storage), t(q), fanout=fanout).numpy(), want)


def _keys(rng, C):
    n = int(C * 0.4)
    keys = rng.choice(C * 20, n, replace=False).astype(np.int32)
    return keys, rng.integers(0, C * 20, C // 16).astype(np.int32)


def _geometry(C, fanout):
    return dict(capacity=C, pending_capacity=min(C // 4, 1024),
                fanout=fanout, tile_q=64)


def _port_index(rng, C, fanout):
    """The port's index with a partly filled pending buffer (CPU)."""
    keys, newk = _keys(rng, C)
    cfg = tpi.PIConfig(**_geometry(C, fanout))
    idx = tpi.build(cfg, keys, np.arange(keys.size, dtype=np.int32),
                    device="cpu")
    idx, _ = tpi.insert_batch(idx, t(newk), t(newk))
    return idx, keys, newk


@pytest.mark.parametrize("C", [64, 1000, 4096])
@pytest.mark.parametrize("fanout", [4, 8, 16])
def test_pi_probe_plain_matches_jax(rng, jx, C, fanout):
    jnp = jx["jnp"]
    keys, newk = _keys(rng, C)
    jcfg, tcfg = jx["parity"].configs(**_geometry(C, fanout))
    idx = jx["build"](jcfg, jnp.asarray(keys),
                      jnp.asarray(np.arange(keys.size, dtype=np.int32)))
    idx, _ = jx["insert"](idx, jnp.asarray(newk), jnp.asarray(newk))
    tidx = jx["parity"].to_torch(idx, tcfg)
    q = mixed_queries(rng, np.concatenate([keys, newk]), 299, C * 20,
                      np.int32)
    want = jx["probe"](idx.keys, idx.pkeys, jnp.asarray(q), fanout=fanout,
                       tile_q=64, interpret=True, levels=idx.levels)
    for fn in (K.pi_probe_plain, K.pi_probe):
        got = fn(tidx.keys, tidx.pkeys, t(q), fanout=fanout,
                 levels=tidx.levels)
        for g, w in zip(got, want):
            assert g.dtype == torch.int32
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # derived levels (no precomputed index layer) give the same answer
    np.testing.assert_array_equal(
        K.pi_probe_plain(tidx.keys, tidx.pkeys, t(q), fanout=fanout)[0]
        .numpy(), np.asarray(want[0]))
    # pi_search over the gapped layout with precomputed levels
    want_s = jx["search"](idx.keys, jnp.asarray(q), fanout=fanout,
                          tile_q=64, interpret=True, levels=idx.levels)
    np.testing.assert_array_equal(
        K.pi_search(tidx.keys, t(q), fanout=fanout,
                    levels=tidx.levels).numpy(), np.asarray(want_s))


@pytest.mark.parametrize("C,fanout", [(3, 4), (8, 8), (5, 16)])
def test_storage_without_levels_matches_jax(rng, jx, C, fanout):
    """C <= F: no index level; the top is the storage, read F wide."""
    storage = np.full(C, I32.max, np.int32)
    storage[: C - 1] = np.sort(rng.choice(100, C - 1, replace=False))
    pending = np.array([5, 50, I32.max, I32.max], np.int32)
    q = np.array([-1, 0, 5, 50, 99, I32.max, I32.min, 7], np.int32)
    jnp = jx["jnp"]
    want = jx["probe"](jnp.asarray(storage), jnp.asarray(pending),
                       jnp.asarray(q), fanout=fanout, tile_q=8,
                       interpret=True)
    got = K.pi_probe_plain(t(storage), t(pending), t(q), fanout=fanout)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_cpu_calls_launch_nothing(rng):
    storage = make_storage(rng, 256, np.int32)
    q = t(storage[:40])
    base = {n: launch_guard(n).count() for n in ("pi_search", "pi_probe")}
    K.pi_search(t(storage), q, fanout=4)
    K.pi_probe(t(storage), t(storage[:32].copy()), q, fanout=4)
    for name, b in base.items():
        launch_guard(name).expect(b, 0, "a CPU call")


def test_lower_bound_equals_searchsorted(rng):
    """The branchless lower bound is searchsorted-left for any length."""
    for n in (1, 2, 7, 64, 1000):
        keys = np.full(n, I32.max, np.int32)
        live = np.sort(rng.choice(5000, n // 2, replace=False))
        keys[: live.size] = live
        q = rng.integers(-5, 5005, 97).astype(np.int32)
        q[:3] = (I32.max, I32.min, 0)
        np.testing.assert_array_equal(
            K._lower_bound(t(keys), t(q)).numpy(),
            np.searchsorted(keys, q, side="left"))


@pytest.mark.parametrize("n", [1, 2, 7, 64, 1000, (1 << 12) + 3])
@pytest.mark.parametrize("group", GROUPS)
def test_group_lower_bound_equals_searchsorted(rng, n, group):
    """The kernels' one-sided G-ary pending bound (``group_bounds_plain``,
    the model of ``GroupLowerBound``) is searchsorted-left at any length,
    on a sentinel-padded buffer with keys at the int32 limits."""
    keys = np.full(n, I32.max, np.int32)
    live = np.sort(rng.choice(5 * n + 10, (n + 1) // 2, replace=False))
    keys[: live.size] = live
    keys[0] = I32.min if n > 2 else keys[0]
    keys = np.sort(keys)
    q = rng.integers(-5, 5 * n + 15, 211).astype(np.int32)
    q[:4] = (I32.max, I32.min, 0, I32.max - 1)
    got = K.group_bounds_plain(t(keys), t(q), group=group)
    assert got.dtype == torch.int32
    want = torch.searchsorted(t(keys), t(q))
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    np.testing.assert_array_equal(got.numpy(),
                                  K._lower_bound(t(keys), t(q)).numpy())


@pytest.mark.parametrize("order", ["random", "sorted"])
@pytest.mark.parametrize("fanout", [4, 8, 16])
def test_plain_matches_jax_on_window_lanes(rng, jx, order, fanout):
    """``pi_probe_plain`` and ``pi_search_plain`` equal the JAX kernels in
    interpret mode on a pending-filled index, for a window's lanes in
    arrival order and sorted by key, as ``execute`` probes them."""
    C = 4096
    jnp = jx["jnp"]
    keys, newk = _keys(rng, C)
    jcfg, tcfg = jx["parity"].configs(**_geometry(C, fanout))
    idx = jx["build"](jcfg, jnp.asarray(keys),
                      jnp.asarray(np.arange(keys.size, dtype=np.int32)))
    idx, _ = jx["insert"](idx, jnp.asarray(newk), jnp.asarray(newk))
    tidx = jx["parity"].to_torch(idx, tcfg)
    q = mixed_queries(rng, np.concatenate([keys, newk]), 512, C * 20,
                      np.int32)
    if order == "sorted":
        q = np.sort(q)
    want = jx["probe"](idx.keys, idx.pkeys, jnp.asarray(q), fanout=fanout,
                       tile_q=64, interpret=True, levels=idx.levels)
    got = K.pi_probe_plain(tidx.keys, tidx.pkeys, t(q), fanout=fanout,
                           levels=tidx.levels)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert int(((got[2] & K.FLAG_PENDING_HIT) > 0).sum()) > 0
    assert int(((got[2] & K.FLAG_MAIN_MATCH) > 0).sum()) > 0
    want_s = jx["search"](idx.keys, jnp.asarray(q), fanout=fanout,
                          tile_q=64, interpret=True, levels=idx.levels)
    np.testing.assert_array_equal(
        K.pi_search_plain(tidx.keys, t(q), fanout=fanout,
                          levels=tidx.levels).numpy(), np.asarray(want_s))


def float_probe_inputs(rng, C, B):
    """float32 storage with an +inf tail, a sorted +inf-padded pending
    buffer holding some stored keys and some new ones, and a ragged batch
    of stored and pending keys, misses, keys below the minimum, -inf and
    +inf."""
    storage = make_storage(rng, C, np.float32)
    stored = storage[np.isfinite(storage)]
    PC = max(C // 4, 4)
    fresh = rng.uniform(0, 1e6, PC // 2).astype(np.float32)
    pend = np.concatenate([fresh[: PC // 2 - 1], stored[:1]])
    pending = np.full(PC, np.inf, np.float32)
    pending[: pend.size] = np.sort(pend)
    q = mixed_queries(rng, np.concatenate([stored, pend]), B, 1e6,
                      np.float32)
    return storage, pending, q


@pytest.mark.parametrize("C,fanout", [(64, 4), (1000, 8), (4096, 16),
                                      (5, 16)])
def test_pi_probe_float32_matches_jax(rng, jx, C, fanout):
    """A float32 probe (storage, pending and queries, with +-inf and keys
    below the minimum): the plain version and the CPU wrapper equal the
    JAX ``pi_probe`` in interpret mode, bit for bit (C = 5: no level)."""
    storage, pending, q = float_probe_inputs(rng, C, 299)
    jnp = jx["jnp"]
    want = jx["probe"](jnp.asarray(storage), jnp.asarray(pending),
                       jnp.asarray(q), fanout=fanout, tile_q=64,
                       interpret=True)
    for fn in (K.pi_probe_plain, K.pi_probe):
        got = fn(t(storage), t(pending), t(q), fanout=fanout)
        for g, w in zip(got, want):
            assert g.dtype == torch.int32
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_probe_group_is_the_kernels():
    """``PROBE_GROUP`` is the kernels' group (``PI_PROBE_GROUP``), and one
    of the sizes the tests above hold the model to."""
    src = (Path(K.__file__).parent / "csrc" / "pi_search.cu").read_text()
    m = re.search(r"^#define PI_PROBE_GROUP (\d+)", src, re.M)
    assert m and int(m.group(1)) == K.PROBE_GROUP
    assert K.PROBE_GROUP in GROUPS


@pytest.mark.gpu
def test_kernels_match_plain_on_card(rng):
    """Each CUDA kernel equals its plain version on the card, bit for bit,
    on random and sorted lanes and in int32 and float32, and counts one
    launch per call."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the kernels run only on one")
    dev = "cuda"
    for C, fanout in [(64, 4), (1000, 8), (4096, 16), (625, 5), (5, 16),
                      (24, 2), (2000, 12)]:
        tidx, keys, newk = _port_index(rng, C, fanout)
        lv = tuple(x.to(dev) for x in tidx.levels)
        st, pk = tidx.keys.to(dev), tidx.pkeys.to(dev)
        q = t(mixed_queries(rng, np.concatenate([keys, newk]), 517, C * 20,
                            np.int32)).to(dev)
        base = {n: launch_guard(n).count()
                for n in ("pi_search", "pi_probe")}
        for lanes in (q, torch.sort(q).values):
            got = K.pi_probe(st, pk, lanes, fanout=fanout, levels=lv)
            want = K.pi_probe_plain(st, pk, lanes, fanout=fanout, levels=lv)
            for g, w in zip(got, want):
                assert torch.equal(g, w)
            assert torch.equal(
                K.pi_search(st, lanes, fanout=fanout, levels=lv),
                K.pi_search_plain(st, lanes, fanout=fanout, levels=lv))
        sf, pf, qf = (t(a).to(dev) for a in float_probe_inputs(rng, C, 300))
        for lanes in (qf, torch.sort(qf).values):
            assert torch.equal(K.pi_search(sf, lanes, fanout=fanout),
                               K.pi_search_plain(sf, lanes, fanout=fanout))
            got = K.pi_probe(sf, pf, lanes, fanout=fanout)
            want = K.pi_probe_plain(sf, pf, lanes, fanout=fanout)
            for g, w in zip(got, want):
                assert torch.equal(g, w)
        for name, b in base.items():
            launch_guard(name).expect(b, 4, f"C={C} F={fanout}")
    with pytest.raises(TypeError):
        K.pi_probe(st.double(), pk.double(), q.double(), fanout=fanout)
