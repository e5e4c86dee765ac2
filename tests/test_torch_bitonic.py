"""The port's bitonic sort and the ``cuda`` backend's batch sort against
the JAX package.

``bitonic_sort_plain``, ``bitonic_sort`` on CPU tensors (which runs the
plain version) and the oracle ``bitonic_sort_ref`` must equal the JAX
``bitonic_sort_op`` (the Pallas kernel in interpret mode) and its
``bitonic_sort_ref`` bit for bit; ``sort_queries_kernel`` must equal the
JAX one; the ``cuda`` engine's batch sort (padded to a power of two,
arrival index in the tie-break lane) must equal the stable
``sort_queries`` at any batch size, sentinel keys included; and whole
``execute`` windows of the ``cuda`` backend must equal the JAX
``pallas-interpret`` package in every leaf.  The CUDA kernel runs only on
a card: ``test_bitonic_matches_plain_on_card`` needs neither JAX nor the
JAX package (``python -m pytest -m gpu``).
"""
import numpy as np
import pytest
import torch

from repro_torch.analysis import launch_guard
from repro_torch.core import engine as tengine
from repro_torch.core import index as tpi
from repro_torch.core.batch import DELETE, INSERT, SEARCH
from repro_torch.kernels import bitonic_sort as BS
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.pi_search import sentinel_for

I32 = np.iinfo(np.int32)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture
def jx():
    """The JAX side: jnp, the Pallas sort and its wrappers, the oracles."""
    import jax
    import jax.numpy as jnp
    from repro.core import batch as jb
    from repro.core import index as jpi
    from repro.kernels.ops import bitonic_sort_op, sort_queries_kernel
    from repro.kernels.ref import bitonic_sort_ref, pi_search_ref
    import torch_parity
    return dict(jnp=jnp, op=bitonic_sort_op, ref=bitonic_sort_ref,
                sqk=sort_queries_kernel, search_ref=pi_search_ref, jb=jb,
                jpi=jpi, execute=jax.jit(jpi.execute_impl),
                parity=torch_parity)


def assert_pair_equal(got, want):
    for g, w in zip(got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def port_sorts(k, v):
    """The port's three sorts of (k, v) as numpy pairs."""
    return [tuple(x.numpy() for x in fn(t(k), t(v)))
            for fn in (BS.bitonic_sort_plain, BS.bitonic_sort,
                       tref.bitonic_sort_ref)]


# ---------------------------------------------------------------------------
# the network
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B", [16, 64, 256, 2048])
@pytest.mark.parametrize("dt", [np.int32, np.float32])
def test_bitonic_sweep_matches_jax(rng, jx, B, dt):
    k = rng.integers(0, max(4, B // 4), size=B).astype(dt)   # many ties
    v = rng.permutation(B).astype(np.int32)
    jnp = jx["jnp"]
    want = jx["op"](jnp.asarray(k), jnp.asarray(v))
    assert_pair_equal(jx["ref"](jnp.asarray(k), jnp.asarray(v)), want)
    for got in port_sorts(k, v):
        assert_pair_equal(got, want)


@pytest.mark.parametrize("dt", [np.int32, np.float32])
def test_bitonic_sorted_and_reversed_match_jax(jx, dt):
    jnp = jx["jnp"]
    v = np.arange(256, dtype=np.int32)
    for k in (np.arange(256).astype(dt), np.arange(256)[::-1].astype(dt)):
        want = jx["op"](jnp.asarray(k), jnp.asarray(v))
        for got in port_sorts(k, v):
            assert_pair_equal(got, want)
    np.testing.assert_array_equal(port_sorts(k, v)[1][1], v[::-1])


def test_bitonic_extreme_keys_match_jax(rng, jx):
    """Sentinel and INT_MIN keys, values at the int32 limits."""
    jnp = jx["jnp"]
    k = rng.choice(np.array([I32.min, -1, 0, 7, I32.max], np.int32), 256)
    v = rng.choice(np.array([I32.min, 0, 3, I32.max], np.int32), 256)
    want = jx["op"](jnp.asarray(k), jnp.asarray(v))
    for got in port_sorts(k, v):
        assert_pair_equal(got, want)


@pytest.mark.parametrize("B", [0, 3, 100])
def test_bitonic_refuses_other_batch_sizes(B):
    z = torch.zeros(B, dtype=torch.int32)
    for fn in (BS.bitonic_sort, BS.bitonic_sort_plain):
        with pytest.raises(ValueError, match="power-of-two"):
            fn(z, z)


def test_bitonic_cpu_calls_launch_nothing(rng):
    base = launch_guard("bitonic_sort").count()
    k = t(rng.integers(0, 9, 64).astype(np.int32))
    BS.bitonic_sort(k, torch.arange(64, dtype=torch.int32))
    launch_guard("bitonic_sort").expect(base, 0, "a CPU sort")


def test_pi_search_ref_matches_jax(rng, jx):
    storage = np.sort(rng.choice(10_000, 300, replace=False)).astype(np.int32)
    storage = np.concatenate([storage, np.full(100, I32.max, np.int32)])
    q = np.concatenate([rng.integers(-5, 10_010, 200),
                        [I32.min, I32.max, storage[0]]]).astype(np.int32)
    want = jx["search_ref"](jx["jnp"].asarray(storage), jx["jnp"].asarray(q))
    assert_pair_equal([tref.pi_search_ref(t(storage), t(q)).numpy()], [want])


# ---------------------------------------------------------------------------
# the batch sort
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B", [16, 256])
def test_sort_queries_kernel_matches_jax(rng, jx, B):
    ops = rng.integers(0, 3, B).astype(np.int32)
    keys = rng.integers(0, B // 3, B).astype(np.int32)
    vals = rng.integers(0, 1000, B).astype(np.int32)
    jnp = jx["jnp"]
    want = jx["sqk"](*map(jnp.asarray, (ops, keys, vals)))
    got = tops.sort_queries_kernel(t(ops), t(keys), t(vals))
    assert_pair_equal([x.numpy() for x in got], want)


@pytest.mark.parametrize("B", [0, 1, 2, 7, 100, 1000, 8000])
@pytest.mark.parametrize("dt", [np.int32, np.float32])
def test_cuda_engine_sort_matches_stable_sort(rng, jx, B, dt):
    """``bitonic_argsort``'s plain version (padding to a power of two with
    the sentinel), sentinel keys in the batch, ties everywhere: the
    permutation of the stable sort."""
    keys = rng.integers(0, max(2, B // 5), B).astype(dt)
    keys[rng.random(B) < 0.2] = sentinel_for(dt)
    ops = rng.integers(0, 3, B).astype(np.int32)
    vals = rng.integers(0, 1000, B).astype(np.int32)
    jnp = jx["jnp"]
    want = jx["jb"].sort_queries(*map(jnp.asarray, (ops, keys, vals)))
    got = tengine.SearchEngine("cuda").sort_queries(t(ops), t(keys),
                                                    t(vals))
    assert got[0].dtype == torch.int64
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        assert g.numpy().dtype.kind == np.asarray(w).dtype.kind


def test_cuda_execute_sorts_once_with_the_network(rng, monkeypatch):
    """One ``bitonic_argsort`` call per execute on the cuda backend, on
    the batch as it is (the kernel pads it), none on the torch backend,
    and no path to ``core.batch.sort_queries`` (the stable
    ``torch.argsort``) from the cuda backend."""
    calls = []
    real = tengine.bitonic_argsort

    def counting(keys):
        calls.append(keys.shape[0])
        return real(keys)

    def refuse(*args):
        raise AssertionError("cuda backend reached torch.argsort")

    monkeypatch.setattr(tengine, "bitonic_argsort", counting)
    monkeypatch.setattr(tengine, "sort_queries", refuse)
    cfg = tpi.PIConfig(capacity=256, pending_capacity=64, fanout=4)
    idx = tpi.build(cfg, np.arange(0, 200, 2, dtype=np.int32),
                    np.arange(100, dtype=np.int32), device="cpu")
    for B in (1, 20, 32):
        ops = t(rng.integers(0, 3, B).astype(np.int32))
        keys = t(rng.integers(0, 220, B).astype(np.int32))
        idx, _ = tpi.execute(idx, ops, keys, keys)
    assert calls == [1, 20, 32]
    monkeypatch.undo()
    monkeypatch.setattr(tengine, "bitonic_argsort", counting)
    tpi.execute(tpi.with_backend(idx, "torch"), ops, keys, keys)
    assert calls == [1, 20, 32]


@pytest.mark.parametrize("B", [37, 64])
def test_cuda_execute_windows_match_pallas_interpret(rng, jx, B):
    """Windows of mixed ops through the cuda backend's execute (bitonic
    batch sort) against the JAX pallas-interpret package: results and
    every leaf after every window."""
    jnp, parity = jx["jnp"], jx["parity"]
    jcfg, tcfg = parity.configs(backend="pallas-interpret", capacity=512,
                                pending_capacity=256, fanout=4, tile_q=64)
    keys0 = rng.choice(4000, 150, replace=False).astype(np.int32)
    vals0 = np.arange(150, dtype=np.int32)
    jidx = jx["jpi"].build(jcfg, jnp.asarray(keys0), jnp.asarray(vals0))
    tidx = tpi.build(tcfg, keys0, vals0, device="cpu")
    for w in range(4):
        ops = rng.choice([SEARCH, INSERT, DELETE], B).astype(np.int32)
        keys = np.concatenate([rng.choice(keys0, B // 2),
                               rng.integers(0, 4000, B - B // 2)])
        keys = rng.permutation(keys).astype(np.int32)
        keys[:3] = (I32.max, I32.min, keys[3])     # sentinel, min, a tie
        vals = rng.integers(-9, 1000, B).astype(np.int32)
        jidx, (jf, jv) = jx["execute"](jidx, jnp.asarray(ops),
                                       jnp.asarray(keys), jnp.asarray(vals))
        tidx, (tf, tv) = tpi.execute(tidx, t(ops), t(keys), t(vals))
        np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        parity.assert_same_state(jidx, tidx, f"window {w}")


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.gpu
def test_bitonic_matches_plain_on_card(rng):
    """The CUDA kernel equals its plain version on the card, bit for bit,
    in one shared-memory block and across the global-memory stages, and
    the engine route equals the stable argsort at a ragged batch."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the kernel runs only on one")
    dev = "cuda"
    base = launch_guard("bitonic_sort").count()
    cases = 0
    for B, dt in [(2, np.int32), (8192, np.int32), (8192, np.float32),
                  (1 << 15, np.int32), (1 << 17, np.float32)]:
        k = t(rng.integers(0, max(2, B // 4), B).astype(dt)).to(dev)
        v = t(rng.permutation(B).astype(np.int32)).to(dev)
        got = BS.bitonic_sort(k, v)
        want = BS.bitonic_sort_plain(k, v)
        assert all(torch.equal(g, w) for g, w in zip(got, want)), (B, dt)
        cases += 1
    launch_guard("bitonic_sort").expect(base, cases, "one sort a case")
    keys = t(rng.integers(0, 2000, 8000).astype(np.int32)).to(dev)
    keys[::7] = sentinel_for(torch.int32)
    ops = torch.zeros(8000, dtype=torch.int32, device=dev)
    perm = tengine.SearchEngine("cuda").sort_queries(ops, keys, ops)[0]
    assert torch.equal(perm, torch.argsort(keys, stable=True))
    with pytest.raises(TypeError):
        BS.bitonic_sort(k.double(), v)


def card_inputs(rng, B, dt):
    """(name, keys, vals) of the card sweep at B lanes: ties, all equal,
    sorted, reversed, organ pipe, 1/8 sentinel keys, int32 limits in both
    lanes, and +-inf keys in float32."""
    ties = rng.integers(-B // 8, max(2, B // 4), B).astype(dt)
    asc = np.sort(ties)
    with_sent = ties.copy()
    with_sent[rng.random(B) < 0.125] = sentinel_for(dt)
    limits = np.array([I32.min, I32.min + 1, -1, 0, I32.max - 1, I32.max])
    cases = [("ties", ties, None), ("equal", np.full(B, 7, dt), None),
             ("sorted", asc, None), ("reversed", asc[::-1], None),
             ("organ pipe", np.concatenate([asc[::2], asc[1::2][::-1]]),
              None),
             ("sentinels", with_sent, None),
             ("limits", rng.choice(limits, B).astype(dt),
              rng.choice(limits, B).astype(np.int32))]
    if dt == np.float32:
        inf = ties.copy()
        inf[rng.random(B) < 0.25] = np.inf
        inf[rng.random(B) < 0.25] = -np.inf
        cases.append(("inf", inf, None))
    return [(name, k, rng.permutation(B).astype(np.int32) if v is None
             else v) for name, k, v in cases]


@pytest.mark.gpu
def test_bitonic_sweep_on_card(rng):
    """Every B = 2^1 .. 2^22 in int32 and float32 on the card, bit for bit
    against ``bitonic_sort_ref`` and, up to 2^17, ``bitonic_sort_plain``:
    the one-block tiles, the padding below them and every multi-pass plan;
    then ``bitonic_argsort`` at ragged B against the stable argsort."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the kernel runs only on one")
    dev = "cuda"
    for log_b in range(1, 23):
        for dt in (np.int32, np.float32):
            for name, k, v in card_inputs(rng, 1 << log_b, dt):
                k, v = t(k).to(dev), t(v).to(dev)
                got = BS.bitonic_sort(k, v)
                wants = [tref.bitonic_sort_ref(k, v)]
                if log_b <= 17:
                    wants.append(BS.bitonic_sort_plain(k, v))
                for want in wants:
                    assert all(torch.equal(g, w) for g, w in
                               zip(got, want)), (log_b, dt, name)
    for B in (2, 3, 100, 1000, 8000, 8191, 8193, 100_000, 1_000_000,
              (1 << 22) - 5):
        for dt in (np.int32, np.float32):
            keys = t(card_inputs(rng, B, dt)[5][1]).to(dev)
            assert torch.equal(BS.bitonic_argsort(keys),
                               torch.argsort(keys, stable=True)), (B, dt)
