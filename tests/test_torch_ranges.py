"""The port's range aggregation against the JAX package, bit for bit.

``pi_range_plain`` (and the ``pi_range`` wrapper, which takes it for a CPU
tensor) must equal the JAX ``pi_range`` run in interpret mode; the port's
``range_agg`` and ``execute_ranges`` under both backends must equal the
JAX package's under ``xla`` and ``pallas-interpret``.  The cases: fanouts
4/8/16, an empty index, tombstones in storage and in pending, dead pending
lanes, ``lo > hi``, inert ``lo = sentinel, hi = 0`` lanes, ranges below
the minimum, ``hi = INT_MAX - 1``, sums that wrap int32 and truncation at
``max_span``.  ``group_bounds_plain``, the model of the kernel's G-ary
pending search, must count what ``torch.searchsorted`` counts and give
the JAX kernel's pending aggregate at each group size the kernel can be
built with.  The CUDA kernel itself runs only on a card:
``test_pi_range_matches_plain_on_card``, which needs neither JAX nor the
JAX package (``python -m pytest -m gpu``).
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import index as tpi
from repro_torch.core.batch import INSERT, RANGE, SEARCH
from repro_torch.core.engine import range_tables
from repro_torch.kernels import pi_range as KR
from repro_torch.kernels.pi_search import _lower_bound
from repro_torch.pipeline import execute_ranges

I32 = np.iinfo(np.int32)
GROUPS = (8, 16, 32)   # the group sizes csrc/pi_range.cu can be built with


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture
def jx():
    """The JAX side: jnp, the package's index and ranges, the bridge."""
    import jax.numpy as jnp
    from repro.core import index as jpi
    from repro.kernels.pi_range import pi_range
    from repro.pipeline.ranges import execute_ranges
    import torch_parity
    return dict(jnp=jnp, pi=jpi, pi_range=pi_range,
                execute_ranges=execute_ranges, parity=torch_parity)


def _state(jx, rng, backend, C, fanout, seg_width=0, n=None, churn=True):
    """JAX and port indexes with the same state: storage tombstones,
    pending inserts (some tombstoned) and dead pending lanes, with values
    near the int32 limits so that sums wrap.  The state is made by the
    port (held to the JAX package by tests/test_torch_index.py), so that
    the JAX side compiles only the functions under test."""
    jcfg, tcfg = jx["parity"].configs(
        backend=backend, capacity=C, pending_capacity=max(C // 8, 8),
        fanout=fanout, tile_q=64, seg_width=seg_width)
    n = int(C * 0.4) if n is None else n
    keys = rng.choice(C * 20, n, replace=False).astype(np.int32)
    vals = rng.integers(I32.max - 1000, I32.max, n).astype(np.int32)
    tidx = tpi.build(tcfg, keys, vals, device="cpu")
    if churn and n:
        newk = rng.choice(C * 20, C // 16).astype(np.int32)
        newv = rng.integers(I32.min, I32.min + 1000, newk.size) \
            .astype(np.int32)
        tidx, _ = tpi.insert_batch(tidx, t(newk), t(newv))
        dead = np.concatenate([keys[: n // 5], newk[: newk.size // 4]])
        tidx, _ = tpi.delete_batch(tidx, t(dead))
        assert tidx.tomb.any() and tidx.ptomb.any()
    return jx["parity"].to_jax(tidx, jcfg), tidx, keys


def _bounds(rng, keys, B, C):
    """YCSB-style ranges, lo > hi, inert lanes, below-minimum, the top of
    the key space and ranges long enough to hit a small budget."""
    lo = rng.integers(-50, C * 20, B).astype(np.int64)
    hi = lo + rng.integers(-20, C * 4, B)
    lo[:6] = [I32.max, I32.max, -5, I32.min, (keys.min() if keys.size
                                               else 0) - 1, 100]
    hi[:6] = [0, I32.max - 1, I32.max - 1, I32.max - 1, 3, 50]
    return lo.astype(np.int32), np.clip(hi, I32.min, I32.max - 1) \
        .astype(np.int32)


@pytest.mark.parametrize("fanout", [4, 8, 16])
@pytest.mark.parametrize("max_span", [3, 1024])
def test_pi_range_plain_matches_jax(rng, jx, fanout, max_span):
    jnp = jx["jnp"]
    idx, tidx, keys = _state(jx, rng, "pallas-interpret", 1024, fanout,
                             seg_width=fanout ** 2)
    lo, hi = _bounds(rng, keys, 157, 1024)
    live, rank, d2s, plive = range_tables(tidx)
    jargs = [jnp.asarray(x.numpy()) for x in (live, rank, d2s, plive)]
    want = jx["pi_range"](idx.keys, jargs[0], idx.vals, jargs[1], jargs[2],
                          idx.pkeys, idx.pvals, jargs[3], jnp.asarray(lo),
                          jnp.asarray(hi), fanout=fanout, max_span=max_span,
                          tile_q=64, interpret=True, levels=idx.levels)
    assert int(want[0].max()) > 0
    for fn in (KR.pi_range_plain, KR.pi_range):
        got = fn(tidx.keys, live, tidx.vals, rank, d2s, tidx.pkeys,
                 tidx.pvals, plive, t(lo), t(hi), fanout=fanout,
                 max_span=max_span, levels=tidx.levels)
        for g, w in zip(got, want):
            assert g.dtype == torch.int32
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # the inert lanes and lo > hi give (0, 0)
    assert not got[0][:2].any() and not got[1][:2].any()


@pytest.mark.parametrize("backend", ["xla", "pallas-interpret"])
@pytest.mark.parametrize("case", ["churned", "empty", "no-pending"])
def test_range_agg_matches_jax(rng, jx, backend, case):
    """Both port backends against each JAX backend, tolerance zero; the
    sums wrap int32 (values sit at the int32 limits)."""
    jnp, jpi = jx["jnp"], jx["pi"]
    idx, tidx, keys = _state(jx, rng, backend, 512, 4, seg_width=16,
                             n=0 if case == "empty" else None,
                             churn=case == "churned")
    lo, hi = _bounds(rng, keys, 131, 512)
    for max_span in (1, 17, 512):
        want = jpi.range_agg(idx, jnp.asarray(lo), jnp.asarray(hi),
                             max_span)
        for b in ("cuda", "torch"):
            got = tpi.range_agg(tpi.with_backend(tidx, b), t(lo), t(hi),
                                max_span)
            for g, w in zip(got, want):
                assert g.dtype == torch.int32
                np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                              err_msg=f"{b} {max_span}")


@pytest.mark.parametrize("backend", ["xla", "pallas-interpret"])
def test_execute_ranges_matches_jax(rng, jx, backend):
    """A window's RANGE lanes with point and pad lanes between them: the
    point lanes read (0, 0)."""
    jnp = jx["jnp"]
    idx, tidx, keys = _state(jx, rng, backend, 1024, 8)
    B = 96
    ops = rng.choice([SEARCH, INSERT, RANGE], B).astype(np.int32)
    lo, hi = _bounds(rng, keys, B, 1024)
    ops[:2] = RANGE                  # hi = INT_MAX - 1 at RANGE lanes
    lo[:2], hi[:2] = (5, -3), (I32.max - 1, I32.max - 1)
    want = jx["execute_ranges"](idx, jnp.asarray(ops), jnp.asarray(lo),
                                jnp.asarray(hi), 64)
    for b in ("cuda", "torch"):
        got = execute_ranges(tpi.with_backend(tidx, b), t(ops), t(lo),
                             t(hi), 64)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        assert not got[0][ops != RANGE].any()
        assert not got[1][ops != RANGE].any()


@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_range_agg_span_budget_counts_live_keys_not_slots(backend):
    """Slack slots must not spend the max_span budget: a gapped layout
    (seg_width 16, ~25 % occupancy) and a dense one give the full
    aggregate of 60 keys under a budget of 64."""
    keys = np.arange(0, 600, 10, dtype=np.int32)
    vals = (keys * 3).astype(np.int32)
    outs = {}
    for label, seg in (("gapped", 16), ("dense", 1024)):
        cfg = tpi.PIConfig(capacity=1024, pending_capacity=32, fanout=4,
                           seg_width=seg, backend=backend)
        idx = tpi.build(cfg, keys, vals, device="cpu")
        cnt, sm = tpi.range_agg(idx, t(np.array([0], np.int32)),
                                t(np.array([600], np.int32)), 64)
        outs[label] = (int(cnt[0]), int(sm[0]))
    assert outs["dense"] == (60, int(vals.sum()))
    assert outs["gapped"] == outs["dense"]


@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_range_agg_truncation_parity_gapped_vs_dense(backend):
    """Under a budget below the live count both layouts truncate at the
    same key rank."""
    keys = np.arange(0, 400, 4, dtype=np.int32)
    outs = []
    for seg in (16, 1024):
        cfg = tpi.PIConfig(capacity=1024, pending_capacity=32, fanout=4,
                           seg_width=seg, backend=backend)
        idx = tpi.build(cfg, keys, np.ones(100, np.int32), device="cpu")
        cnt, sm = tpi.range_agg(idx, t(np.array([0], np.int32)),
                                t(np.array([400], np.int32)), 17)
        outs.append((int(cnt[0]), int(sm[0])))
    assert outs[0] == outs[1] == (17, 17)


def test_upper_bound_equals_searchsorted_right(rng):
    """The branchless bound with right=True is searchsorted-right, capped
    at the length even for q = INT_MAX (reads past the end compare true)."""
    for n in (1, 2, 7, 64, 1000):
        keys = np.full(n, I32.max, np.int32)
        live = np.sort(rng.choice(5000, n // 2, replace=False))
        keys[: live.size] = live
        q = rng.integers(-5, 5005, 97).astype(np.int32)
        q[:3] = (I32.max, I32.min, 0)
        np.testing.assert_array_equal(
            _lower_bound(t(keys), t(q), right=True).numpy(),
            np.searchsorted(keys, q, side="right"))


def test_pending_prefix_wraps_int32():
    pvals = t(np.array([I32.max, 5, I32.max, -7], np.int32))
    plive = t(np.array([1, 0, 1, 1], np.int32))
    pcnt, psum = KR.pending_prefix(pvals, plive)
    assert pcnt.tolist() == [0, 1, 1, 2, 3]
    assert psum.dtype == torch.int32
    assert psum.tolist() == [0, I32.max, I32.max, -2, -9]


def test_cpu_calls_launch_nothing(rng):
    cfg = tpi.PIConfig(capacity=256, pending_capacity=32, fanout=4)
    idx = tpi.build(cfg, np.arange(0, 500, 5, dtype=np.int32),
                    np.arange(100, dtype=np.int32), device="cpu")
    KR.reset_launch_counts()
    tpi.range_agg(idx, t(np.array([0, 7], np.int32)),
                  t(np.array([100, 3], np.int32)))
    assert KR.LAUNCHES == {"pi_range": 0}


def _sorted_pending(rng, n):
    """A sorted pending buffer of length n: keys with duplicates (some at
    the int32 limits) below sentinel padding."""
    fill = n - n // 4
    keys = np.sort(np.concatenate([
        rng.integers(-1000, 1000, fill), [I32.min, I32.max - 1][:fill]])
        [:fill])
    return np.concatenate([keys, np.full(n - fill, I32.max)]) \
        .astype(np.int32)


@pytest.mark.parametrize("group", GROUPS)
@pytest.mark.parametrize("n", [1, 2, 5, 8, 100, 1000, 4097])
@pytest.mark.parametrize("right", [False, True])
def test_group_bounds_equal_searchsorted(rng, group, n, right):
    """The model of the kernel's G-ary pending search counts what
    ``torch.searchsorted`` counts, left and right, for n not a power of
    two, keys repeated, and queries at the sentinel and the int32
    limits."""
    keys = _sorted_pending(rng, n)
    q = np.concatenate([rng.integers(-1100, 1100, 300), keys[:50],
                        [I32.max, I32.max - 1, I32.min, 0]]).astype(np.int32)
    got = KR.group_bounds_plain(t(keys), t(q), right=right, group=group)
    want = torch.searchsorted(t(keys), t(q), right=right)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    np.testing.assert_array_equal(
        got.numpy(), _lower_bound(t(keys), t(q), right=right).numpy())


@pytest.mark.parametrize("group", GROUPS)
@pytest.mark.parametrize("fanout", [4, 16])
def test_pi_range_group_matches_jax(rng, jx, group, fanout):
    """The pending aggregate of the G-ary model, ``pcnt``/``psum`` between
    ``group_bounds_plain(lo)`` and ``group_bounds_plain(hi, right=True)``,
    equals what the JAX kernel in interpret mode adds for the pending
    lanes (its result less its result with every pending lane dead) on the
    same tables, bit for bit; ``pi_range_plain`` and the CPU wrapper equal
    the JAX kernel."""
    jnp = jx["jnp"]
    idx, tidx, keys = _state(jx, rng, "pallas-interpret", 512, fanout,
                             seg_width=fanout ** 2)
    lo, hi = _bounds(rng, keys, 131, 512)
    live, rank, d2s, plive = range_tables(tidx)

    def jax_range(plive):
        jargs = [jnp.asarray(x.numpy()) for x in (live, rank, d2s, plive)]
        out = jx["pi_range"](idx.keys, jargs[0], idx.vals, jargs[1],
                             jargs[2], idx.pkeys, idx.pvals, jargs[3],
                             jnp.asarray(lo), jnp.asarray(hi), fanout=fanout,
                             max_span=1024, tile_q=64, interpret=True,
                             levels=idx.levels)
        return [torch.from_numpy(np.array(x)).long() for x in out]

    want = jax_range(plive)
    main = jax_range(torch.zeros_like(plive))
    pcnt, psum = KR.pending_prefix(tidx.pvals, plive)
    a = KR.group_bounds_plain(tidx.pkeys, t(lo), group=group).long()
    b = KR.group_bounds_plain(tidx.pkeys, t(hi), right=True,
                              group=group).long()
    nonempty = t(lo) <= t(hi)
    p_cnt = torch.where(nonempty, pcnt[b] - pcnt[a], 0)
    p_sum = KR.wrap_i32(torch.where(nonempty,
                                    psum[b].long() - psum[a].long(), 0))
    assert int(p_cnt.max()) > 0
    np.testing.assert_array_equal(p_cnt.numpy(),
                                  (want[0] - main[0]).numpy())
    np.testing.assert_array_equal(p_sum.numpy(),
                                  KR.wrap_i32(want[1] - main[1]).numpy())
    args = (tidx.keys, live, tidx.vals, rank, d2s, tidx.pkeys, tidx.pvals,
            plive, t(lo), t(hi))
    for fn in (KR.pi_range_plain, KR.pi_range):
        got = fn(*args, fanout=fanout, max_span=1024, levels=tidx.levels)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), KR.wrap_i32(w).numpy())


def test_range_group_is_the_kernels():
    """``RANGE_GROUP`` is the kernel's group (``PI_RANGE_GROUP``), and one
    of the sizes the tests above hold the model to."""
    src = (Path(KR.__file__).parent / "csrc" / "pi_range.cu").read_text()
    m = re.search(r"^#define PI_RANGE_GROUP (\d+)", src, re.M)
    assert m and int(m.group(1)) == KR.RANGE_GROUP
    assert KR.RANGE_GROUP in GROUPS


@pytest.mark.gpu
def test_pi_range_matches_plain_on_card(rng):
    """The CUDA kernel equals its plain version on the card, bit for bit,
    counts one launch per call, and refuses a key dtype it does not take."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the kernel runs only on one")
    dev = "cuda"
    for C, fanout, seg in [(64, 4, 16), (1000, 8, 0), (4096, 16, 256),
                           (625, 5, 25)]:
        cfg = tpi.PIConfig(capacity=C, pending_capacity=max(C // 8, 8),
                           fanout=fanout, seg_width=seg)
        n = int(C * 0.4)
        keys = rng.choice(C * 20, n, replace=False).astype(np.int32)
        vals = rng.integers(I32.max - 1000, I32.max, n).astype(np.int32)
        idx = tpi.build(cfg, keys, vals, device=dev)
        newk = t(rng.choice(C * 20, C // 16).astype(np.int32)).to(dev)
        idx, _ = tpi.insert_batch(idx, newk, newk)
        idx, _ = tpi.delete_batch(idx, t(keys[: n // 5]).to(dev))
        lo, hi = (t(x).to(dev) for x in _bounds(rng, keys, 517, C))
        live, rank, d2s, plive = range_tables(idx)
        args = (idx.keys, live, idx.vals, rank, d2s, idx.pkeys, idx.pvals,
                plive, lo, hi)
        for max_span in (3, 1024):
            KR.reset_launch_counts()
            got = KR.pi_range(*args, fanout=fanout, max_span=max_span,
                              levels=idx.levels)
            want = KR.pi_range_plain(*args, fanout=fanout,
                                     max_span=max_span, levels=idx.levels)
            torch.cuda.synchronize()
            for g, w in zip(got, want):
                assert torch.equal(g, w), (C, fanout, max_span)
            assert KR.LAUNCHES == {"pi_range": 1}
    with pytest.raises(TypeError):
        KR.pi_range(idx.keys.double(), *args[1:], fanout=fanout)
