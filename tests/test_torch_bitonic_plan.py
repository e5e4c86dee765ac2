"""The schedule of the port's bitonic kernel on CPU.

``kernels.bitonic_sort.pass_plan`` is the one place that decides the CUDA
kernel's launches.  For log2 B in ``LOG_NS`` (with
``test_torch_bitonic_plan_b.py``, every log2 B from 1 to 16) and tiles of 2^2 ..
2^6 lanes (and the card's defaults): the plan must run each (stage,
stride) of the network exactly once, in the network's order, every stride
inside the pass's tile, the tiles of a pass a partition of the lanes; and
a plain executor of the plan -- each pass gathers its tiles as the kernel
does and runs its strides inside them -- must equal ``bitonic_sort_plain``
and the JAX ``bitonic_sort_op`` (the Pallas kernel in interpret mode) bit
for bit.
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels import bitonic_sort as BS
from torch_parity import one_thread  # noqa: F401  (autouse)

I32 = np.iinfo(np.int32)
# log2 B 1..16 split across this file and test_torch_bitonic_plan_b.py
# (one file a worker under --dist loadfile): the JAX sort in interpret
# mode sets each size's time, ~2.5x from one size to the next
LOG_NS = (16, 13, 12, 10, 5, 3)
LOG_TILES = range(2, 7)
_JAX_SORTED = {}


def variants(log_tile):
    """(log_first, min_run, log_gather) choices: the defaults, the smallest
    first tile with one-lane runs, a first tile of the full size with the
    longest runs (one stride bit a multi-stride pass), and multi-stride
    tiles half the size of the others."""
    out = [(None, min(BS.LOG_MIN_RUN, log_tile - 1), BS.LOG_GATHER),
           (1, 1, log_tile), (log_tile, log_tile - 1, log_tile)]
    if log_tile > 2:
        out.append((None, 1, log_tile - 1))
    return out


def network(log_n):
    return [(s, b) for s in range(log_n) for b in range(s, -1, -1)]


def steps(plan):
    return [(s, b) for s0, s1, top, bottom, _, _, _ in plan
            for s in range(s0, s1) for b in range(min(s, top), bottom - 1, -1)]


def tile_index(log_n, log_t, j, h):
    """(blocks, 2^log_t) global lane of each tile element: the kernel's
    ``index``."""
    blk = torch.arange(1 << (log_n - log_t))[:, None]
    L = torch.arange(1 << log_t)[None, :]
    mid = h - j
    base = ((blk & ((1 << mid) - 1)) << j) | ((blk >> mid) << (h + log_t - j))
    return base | (L & ((1 << j) - 1)) | ((L >> j) << h)


def local_bit(b, log_t, j, h):
    if b < j:
        return b
    assert h <= b < h + log_t - j, f"stride bit {b} outside the tile"
    return b - h + j


def run_plan_plain(keys, vals, plan, log_n):
    """The plan's passes as the kernel runs them, in plain PyTorch: each
    pass gathers its tiles, compare-exchanges inside them (partner at
    local bit q, ascending where global bit s + 1 is clear, lexicographic
    (key, value)), and scatters them back."""
    keys, vals = keys.clone(), vals.clone()
    for s0, s1, top, bottom, j, h, log_t in plan:
        gi = tile_index(log_n, log_t, j, h)
        assert torch.equal(gi.flatten().sort().values,
                           torch.arange(1 << log_n)), "tiles overlap"
        k, v = keys[gi], vals[gi]
        L = torch.arange(1 << log_t)
        for s in range(s0, s1):
            up = (gi & (2 << s)) == 0
            for b in range(min(s, top), bottom - 1, -1):
                q = local_bit(b, log_t, j, h)
                partner = L ^ (1 << q)
                pk, pv = k[:, partner], v[:, partner]
                less = (pk < k) | ((pk == k) & (pv < v))
                keep_min = up == ((L & (1 << q)) == 0)
                take = less == keep_min
                take &= (pk != k) | (pv != v)
                k, v = torch.where(take, pk, k), torch.where(take, pv, v)
        keys[gi], vals[gi] = k, v
    return keys, vals


def inputs(log_n):
    rng = np.random.default_rng(log_n)
    B = 1 << log_n
    k = rng.integers(-3, max(2, B // 4), B).astype(np.int32)
    k[rng.random(B) < 0.1] = I32.max
    k[rng.random(B) < 0.05] = I32.min
    v = rng.integers(I32.min, I32.max, B, dtype=np.int64).astype(np.int32)
    v[rng.random(B) < 0.1] = 5                 # equal (key, value) pairs
    return k, v


def jax_sorted(k, v, log_n):
    """The JAX Pallas sort in interpret mode, once for each size."""
    if log_n not in _JAX_SORTED:
        import jax.numpy as jnp
        from repro.kernels.ops import bitonic_sort_op
        out = bitonic_sort_op(jnp.asarray(k), jnp.asarray(v))
        _JAX_SORTED[log_n] = [np.asarray(x) for x in out]
    return _JAX_SORTED[log_n]


@pytest.mark.parametrize("log_tile", LOG_TILES)
@pytest.mark.parametrize("log_n", LOG_NS)
def test_pass_plan_covers_the_network_once_in_order(log_n, log_tile):
    for log_first, min_run, log_gather in variants(log_tile):
        plan = BS.pass_plan(log_n, log_tile, log_first, min_run, log_gather)
        assert steps(plan) == network(log_n), (log_first, min_run)
        for s0, s1, top, bottom, j, h, log_t in plan:
            assert s0 < s1 and bottom <= min(s0, top)
            assert 0 < log_t <= min(log_n, log_tile)
            assert 0 < j <= log_t and j <= h <= log_n - (log_t - j)
            assert j == log_t or j >= min_run, "runs below min_run"
            for s in range(s0, s1):
                for b in range(min(s, top), bottom - 1, -1):
                    local_bit(b, log_t, j, h)
        if log_n > log_tile:
            first = log_first
            if first is None:
                first = log_tile if (1 << (log_n - log_tile)) >= BS.SMS \
                    else log_tile - 1
            k_max = min(log_gather, log_tile) - min_run
            assert len(plan) == 1 + (first < log_tile) + sum(
                1 + math.ceil((s - log_tile + 1) / k_max)
                for s in range(log_tile, log_n))


@pytest.mark.parametrize("log_tile", LOG_TILES)
@pytest.mark.parametrize("log_n", LOG_NS)
def test_pass_plan_executor_matches_plain_and_jax(log_n, log_tile):
    k, v = inputs(log_n)
    want = jax_sorted(k, v, log_n)
    plain = [x.numpy() for x in BS.bitonic_sort_plain(torch.from_numpy(k),
                                                      torch.from_numpy(v))]
    for got, w in zip(plain, want):
        np.testing.assert_array_equal(got, w)
    for log_first, min_run, log_gather in variants(log_tile):
        plan = BS.pass_plan(log_n, log_tile, log_first, min_run, log_gather)
        got = run_plan_plain(torch.from_numpy(k), torch.from_numpy(v), plan,
                             log_n)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), w)


def test_card_plan_launches():
    """The card's defaults: one launch of one block up to 2^13 lanes,
    padded to the smallest one-block tile; at 2^20 16 launches, the first
    with a block for each of the 132 SMs; every tile one the kernel is
    built for; every pass one of its two kernels' (whole stages on
    contiguous tiles, or one stage's strides from the tile's top bit
    down, its direction bit above the tile)."""
    assert [BS.network_log(n) for n in (2, 3, 512, 513, 2048, 2049, 4097,
                                        8192, 8193, 1 << 20)] == \
        [9, 9, 9, 11, 11, 12, 13, 13, 14, 20]
    for log_n in BS.SINGLE_TILES:
        assert len(BS.pass_plan(log_n)) == 1
    plan = BS.pass_plan(20)
    assert len(plan) == 16
    assert 1 << (20 - plan[0][-1]) >= BS.SMS
    for log_n in range(14, 31):
        plan = BS.pass_plan(log_n)
        assert steps(plan) == network(log_n)
        assert all(p[-1] in BS.LOG_R for p in plan)
        for s0, s1, top, bottom, j, h, log_t in plan:
            high = h + log_t - j
            whole_stages = j == h == log_t == s1 and bottom == 0
            one_stage_below_its_direction = s1 == s0 + 1 and \
                top == high - 1 and s0 + 1 >= high
            assert whole_stages or one_stage_below_its_direction
        assert 1 << (log_n - plan[0][-1]) >= min(BS.SMS, 1 << (log_n - 12))


@pytest.mark.parametrize("log_t", sorted(BS.LOG_R))
def test_card_tiles_transpose_without_bank_conflicts(log_t):
    """Every shared-memory access of a tile the kernel is built for -- the
    coalesced rows, and registers in layouts A and B (``Shape::sigma``) --
    gives each half-warp 16 distinct 8-byte bank pairs under the kernel's
    swizzle (``Shape::swizzle``: the low nibble XORed with the higher
    ones)."""
    log_r = BS.LOG_R[log_t]
    threads, lane_end = 1 << (log_t - log_r), log_r + 5
    w = max(0, log_t - lane_end)
    low = (1 << w) - 1
    assert threads >= 32 and w <= lane_end

    def sigma(p):
        return (p & ~(low | (low << lane_end))) | ((p & low) << lane_end) \
            | (p >> lane_end)

    def swizzle(L):
        return L ^ (((L >> 4) ^ (L >> 8) ^ (L >> 12)) & 15)

    for first in range(0, threads, 16):
        half = range(first, first + 16)
        patterns = [[k * threads + t for t in half] for k in range(1 << log_r)]
        for r in range(1 << log_r):
            patterns.append([(t << log_r) | r for t in half])
            patterns.append([sigma((t << log_r) | r) for t in half])
        for words in patterns:
            assert len({swizzle(L) % 16 for L in words}) == 16, (first, words)
