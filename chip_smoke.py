#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port of PI (``src/repro_torch``).

Run from the root of a checkout, on a machine with one CUDA card:

    python3 chip_smoke.py [--profile WINDOWS]

It builds the CUDA kernels from ``src/repro_torch/kernels/csrc`` and drives
one PI shard at a real data size: 2^24 YCSB keys over a 2^30 key space,
capacity 2^25, pending capacity 2^22, fanout 8, windows of 8192
operations.  Phases:

1. build the kernels and the index; print the card's name and power limit;
2. hold each kernel against its plain PyTorch version on the card, bit for
   bit, at the main paths' shapes, and time both: ``pi_probe`` and
   ``pi_search`` in int32 and float32 on the fresh and the pending-filled
   index, on mixed lanes and on a window's keys sorted (both timed, beside
   one query's probe, an empty kernel and ``torch.searchsorted`` over the
   pending buffer, a partial yardstick for the probe), ``pi_range``
   on the fresh index and on the pending-filled one with deletes (storage
   and pending tombstones), with YCSB-E scans, empty and inert lanes,
   ranges below the minimum or up to INT_MAX - 1 and spans beyond the
   ``max_span`` budget, and on one window of the YCSB-E stream's own
   ranges on both indexes; ``bitonic_sort`` on a window's keys, on keys
   with many ties, sorted, reversed, with sentinel keys, on float32 keys, at
   2^15 and 2^20 keys, and over every B = 2^1 .. 2^22 in int32 and
   float32 (ties, all equal, sorted, reversed, organ pipe, 1/8 sentinels,
   int32 limits in both lanes, +-inf) against ``bitonic_sort_ref`` (and
   the plain version up to 2^17); ``bitonic_argsort``, the ``cuda``
   engine's batch sort, against its plain version and, at ragged batches
   up to 2^22, against ``torch.argsort(stable=True)``; device time and
   launches of a sort at 2^13, 2^15, 2^20 and 2^22 beside the argsort's,
   the bound and an empty kernel's time;
3. the point-op path: windows (write ratio 0.5, zipf theta 0.9) through
   ``step_single``, a two-tier ``rebuild`` (incremental), a ``repack``,
   then ``lookup`` and ``traverse``, with the ``cuda`` backend, checked
   against the ``RefIndex`` oracle and against the ``torch`` backend, bit
   for bit;
4. the serving path: a YCSB workload E stream (95 % scans of 1..100
   records, 5 % inserts, zipf theta 0.9) through ``Dispatcher.run`` at
   depth 1, every RANGE checked against an oracle of the pre-window state
   and every point result against ``RefIndex``, and the same stream with
   the ``torch`` backend, bit for bit; then a mixed stream (30 % scans,
   write ratio 0.5) on an index with a small pending buffer, so that
   rebuilds run inside the dispatcher, against the same oracles;
5. the durable path: the mixed stream through ``Dispatcher.run`` with a
   ``Durability`` (WAL append at seal with a per-window fsync, a snapshot
   every 8 windows) under ``build/durability/``: ``recover`` after a clean
   close gives the live state bit for bit, on the ``cuda`` and on the
   ``torch`` backend; a crash injected at each of the five fault points
   recovers to the state of a dispatcher without durability over exactly
   the recovered windows, which hold every acknowledged one; a new
   ``Durability`` over one recovered index finishes the stream at the
   crash-free state.  Prints the WAL append and fsync times, snapshot and
   recover times and arrivals/s with and without durability;
6. ``[kernels:flash]``: ``flash_attention_fwd`` against its plain
   version on the card at phi3-mini's prefill shape (8 x 2048 tokens, 32
   heads of 96, bfloat16, causal), yi-34b's heads (56 over 8 KV heads),
   MQA with a window of 64, a softcap of 50, a ragged length of 1000 at
   head dim 256, head dims 16, 32 and 64, lengths of 17 and 1 (below one
   key tile), no causal mask, q/k/v views whose base is not 16-byte
   aligned, and in float32 (2, 512, 32, 32, 96) and the same paths (GQA,
   MQA with a window, softcap, S = 1000 at D = 16 and 256, S = 17 and 1,
   not causal, unaligned views), within ``CARD_TOL`` of
   ``kernels/flash_attention.py`` (1e-3 + 2^-6 |plain| in bfloat16, 1e-5
   in float32: what the two can differ by), each case's share of its limit
   printed; device time and TFLOP/s of the tensor-core kernel at phi3's
   shape and of the float32 kernel at (2, 512, 32, 32, 96), each against
   its bound, the plain version and ``F.scaled_dot_product_attention`` in
   its dtype (timed only);
7. ``[lm]``: phi3-mini-3.8b at its full width (32 layers, d 3072, 32
   heads of 96, d_ff 8192, vocab 32064), weights from ``init_params``
   on a CUDA generator seeded with ``SEED``, cast once to bfloat16: a
   prefill of 8 prompts of 2048 tokens (the flash kernel once a layer,
   checked by its count, and ``forward`` likewise), 64 greedy decode
   steps from its cache; then the same config in float32, whose prefill
   of 2 x 256 tokens must agree with 256 token-by-token decode steps
   (attention by plain einsums) in its last logits and every cache leaf;
   device time of a prefill and of a decode step by kernel;
8. ``[serve:lm]``: the LM ``Server`` at that width (8 slots, 128
   positions, the ``cuda`` session table, a WAL under
   ``build/serve_wal``) serves 16 requests with prompts of 16-48 tokens
   and 16 new tokens each until drained, with ``session_range`` checked
   midway against the host's view; ``recover`` of its directory equals
   its table bit for bit;
9. check that each path launched its kernels: ``pi_probe``, ``pi_search``
   and ``bitonic_sort`` on the point path, ``pi_probe`` and
   ``bitonic_sort`` once a window and ``pi_range`` once a range-bearing
   window on the serving, the durable and the LM serving path,
   ``flash_attention_fwd`` once a layer of every prefill and forward.

``--profile N`` adds device time by kernel over N point windows and N
serving windows.  The line before the last is a JSON object with one
entry per kernel; the last line is ``{"ok": true, "device": {...}}``.  Any
failed check raises, so the script exits non-zero and prints no result;
so does a machine without a CUDA card, or a directory without the rest of
the repository.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

# H100 SXM peaks (NVIDIA data sheet): HBM bandwidth, the non-tensor
# float32 rate, taken as the rate of the int32 compares these kernels do,
# and the dense bfloat16 tensor-core rate (attention's operations).
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12

DEVICE = "cuda"
N_KEYS = 1 << 24     # YCSB dataset size (paper: 2M..256M)
WINDOWS = 32         # windows of 8192 operations on the point path
SERVE_WINDOWS = 32   # windows' worth of YCSB-E arrivals through the dispatcher
MIXED_WINDOWS = 16   # windows' worth of the mixed stream
MIXED_PC = 1 << 14   # its pending capacity: rebuilds inside the run
MAX_SPAN = 1024      # occupied-key budget of a RANGE
ITERS = 200          # launches a kernel is timed over (plain version: 1/10)
SWEEP_LOG_B = 22     # [kernels:bitonic] sorts every B = 2^1 .. 2^22
SWEEP_PLAIN_LOG_B = 17   # ... and holds B <= 2^17 to the plain version too
BITONIC_SIZES = (1 << 13, 1 << 15, 1 << 20, 1 << 22)   # ... and times these
SEED = 0
SNAPSHOT_EVERY = 8   # windows between snapshots on the durable path
DURABLE_DIR = os.path.join(ROOT, "build", "durability")
CRASH_POINTS = ("wal.mid_append", "wal.after_append", "wal.pre_sync",
                "ckpt.mid_write", "ckpt.pre_rename")
LM_ARCH = "phi3-mini-3.8b"
LM_PARAMS = 3_822_259_200        # its parameters, vocab padded to 32256
PREFILL_B, PREFILL_S = 8, 2048   # the [lm] prefill: 8 prompts of 2048
DECODE_STEPS = 64                # greedy steps from the prefill's cache
CHECK_B, CHECK_S = 2, 256        # the float32 prefill-vs-decode check
SERVE_REQUESTS = 16              # [serve:lm] requests, 16-48 prompt tokens
SERVE_DIR = os.path.join(ROOT, "build", "serve_wal")
# [kernels:flash]: (name, (B, S, H, KV, D), dtype, options); "phi3" is
# phi3's prefill, the one timed with the bfloat16 kernel, "float32" the
# case timed with the float32 kernel, and the float32 cases after it hold
# that kernel to its bar on every path it has
_BF = torch.bfloat16
_F32 = torch.float32
FLASH_CASES = [
    ("phi3", (PREFILL_B, PREFILL_S, 32, 32, 96), _BF, {}),
    ("yi-34b GQA", (1, 1024, 56, 8, 128), _BF, {}),
    ("MQA window 64", (2, 1024, 16, 1, 128), _BF, dict(window=64)),
    ("softcap 50", (2, 1024, 32, 32, 96), _BF, dict(softcap=50.0)),
    ("ragged S=1000 D=256", (1, 1000, 16, 16, 256), _BF, {}),
    ("D=16", (2, 512, 16, 4, 16), _BF, {}),
    ("D=32", (2, 512, 16, 4, 32), _BF, {}),
    ("D=64", (2, 512, 16, 16, 64), _BF, {}),
    ("S=17", (4, 17, 32, 32, 96), _BF, {}),
    ("S=1", (8, 1, 32, 32, 96), _BF, {}),
    ("not causal", (2, 1024, 32, 32, 96), _BF, dict(causal=False)),
    ("unaligned views", (2, 300, 32, 32, 96), _BF, dict(unaligned=True)),
    ("float32", (2, 512, 32, 32, 96), _F32, {}),
    ("float32 yi-34b GQA", (1, 1024, 56, 8, 128), _F32, {}),
    ("float32 MQA window 64", (2, 1024, 16, 1, 128), _F32, dict(window=64)),
    ("float32 softcap 50", (2, 1024, 32, 32, 96), _F32, dict(softcap=50.0)),
    ("float32 S=1000 D=16", (1, 1000, 16, 16, 16), _F32, {}),
    ("float32 S=1000 D=256", (1, 1000, 16, 16, 256), _F32, {}),
    ("float32 S=17", (4, 17, 32, 32, 96), _F32, {}),
    ("float32 S=1", (8, 1, 32, 32, 96), _F32, {}),
    ("float32 not causal", (2, 1024, 32, 32, 96), _F32, dict(causal=False)),
    ("float32 unaligned views", (2, 300, 32, 32, 96), _F32,
     dict(unaligned=True))]


def log(*args):
    print(*args, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` calls, from CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def device_events(fn, iters: int, operators: bool = True):
    """The device-side events (kernels, copies) of ``iters`` calls of
    ``fn``, from ``torch.profiler``, and the CPU-side operators (none
    unless ``operators``):
    ([(name, self device us, count)], [(operator, self device us, count)])."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA] + (
            [ProfilerActivity.CPU] if operators else [])) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    dev, ops = [], []
    for e in prof.key_averages():
        row = (e.key, e.self_device_time_total, e.count)
        (dev if e.device_type == DeviceType.CUDA else ops).append(row)
    return dev, ops


def device_ms(fn, iters: int, kernel: str | None = None) -> float:
    """Mean device time per call of ``fn``: of the kernels whose name holds
    ``kernel``, or of all its device work.  Free of the host's launch
    overhead, which the CUDA-event time of a launch loop includes; that
    time is the fallback where the profiler sees no device activity."""
    dev, _ = device_events(fn, iters, operators=False)
    us = [t for name, t, _ in dev if kernel is None or kernel in name]
    if not us:
        log(f"[timing] the profiler saw no device time for "
            f"{kernel or 'the call'}: CUDA-event time of the launch loop")
        return time_ms(fn, iters)
    return sum(us) / iters / 1e3


# ---------------------------------------------------------------------------
# the least work the kernels must do, from this run's data
# ---------------------------------------------------------------------------

def _unique(x: torch.Tensor, n: int) -> int:
    x = x[(x >= 0) & (x < n)]
    return int(torch.unique(x).numel())


def descent_touch(levels, storage, q, fanout):
    """(distinct key bytes read by the descent, compares) for queries q.

    Bottom-up ``levels`` as on ``PIIndex.levels``: the top level is read
    whole, then one F-key child group per lower level and per storage;
    each distinct group is counted once.
    """
    from repro_torch.kernels.pi_search import gather_fill, sentinel_for
    sent = sentinel_for(storage.dtype)
    top = levels[-1] if levels else storage
    nbytes = 4 * top.numel()
    ops = q.numel() * top.numel()
    rank = (top[None, :] <= q[:, None]).sum(1) - 1
    pos = rank.clamp_min(0)
    lanes = torch.arange(fanout, device=q.device)
    for arr in list(levels[:-1])[::-1] + [storage]:
        n_groups = -(-arr.numel() // fanout)
        nbytes += 4 * fanout * _unique(pos, n_groups)
        ops += q.numel() * fanout
        ck = gather_fill(arr, pos[:, None] * fanout + lanes[None, :], sent)
        pos = pos * fanout + ((ck <= q[:, None]).sum(1) - 1).clamp_min(0)
    return nbytes, ops


def bound_reads(pending, q, right=False):
    """The pending slots the branchless bound reads for queries q (a flat
    index tensor), its result, and its compares per query."""
    from repro_torch.kernels.pi_search import gather_fill, sentinel_for
    n = pending.numel()
    sent = sentinel_for(pending.dtype)
    below = torch.le if right else torch.lt
    p2 = 1 << max(0, (n - 1).bit_length())
    count = torch.zeros_like(q, dtype=torch.int64)
    read = []
    step = p2 >> 1
    while step:
        cand = count + step
        read.append(cand - 1)
        count = torch.where(below(gather_fill(pending, cand - 1, sent), q),
                            cand, count)
        step >>= 1
    read.append(count)
    pos = (count + below(gather_fill(pending, count, sent), q)).clamp_max(n)
    return torch.cat(read), pos, len(read)


def lower_bound_touch(pending, q):
    """(distinct pending bytes read by the branchless lower bound, compares)."""
    n = pending.numel()
    read, ppos, steps = bound_reads(pending, q)
    read = torch.cat([read, ppos.clamp_max(n - 1)])
    return 4 * _unique(read, n), q.numel() * (steps + 2)


def range_touch(idx, tables, lo, hi, max_span):
    """(distinct bytes pi_range reads and writes, compares, lanes whose
    walk spends the whole budget) for this run's ranges.  Bytes: the
    descent's groups and the floor's rank entry, the walked ranks'
    dense2slot entries and slots' key/live/val entries (up to the first
    key above hi or the budget), the two bounds' pending keys and prefix
    entries, 16 B of bounds and outputs a lane.  Empty lanes (lo > hi)
    read only their bounds."""
    from repro_torch.kernels.pi_search import (gather_fill, pi_search_plain,
                                               sentinel_for)
    _, rank, d2s, _ = tables
    keys, F = idx.keys, idx.config.fanout
    C, PC = keys.numel(), idx.pkeys.numel()
    act = lo <= hi
    lo, hi = lo[act], hi[act]
    nbytes, ops = descent_touch(idx.levels, keys, lo, F)
    pos = pi_search_plain(keys, lo, fanout=F, levels=idx.levels).long()
    nbytes += 4 * _unique(pos, C)
    r0 = torch.where(pos >= 0, rank[pos.clamp(0, C - 1)].long(), 0)
    r = r0.clamp_min(0)[:, None] + torch.arange(max_span, device=lo.device)
    slot = gather_fill(d2s, r, C).long()
    ks = gather_fill(keys, slot, sentinel_for(keys.dtype))
    stop = (r >= C) | (slot >= C) | (ks > hi[:, None])
    walked = (torch.cumsum(stop, 1) - stop.long() == 0) & (r < C)
    read = walked & (slot < C)
    gated = read & (ks >= lo[:, None]) & (ks <= hi[:, None])
    nbytes += 4 * _unique(r[walked], C) + 4 * _unique(slot[read], C) + \
        8 * _unique(slot[gated], C)
    ops += 3 * int(walked.sum())
    pend, prefix = [], []
    for q, right in ((lo, False), (hi, True)):
        reads, pos_p, steps = bound_reads(idx.pkeys, q, right)
        pend.append(reads)
        prefix.append(pos_p)
        ops += q.numel() * (steps + 1)
    nbytes += 4 * _unique(torch.cat(pend), PC) + \
        8 * _unique(torch.cat(prefix), PC + 1)
    return nbytes + 16 * act.numel(), ops, int((walked.sum(1) ==
                                               max_span).sum())


def bound(nbytes: int, ops: int, ops_per_s: float = SCALAR_OPS_PER_S):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def mixed_queries(rng, keys, extra, n, key_space):
    """Stored keys, duplicates, misses, keys below the minimum, sentinels."""
    kmax = np.iinfo(np.int32)
    stored = rng.choice(keys, n // 4)
    parts = [stored, stored[: n // 8], rng.choice(extra, n // 8),
             rng.integers(0, key_space, n // 4).astype(np.int32),
             np.array([keys.min() - 1, kmax.min, -1, 0], np.int32),
             np.full(8, kmax.max, np.int32)]
    q = np.concatenate(parts)
    q = np.concatenate([q, rng.integers(0, key_space, n - q.size)])
    return torch.from_numpy(rng.permutation(q).astype(np.int32)).to(DEVICE)


def empty_kernel_ms(iters: int) -> float:
    """Device time of an empty kernel (``launch_floor``), the least a
    launch of this card takes."""
    from repro_torch.kernels import bitonic_sort as KB
    lib = KB.load_library("bitonic_sort")
    return device_ms(
        lambda: lib.launch_floor(torch.cuda.current_stream().cuda_stream),
        iters, "launch_floor")


def check_kernels(idx, q, window_keys, tag, iters):
    """Each kernel against its plain version at these shapes, in int32 and
    float32, on q and on a window's keys sorted (as ``execute`` probes
    them); timings."""
    from repro_torch.kernels import pi_search as K
    F = idx.config.fanout
    lv, st, pk = idx.levels, idx.keys, idx.pkeys
    # float32 keys: the kernels' second instantiation, on the cast keys
    lvf, stf, pkf = tuple(x.float() for x in lv), st.float(), pk.float()
    sorted_q = torch.sort(window_keys).values

    def probe(lanes=q):
        return K.pi_probe(st, pk, lanes, fanout=F, levels=lv)

    def probe_plain():
        return K.pi_probe_plain(st, pk, q, fanout=F, levels=lv)

    def search(lanes=q):
        return K.pi_search(st, lanes, fanout=F, levels=lv)

    def search_plain():
        return K.pi_search_plain(st, q, fanout=F, levels=lv)

    pairs = []
    for sfx, keys, pend, levels, lanes in (
            ("", st, pk, lv, q), (" f32", stf, pkf, lvf, q.float()),
            (" sorted window", st, pk, lv, sorted_q),
            (" f32 sorted window", stf, pkf, lvf, sorted_q.float())):
        kw = dict(fanout=F, levels=levels)
        pairs += [("pi_probe" + sfx, K.pi_probe(keys, pend, lanes, **kw),
                   K.pi_probe_plain(keys, pend, lanes, **kw)),
                  ("pi_search" + sfx, (K.pi_search(keys, lanes, **kw),),
                   (K.pi_search_plain(keys, lanes, **kw),))]
    got = pairs[0][1]
    torch.cuda.synchronize()
    probe_err = search_err = 0
    for name, gs, ws in pairs:
        for a, b in zip(gs, ws):
            err = int((a.long() - b.long()).abs().max())
            if name.startswith("pi_probe"):
                probe_err = max(probe_err, err)
            else:
                search_err = max(search_err, err)
            assert torch.equal(a, b), f"{name} != plain ({tag})"
    hits = int(((got[0] >= 0) & ((got[2] & 1) > 0)).sum())
    p_hits = int(((got[2] & 2) > 0).sum())

    d_bytes, d_ops = descent_touch(lv, st, q, F)
    p_bytes, p_ops = lower_bound_touch(pk, q)
    B = q.numel()
    probe_bound = bound(d_bytes + p_bytes + 4 * B + 12 * B, d_ops + p_ops)
    search_bound = bound(d_bytes + 4 * B + 4 * B, d_ops)
    plain_iters = max(iters // 10, 5)
    t = dict(
        probe_ms=device_ms(probe, iters, "pi_probe_kernel"),
        probe_call_ms=time_ms(probe, iters),
        probe_plain_ms=device_ms(probe_plain, plain_iters),
        probe_plain_call_ms=time_ms(probe_plain, plain_iters),
        search_ms=device_ms(search, iters, "pi_search_kernel"),
        search_call_ms=time_ms(search, iters),
        search_plain_ms=device_ms(search_plain, plain_iters),
        search_plain_call_ms=time_ms(search_plain, plain_iters),
        probe_sorted_ms=device_ms(lambda: probe(sorted_q), iters,
                                  "pi_probe_kernel"),
        search_sorted_ms=device_ms(lambda: search(sorted_q), iters,
                                   "pi_search_kernel"),
        probe_one_query_ms=device_ms(lambda: probe(q[:1]), iters,
                                     "pi_probe_kernel"),
        empty_kernel_ms=empty_kernel_ms(iters),
        searchsorted_pending_ms=device_ms(
            lambda: torch.searchsorted(pk, q), iters))
    log(f"[kernels:{tag}] B={B} pn={int(idx.pn)} main hits={hits} "
        f"pending hits={p_hits}; pi_probe and pi_search equal to their "
        f"plain versions in int32 and float32 on these lanes and on a "
        f"window's {sorted_q.numel()} keys sorted: max_abs_err probe "
        f"{probe_err} search {search_err}; {d_bytes + p_bytes} B of keys "
        f"touched")
    for name in ("probe", "search"):
        b = probe_bound if name == "probe" else search_bound
        log(f"[kernels:{tag}] pi_{name}: device {t[name + '_ms']:.6f} ms "
            f"(per call with the host's launch {t[name + '_call_ms']:.6f}"
            f" ms), on the sorted window {t[name + '_sorted_ms']:.6f} ms "
            f"| plain version device {t[name + '_plain_ms']:.6f} ms "
            f"(per call {t[name + '_plain_call_ms']:.6f} ms) | bound "
            f"{b[0]:.6f} ms by {b[1]} | empty kernel "
            f"{t['empty_kernel_ms']:.6f} ms")
    log(f"[kernels:{tag}] pi_probe of one query: device "
        f"{t['probe_one_query_ms']:.6f} ms | empty kernel device "
        f"{t['empty_kernel_ms']:.6f} ms | bound {probe_bound[0]:.6f} ms | "
        f"partial yardstick (the pending half alone) searchsorted(pending):"
        f" device {t['searchsorted_pending_ms']:.6f} ms")
    return dict(t, probe_err=probe_err, search_err=search_err,
                probe_bound=probe_bound, search_bound=search_bound)


def range_queries(rng, keys, n, key_space):
    """(lo, hi) lanes: YCSB-E scans (1..100 records: spans of 1..6400 key
    units at 2^24 keys over 2^30), empty ranges (lo > hi), inert lanes
    (lo = sentinel, hi = 0), ranges from below the minimum, ranges up to
    INT_MAX - 1 and spans far beyond the ``max_span`` budget."""
    from repro_torch.kernels.pi_search import sentinel_for
    top = sentinel_for(torch.int32) - 1
    lo = np.concatenate([
        rng.choice(keys, n // 2).astype(np.int64),
        rng.integers(0, key_space, n // 4),
        rng.integers(0, key_space, 256),                        # lo > hi
        np.full(256, top + 1),                                  # inert
        np.iinfo(np.int32).min + rng.integers(0, 1 << 20, 64),  # below min
        rng.integers(key_space - (1 << 16), key_space, 64),     # to the top
        rng.integers(0, key_space, 256)])                       # budget
    m = lo.size - 896
    hi = np.concatenate([
        lo[:m] + rng.integers(1, 6401, m) - 1,
        lo[m:m + 256] - rng.integers(1, 1 << 16, 256),
        np.zeros(256, np.int64),
        keys.min() + rng.integers(0, 1 << 16, 64),
        np.full(64, top),
        lo[m + 640:] + rng.integers(1 << 18, 1 << 22, 256)])
    lo = np.concatenate([lo, rng.integers(0, key_space, n - lo.size)])
    hi = np.concatenate([hi, lo[hi.size:] + rng.integers(0, 6400,
                                                         n - hi.size)])
    order = rng.permutation(n)
    lo = np.clip(lo[order], np.iinfo(np.int32).min, top + 1)
    hi = np.clip(hi[order], np.iinfo(np.int32).min, top)
    return tuple(torch.from_numpy(x.astype(np.int32)).to(DEVICE)
                 for x in (lo, hi))


def ycsb_e_stream(ycfg, keys_np, n_windows, seed):
    """YCSB workload E: scanproportion 0.95, insertproportion 0.05, scan
    lengths uniform in 1..100 records (1..6400 key units at 2^24 keys over
    2^30), zipfian requests; ``n_windows`` windows' worth of arrivals."""
    import dataclasses
    from repro_torch.pipeline import ArrivalConfig, make_arrivals
    return make_arrivals(
        ArrivalConfig(process="poisson", rate=1e6,
                      n_arrivals=n_windows * ycfg.batch, range_frac=0.95,
                      span_min=1, span_max=6400, seed=seed),
        dataclasses.replace(ycfg, write_ratio=1.0), keys_np)


def ycsb_e_lanes(ycfg, keys_np, seed):
    """The (lo, hi) lanes ``execute_ranges`` gives ``pi_range`` for one
    window of the YCSB-E stream: its ranges, and inert lanes for its
    inserts."""
    from repro_torch.pipeline.ranges import _range_lanes
    st = ycsb_e_stream(ycfg, keys_np, 1, seed)
    return _range_lanes(*(torch.from_numpy(x[:ycfg.batch]).to(DEVICE)
                          for x in (st.ops, st.keys, st.keys2)), torch.int32)


def check_range_kernel(idx, lo, hi, tag, iters):
    """pi_range against its plain version at these shapes, bit for bit;
    device times of the kernel, of the plain version and of building the
    tables; the bound."""
    from repro_torch.core.engine import range_tables
    from repro_torch.kernels import pi_range as KR
    F = idx.config.fanout
    tables = range_tables(idx)
    live, rank, d2s, plive = tables
    args = (idx.keys, live, idx.vals, rank, d2s, idx.pkeys, idx.pvals,
            plive, lo, hi)

    def kernel():
        return KR.pi_range(*args, fanout=F, max_span=MAX_SPAN,
                           levels=idx.levels)

    def plain():
        return KR.pi_range_plain(*args, fanout=F, max_span=MAX_SPAN,
                                 levels=idx.levels)

    def build_tables():
        t = range_tables(idx)
        return KR.pending_prefix(idx.pvals, t[3])

    got, want = kernel(), plain()
    torch.cuda.synchronize()
    err = max(int((a.long() - b.long()).abs().max())
              for a, b in zip(got, want))
    for name, a, b in zip(("count", "sum"), got, want):
        assert torch.equal(a, b), f"pi_range {name} != plain ({tag})"
    cnt = want[0]
    n_tomb = int(idx.tomb.sum()), int((idx.ptomb & (torch.arange(
        idx.ptomb.numel(), device=DEVICE) < idx.pn)).sum())
    nbytes, ops, budget = range_touch(idx, tables, lo, hi, MAX_SPAN)
    rb = bound(nbytes, ops)
    plain_iters = max(iters // 10, 5)
    t = dict(ms=device_ms(kernel, iters, "pi_range_group_kernel"),
             call_ms=time_ms(kernel, iters),
             plain_ms=device_ms(plain, plain_iters),
             tables_ms=device_ms(build_tables, iters))
    log(f"[kernels:{tag}] pi_range: B={lo.numel()} pn={int(idx.pn)} "
        f"tombstones storage/pending {n_tomb}; empty lanes "
        f"{int((lo > hi).sum())}; keys counted {int(cnt.sum())}, walks "
        f"spending the budget {budget}; equal to the plain version, "
        f"max_abs_err {err}; {nbytes} B touched")
    log(f"[kernels:{tag}] pi_range: device {t['ms']:.6f} ms at "
        f"{KR.RANGE_GROUP} lanes a query (per call with the host's launch "
        f"{t['call_ms']:.6f} ms) | rank, dense2slot and prefix tables: "
        f"device {t['tables_ms']:.6f} ms | plain version device "
        f"{t['plain_ms']:.6f} ms | bound {rb[0]:.6f} ms by {rb[1]}")
    assert int(cnt.sum()) > 0, "ranges too narrow"
    return dict(t, err=err, bound=rb, budget=budget)


def bitonic_bound(B: int):
    """The least time of a (key, value) sort of B int32 pairs: each pair
    read and written once; one compare-exchange for each pair of each of
    the network's log2(B)(log2(B)+1)/2 stages."""
    log_b = B.bit_length() - 1
    return bound(16 * B, log_b * (log_b + 1) // 2 * (B // 2))


def sweep_inputs(rng, B, dt, sent):
    """(name, keys, vals) of the size sweep at B lanes (numpy): ties, all
    equal, sorted, reversed, organ pipe, 1/8 sentinel keys, int32 limits in
    both lanes, and +-inf keys in float32."""
    i32 = np.iinfo(np.int32)
    ties = rng.integers(-B // 8, max(2, B // 4), B).astype(dt)
    asc = np.sort(ties)
    with_sent = ties.copy()
    with_sent[rng.random(B) < 0.125] = sent
    limits = np.array([i32.min, i32.min + 1, -1, 0, i32.max - 1, i32.max])
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


def sort_device(fn, iters):
    """(device ms, kernel launches) per call of ``fn``: the kernels whose
    name holds ``bitonic``."""
    dev, _ = device_events(fn, iters, operators=False)
    rows = [(t, n) for name, t, n in dev if "bitonic" in name]
    assert rows, "the profiler saw no bitonic kernel"
    return (sum(t for t, _ in rows) / iters / 1e3,
            sum(n for _, n in rows) / iters)


def check_bitonic(rng, window_keys, iters):
    """bitonic_sort against its plain version and the oracle on the card,
    bit for bit: a window's keys with arrival values, then random values
    with many ties, sorted, reversed, with sentinel and INT_MIN keys,
    float32 keys, and 2^15 and 2^20 pairs; then the size sweep, every
    B = 2^1 .. 2^22 in int32 and float32 on the inputs of
    ``sweep_inputs``, against ``bitonic_sort_ref`` and, up to 2^17, the
    plain version.  ``bitonic_argsort`` (the ``cuda`` engine's batch sort)
    against its plain version at the window and against
    ``torch.argsort(stable=True)`` at ragged B, and ``sort_queries_kernel``.
    Device times of the kernel, its plain version and ``torch.argsort`` on
    the window's keys; at each of ``BITONIC_SIZES`` the kernel's device
    time and launches a sort beside the argsort's, the bound, and the
    device time of an empty kernel (the launch floor)."""
    from repro_torch.core.engine import SearchEngine
    from repro_torch.kernels import bitonic_sort as KB
    from repro_torch.kernels.ops import sort_queries_kernel
    from repro_torch.kernels.ref import bitonic_sort_ref
    from repro_torch.kernels.pi_search import sentinel_for
    B = window_keys.numel()
    sent = sentinel_for(torch.int32)

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(DEVICE)

    def ties(n):
        return rng.integers(0, n // 4, n).astype(np.int32)

    def check(name, k, v, plain=True):
        got = KB.bitonic_sort(k, v)
        wants = [bitonic_sort_ref(k, v)] + \
            ([KB.bitonic_sort_plain(k, v)] if plain else [])
        torch.cuda.synchronize()
        err = 0
        for want, what in zip(wants, ("oracle", "plain")):
            as_int = [x.view(torch.int32).long() for x in got + want]
            err = max(err, max(int((a - b).abs().max()) for a, b in
                               zip(as_int[:2], as_int[2:])))
            for a, b, lane in zip(got, want, ("keys", "vals")):
                assert torch.equal(a, b), \
                    f"bitonic_sort {lane} != {what} ({name})"
        return err

    with_sent = ties(B)
    with_sent[rng.random(B) < 0.125] = sent
    with_sent[:16] = np.iinfo(np.int32).min
    floats = ties(B).astype(np.float32)
    floats[rng.random(B) < 0.125] = np.inf
    cases = [("window", window_keys, torch.arange(B, dtype=torch.int32,
                                                  device=DEVICE)),
             ("ties", dev(ties(B)), None),
             ("sorted", dev(np.sort(ties(B))), None),
             ("reversed", dev(np.sort(ties(B))[::-1]), None),
             ("sentinels", dev(with_sent), None),
             ("float32", dev(floats), None),
             ("2^15", dev(ties(1 << 15)), None),
             ("2^20", dev(ties(1 << 20)), None)]
    err = 0
    for name, k, v in cases:
        if v is None:
            v = dev(rng.permutation(k.numel()).astype(np.int32))
        err = max(err, check(name, k, v))
    n_sweep = 0
    for log_b in range(1, SWEEP_LOG_B + 1):
        for dt in (np.int32, np.float32):
            for name, k, v in sweep_inputs(rng, 1 << log_b, dt,
                                           sentinel_for(dt)):
                err = max(err, check(f"2^{log_b} {dt.__name__} {name}",
                                     dev(k), dev(v),
                                     plain=log_b <= SWEEP_PLAIN_LOG_B))
                n_sweep += 1
    keys = dev(with_sent[:8000])
    ops = torch.arange(8000, dtype=torch.int32, device=DEVICE)
    perm = SearchEngine("cuda").sort_queries(ops, keys, ops)[0]
    assert torch.equal(perm, torch.argsort(keys, stable=True)), \
        "cuda engine sort != stable argsort at B = 8000"
    assert torch.equal(KB.bitonic_argsort(window_keys),
                       KB.bitonic_argsort_plain(window_keys)), \
        "bitonic_argsort != its plain version at the window"
    ragged = tuple(n for n in (3, 100, 1000, 8191, 8193, 100_000,
                               1_000_000, (1 << 22) - 5)
                   if n < 1 << SWEEP_LOG_B)
    for n in ragged:
        for dt in (np.int32, np.float32):
            k = dev(sweep_inputs(rng, n, dt, sentinel_for(dt))[5][1])
            assert torch.equal(KB.bitonic_argsort(k),
                               torch.argsort(k, stable=True)), \
                f"bitonic_argsort != stable argsort at B = {n} ({dt})"
    perm32 = sort_queries_kernel(ops[:B // 2], keys[:B // 2], ops[:B // 2])[0]
    assert torch.equal(perm32.long(), torch.argsort(keys[:B // 2],
                                                    stable=True))

    v = cases[0][2]
    plain_iters = max(iters // 10, 5)
    ms, launches = sort_device(lambda: KB.bitonic_sort(window_keys, v), iters)
    t = dict(
        ms=ms,
        call_ms=time_ms(lambda: KB.bitonic_sort(window_keys, v), iters),
        argsort_ms=sort_device(lambda: KB.bitonic_argsort(window_keys),
                               iters)[0],
        plain_ms=device_ms(lambda: KB.bitonic_sort_plain(window_keys, v),
                           plain_iters),
        library_ms=device_ms(lambda: torch.argsort(window_keys, stable=True),
                             iters))
    floor_ms = empty_kernel_ms(iters)
    rb = bitonic_bound(B)
    log(f"[kernels:bitonic] {len(cases)} cases (B = {B}, 2^15, 2^20; int32 "
        f"and float32 keys), the size sweep ({n_sweep} cases, B = 2^1 .. "
        f"2^{SWEEP_LOG_B}, int32 and float32; against the plain version up "
        f"to 2^{SWEEP_PLAIN_LOG_B}), "
        f"bitonic_argsort at the window and at B = "
        f"{', '.join(map(str, ragged))}, the engine's batch sort at "
        f"B = 8000: bit-identical to the plain version, the oracle and the "
        f"stable argsort; max_abs_err {err}")
    log(f"[kernels:bitonic] bitonic_sort B={B}: device {t['ms']:.6f} ms in "
        f"{launches:g} launch (per call with the host's launch "
        f"{t['call_ms']:.6f} ms) | bitonic_argsort (the engine's call) "
        f"device {t['argsort_ms']:.6f} ms | plain version device "
        f"{t['plain_ms']:.6f} ms | torch.argsort(stable) device "
        f"{t['library_ms']:.6f} ms | bound {rb[0]:.6f} ms by {rb[1]} | "
        f"empty kernel device {floor_ms:.6f} ms")
    sizes = {}
    for n in BITONIC_SIZES:
        k = dev(ties(n))
        vn = dev(np.arange(n, dtype=np.int32))
        reps = iters if n <= 1 << 15 else 20
        ms, launches = sort_device(lambda: KB.bitonic_sort(k, vn), reps)
        lib_ms = device_ms(lambda: torch.argsort(k, stable=True), reps)
        bn = bitonic_bound(n)
        sizes[n] = (ms, launches, lib_ms)
        log(f"[kernels:bitonic] B=2^{n.bit_length() - 1}: device {ms:.6f} ms "
            f"in {launches:g} launches | torch.argsort(stable) device "
            f"{lib_ms:.6f} ms | bound {bn[0]:.6f} ms by {bn[1]} | empty "
            f"kernel {floor_ms:.6f} ms")
    return dict(t, err=err, bound=rb, floor_ms=floor_ms, sizes=sizes)


class Oracle:
    """The pre-window answer of every operation of a stream.

    ``RefIndex`` gives the point results.  ``RefIndex.range`` sorts the
    whole map on every call, far too slow at 2^24 keys, so ranges are
    answered from the initial keys as a sorted array with int64 prefix
    sums of their values, plus the same for the (few) keys the stream has
    changed since: per changed key, its change in count and in value.
    """

    def __init__(self, base, k0, v0):
        from repro_torch.core import RefIndex
        self.ref = RefIndex(dict(base))
        self.k0, self.v0 = k0, v0
        self.p0 = np.concatenate([[0], np.cumsum(v0)])
        self.delta = {}          # key -> (count change, value change)
        self.dk = np.zeros(0, np.int64)
        self.dc = self.ds = np.zeros(1, np.int64)

    def _base(self, keys):
        """(in the initial keys, initial value) per key."""
        pos = np.minimum(np.searchsorted(self.k0, keys), self.k0.size - 1)
        has = self.k0[pos] == keys
        return has, np.where(has, self.v0[pos], 0)

    def ranges(self, lo, hi):
        """(count, int32-wrapped sum) of the live keys in [lo, hi]."""
        cnt, sm = 0, 0
        for k, c, v in ((self.k0, None, self.p0),
                        (self.dk, self.dc, self.ds)):
            a = np.searchsorted(k, lo, side="left")
            b = np.maximum(np.searchsorted(k, hi, side="right"), a)
            cnt = cnt + (b - a if c is None else c[b] - c[a])
            sm = sm + v[b] - v[a]
        return cnt, (sm + 2 ** 31) % 2 ** 32 - 2 ** 31

    def execute(self, ops, keys, vals):
        """Apply a window's point ops; returns RefIndex's (found, val)."""
        from repro_torch.core import DELETE, INSERT
        res = self.ref.execute(ops, keys, vals)
        wk = np.unique(keys[(ops == INSERT) | (ops == DELETE)]) \
            .astype(np.int64)
        if wk.size:
            has, v0 = self._base(wk)
            for k, h, v in zip(wk.tolist(), has.tolist(), v0.tolist()):
                now = self.ref.data.get(k)
                change = (int(now is not None) - h,
                          (0 if now is None else now) - v)
                if change == (0, 0):
                    self.delta.pop(k, None)
                else:
                    self.delta[k] = change
            self.dk = np.array(sorted(self.delta), np.int64)
            ch = np.array([self.delta[k] for k in self.dk.tolist()],
                          np.int64).reshape(-1, 2)
            self.dc, self.ds = (np.concatenate([[0], np.cumsum(x)])
                                for x in ch.T)
        return (np.array([r is not None for r in res]),
                np.array([0 if r is None else r for r in res], np.int64))

    def live(self):
        """The live (key, value) pairs, sorted by key."""
        gone = np.isin(self.k0, self.dk)
        k = np.concatenate([self.k0[~gone], self.dk])
        v = np.concatenate([self.v0[~gone], np.array(
            [self.ref.data.get(x, 0) for x in self.dk.tolist()], np.int64)])
        keep = np.concatenate([np.ones((~gone).sum(), bool), np.array(
            [x in self.ref.data for x in self.dk.tolist()], bool)])
        order = np.argsort(k[keep], kind="stable")
        return k[keep][order], v[keep][order]


def check_stream(oracle, retired, tag):
    """Every window in retirement order: its RANGE results against the
    pre-window state, then its point results against ``RefIndex``."""
    from repro_torch.core import RANGE
    n_ranges = n_points = 0
    for k, res in enumerate(retired):
        w = res.window
        occ = w.occupancy
        ops, keys = w.ops[:occ], w.keys[:occ]
        is_r = ops == RANGE
        if is_r.any():
            cnt, sm = oracle.ranges(keys[is_r], w.keys2[:occ][is_r])
            assert np.array_equal(res.rcnt[:occ][is_r], cnt), \
                f"{tag} window {k}: RANGE count != pre-window oracle"
            assert np.array_equal(res.rsum[:occ][is_r], sm), \
                f"{tag} window {k}: RANGE sum != pre-window oracle"
            assert not res.rcnt[:occ][~is_r].any(), f"{tag} window {k}"
            n_ranges += int(is_r.sum())
        found, val = oracle.execute(ops, keys, w.vals[:occ])
        assert np.array_equal(res.found[:occ][~is_r], found[~is_r]), \
            f"{tag} window {k}: found != RefIndex"
        assert np.array_equal(res.val[:occ][~is_r].astype(np.int64),
                              val[~is_r]), f"{tag} window {k}: val != ref"
        n_points += int((~is_r).sum())
    return n_ranges, n_points


def serve(idx, stream, batch, metrics=None):
    """One stream through ``Dispatcher.run`` at depth 1 on the wall clock;
    returns (dispatcher, retired windows, seconds)."""
    from repro_torch.pipeline import Dispatcher, WindowConfig
    disp = Dispatcher(idx, depth=1, max_span=MAX_SPAN, metrics=metrics,
                      clock=time.perf_counter)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if metrics is not None:
        metrics.start(t0)
    retired = disp.run(stream, WindowConfig(batch=batch),
                       clock=time.perf_counter)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    if metrics is not None:
        metrics.stop(t1)
    return disp, retired, t1 - t0


def same_windows(a, b):
    fields = ("found", "val", "rcnt", "rsum", "rebuilt",
              "rebuilt_incremental", "pending_fill")
    return len(a) == len(b) and all(
        np.array_equal(getattr(x, f), getattr(y, f))
        for x, y in zip(a, b) for f in fields)


def kernel_modules():
    from repro_torch.kernels import (bitonic_sort, flash_attention, pi_range,
                                     pi_search)
    return (pi_search, pi_range, bitonic_sort, flash_attention)


def reset_launches():
    for mod in kernel_modules():
        mod.reset_launch_counts()


def launch_counts() -> dict:
    """Every kernel's launches since the last ``reset_launches``."""
    out = {}
    for mod in kernel_modules():
        out.update(mod.LAUNCHES)
    return out


def profile_serving(idx, windows, window_ms, top=12):
    """Device time by kernel and by operator over windows through
    ``Dispatcher.submit`` (ranges + point execute), from ``torch.profiler``;
    the busy share is over ``window_ms``, the unprofiled mean window."""
    from repro_torch.pipeline import Dispatcher
    disp = Dispatcher(idx, depth=1, max_span=MAX_SPAN)
    it = iter(windows)
    dev, ops = device_events(lambda: disp.submit(next(it)), len(windows) - 1)
    disp.flush()
    n = len(windows) - 1
    busy = sum(t for _, t, _ in dev) / n / 1e3
    log(f"[profile:serve] {n} windows: device {busy:.6f} ms a window, "
        f"{100 * busy / window_ms:.2f}% of the unprofiled mean window "
        f"{window_ms:.6f} ms")
    rng_us = sum(t for name, t, _ in dev if "pi_range_group_kernel" in name)
    log(f"[profile:serve] pi_range: {rng_us / n / 1e3:.6f} ms a window, "
        f"{100 * rng_us / n / 1e3 / busy:.2f}% of its device time")
    for title, rows in (("kernel", dev), ("operator", ops)):
        for name, t, count in sorted(rows, key=lambda r: -r[1])[:top]:
            log(f"[profile:serve] {title} {t / n / 1e3:10.6f} ms a window "
                f"({count / n:.1f}x) {name[:90]}")


def run_main_path(idx0, batches, lookup_q):
    """The main path from ``idx0``: windows, rebuild, repack, reads.

    Returns the per-window outputs (on the host), the states after the
    windows / the rebuild / the repack, the read results and timings.
    """
    from repro_torch import core as pi
    from repro_torch.pipeline import step_single
    idx, outs, lat = idx0, [], []
    torch.cuda.synchronize()
    t_all = time.perf_counter()
    for ops, keys, vals in batches:
        t0 = time.perf_counter()
        idx, found, val, ovf, due, incr, pn = step_single(idx, ops, keys, vals)
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t0)
        outs.append((found, val, ovf, due, incr, pn))
    t_windows = time.perf_counter() - t_all
    after_windows = idx
    t0 = time.perf_counter()
    after_rebuild, incremental = pi.rebuild_tier(idx)
    torch.cuda.synchronize()
    t_rebuild = time.perf_counter() - t0
    t0 = time.perf_counter()
    after_repack = pi.repack(after_rebuild)
    torch.cuda.synchronize()
    t_repack = time.perf_counter() - t0
    found, val = pi.lookup(after_repack, lookup_q)
    floor = pi.traverse(after_repack, lookup_q)
    torch.cuda.synchronize()
    outs = [tuple(x.cpu().numpy() for x in o) for o in outs]
    return dict(outs=outs, lat=lat, t_windows=t_windows,
                t_rebuild=t_rebuild, t_repack=t_repack,
                incremental=incremental, states=(after_windows,
                                                 after_rebuild,
                                                 after_repack),
                reads=(found, val, floor))


def same_state(a, b) -> bool:
    la, lb = a.leaves(), b.leaves()
    return all(
        len(x) == len(y) and all(torch.equal(u, v) for u, v in zip(x, y))
        if isinstance(x, tuple) else torch.equal(x, y)
        for x, y in zip(la, lb))


def check_against_ref(ref, batches_np, run, q):
    """Every window's results, the live set after both rebuild tiers, and
    the reads, against the RefIndex oracle."""
    from repro_torch import core as pi
    for w, ((ops, ks, vs), out) in enumerate(zip(batches_np, run["outs"])):
        want = ref.execute(ops, ks, vs)
        found = np.array([r is not None for r in want])
        val = np.array([0 if r is None else r for r in want], np.int64)
        assert np.array_equal(out[0], found), f"window {w}: found != ref"
        assert np.array_equal(out[1].astype(np.int64), val), \
            f"window {w}: val != ref"
        assert not bool(out[2]), f"window {w}: pending overflow"
    rk = np.fromiter(ref.data.keys(), np.int64, len(ref.data))
    rv = np.fromiter(ref.data.values(), np.int64, len(ref.data))
    order = np.argsort(rk)
    rk, rv = rk[order], rv[order]
    for name, state in zip(("rebuild", "repack"), run["states"][1:]):
        k, v = pi.live_items(state)
        assert np.array_equal(k.astype(np.int64), rk), f"{name}: keys != ref"
        assert np.array_equal(v.astype(np.int64), rv), f"{name}: vals != ref"
        assert pi.validate_layout(state)
    found, val, floor = (x.cpu().numpy() for x in run["reads"])
    pos = np.searchsorted(rk, q, side="right") - 1
    hit = (pos >= 0) & (rk[np.clip(pos, 0, None)] == q)
    assert np.array_equal(found, hit), "lookup found != ref"
    assert np.array_equal(val[hit].astype(np.int64), rv[pos[hit]]), \
        "lookup val != ref"
    slots = run["states"][2].keys.cpu().numpy().astype(np.int64)
    below = floor < 0
    assert np.array_equal(below, pos < 0), "traverse underflow != ref"
    assert np.array_equal(slots[floor[~below]], rk[pos[~below]]), \
        "traverse floor key != ref"


def summarize(tag, run, batch):
    lat = np.array(run["lat"]) * 1e3
    n = len(lat)
    log(f"[main:{tag}] {n} windows in {run['t_windows']:.6f} s: "
        f"{n / run['t_windows']:.3f} windows/s, "
        f"{n * batch / run['t_windows']:.1f} ops/s, window latency "
        f"p50 {np.percentile(lat, 50):.6f} ms p99 "
        f"{np.percentile(lat, 99):.6f} ms; rebuild "
        f"({'incremental' if run['incremental'] else 'repack'}) "
        f"{run['t_rebuild'] * 1e3:.6f} ms; repack "
        f"{run['t_repack'] * 1e3:.6f} ms")


def profile_windows(idx, batches, window_ms, top=12):
    """Device time by kernel and by operator over windows through
    ``step_single``, from ``torch.profiler``.  The busy share divides the
    device time per window by ``window_ms``, the mean window latency of
    the run without the profiler (which slows the host)."""
    from repro_torch.pipeline import step_single
    it = iter(batches)

    def window():
        nonlocal idx
        idx = step_single(idx, *next(it))[0]

    dev, ops = device_events(window, len(batches) - 1)
    n = len(batches) - 1
    busy = sum(t for _, t, _ in dev) / n / 1e3
    log(f"[profile] {n} windows: device {busy:.6f} ms a window, "
        f"{100 * busy / window_ms:.2f}% of the unprofiled mean window "
        f"{window_ms:.6f} ms")
    for title, rows in (("kernel", dev), ("operator", ops)):
        for name, t, count in sorted(rows, key=lambda r: -r[1])[:top]:
            log(f"[profile] {title} {t / n / 1e3:10.6f} ms a window "
                f"({count / n:.1f}x) {name[:90]}")


def mixed_setup(cfg, keys_np, vals_np, ycfg):
    """The mixed stream (30 % scans, write ratio 0.5) and its index, with a
    pending capacity of MIXED_PC so that rebuilds run inside the stream."""
    import dataclasses
    from repro_torch import core as pi
    from repro_torch.pipeline import ArrivalConfig, make_arrivals
    idx_m = pi.build(dataclasses.replace(cfg, pending_capacity=MIXED_PC),
                     keys_np, vals_np, device=DEVICE)
    stream = make_arrivals(
        ArrivalConfig(process="poisson", rate=1e6,
                      n_arrivals=MIXED_WINDOWS * ycfg.batch, range_frac=0.3,
                      span_min=1, span_max=6400, seed=SEED + 2),
        ycfg, keys_np)
    return idx_m, stream


def run_serving(args, idx0, keys_np, ycfg, base, idx_m, mixed):
    """Phase 4: the YCSB-E stream and the ``mixed`` one (from ``idx_m``)
    through ``Dispatcher.run``, each checked against the pre-window
    oracle; the YCSB-E stream again with the ``torch`` backend.  Returns
    the YCSB-E run's launch counts."""
    from repro_torch import core as pi
    from repro_torch.pipeline import Collector, PipelineMetrics, WindowConfig
    B = ycfg.batch

    def ycsb_e(n_windows, seed):
        return ycsb_e_stream(ycfg, keys_np, n_windows, seed)

    for backend in ("cuda", "torch"):   # warm-up: first-call costs
        serve(pi.with_backend(idx0, backend), ycsb_e(2, SEED + 9), B)

    stream = ycsb_e(SERVE_WINDOWS, SEED)
    met = PipelineMetrics()
    reset_launches()
    disp, retired, wall = serve(idx0, stream, B, met)
    launches = launch_counts()
    n_win = len(retired)
    n_range_win = sum(r.rcnt is not None for r in retired)
    summ = met.summary()
    log(f"[serve:cuda] YCSB-E {len(stream)} arrivals in {n_win} windows "
        f"({n_range_win} with ranges) in {wall:.6f} s: "
        f"{len(stream) / wall:.1f} arrivals/s; latency p50 "
        f"{summ['p50_ms']:.6f} ms p99 {summ['p99_ms']:.6f} ms; "
        f"range_coalesce_hits {summ['range_coalesce_hits']}, range slots "
        f"{summ['range_slots']}, rebuilds {summ['rebuilds']}; kernel "
        f"launches {launches}")
    assert launches["pi_range"] == n_range_win > 0, launches
    assert launches["pi_probe"] == launches["bitonic_sort"] == n_win, \
        launches

    col = Collector(WindowConfig(batch=B))
    t0 = time.perf_counter()
    for s in range(0, len(stream), B):
        col.offer_many(stream.t[s:s + B], stream.ops[s:s + B],
                       stream.keys[s:s + B], stream.vals[s:s + B],
                       np.arange(s, min(len(stream), s + B)),
                       stream.keys2[s:s + B])
    log(f"[serve:host] admission alone (Collector.offer_many, nothing "
        f"dispatched): {1e3 * B * (time.perf_counter() - t0) / len(stream):.6f}"
        f" ms for {B} arrivals")

    t0 = time.perf_counter()
    oracle = Oracle(*base)
    n_r, n_p = check_stream(oracle, retired, "YCSB-E")
    log(f"[serve:cuda] {n_r} RANGE results agree with the pre-window "
        f"oracle and {n_p} point results with RefIndex (checked in "
        f"{time.perf_counter() - t0:.3f} s)")
    del oracle

    tdisp, t_retired, t_wall = serve(pi.with_backend(idx0, "torch"), stream,
                                     B)
    log(f"[serve:torch] YCSB-E {len(stream)} arrivals in {t_wall:.6f} s: "
        f"{len(stream) / t_wall:.1f} arrivals/s")
    assert same_windows(retired, t_retired), "cuda and torch windows differ"
    assert same_state(disp.index, tdisp.index), "final states differ"
    log("[serve] cuda and torch backends bit-identical: every window's "
        "point and range results and the final state")
    del tdisp, t_retired

    if args.profile:
        extra = ycsb_e(args.profile + 1, SEED + 7)
        col = Collector(WindowConfig(batch=B))
        windows = col.offer_many(extra.t, extra.ops, extra.keys, extra.vals,
                                 np.arange(len(extra)), extra.keys2)[1]
        profile_serving(disp.index, windows[:args.profile + 1],
                        1e3 * wall / n_win)
    del disp, retired

    # a mixed stream on a small pending buffer: rebuilds inside the run
    stream = mixed
    met = PipelineMetrics()
    disp, retired, wall = serve(idx_m, stream, B, met)
    summ = met.summary()
    log(f"[serve:mixed] {len(stream)} arrivals (30 % scans, write ratio "
        f"0.5) in {len(retired)} windows in {wall:.6f} s, PC={MIXED_PC}: "
        f"rebuilds {summ['rebuilds']} ({summ['rebuilds_incremental']} "
        f"incremental), pending fill peak {summ['pending_fill_peak']:.4f}")
    assert summ["rebuilds"] >= 1, "no rebuild inside the mixed stream"
    oracle = Oracle(*base)
    n_r, n_p = check_stream(oracle, retired, "mixed")
    assert pi.validate_layout(disp.index)
    k, v = pi.live_items(disp.index)
    want_k, want_v = oracle.live()
    assert np.array_equal(k.astype(np.int64), want_k)
    assert np.array_equal(v.astype(np.int64), want_v)
    log(f"[serve:mixed] {n_r} RANGE and {n_p} point results agree with "
        f"the oracles across the rebuilds; the final live set equals "
        f"RefIndex's")
    return launches


class SimulatedCrash(RuntimeError):
    """Raised out of a fault point of the port to model the process dying
    there (the WAL writes are unbuffered, so the disk is left as a crash
    at that instruction leaves it)."""


def filesystem_of(path: str) -> str:
    """The type and mount point of the filesystem holding ``path``."""
    best = ("unknown", "")
    with open("/proc/mounts") as f:
        for line in f:
            _, mnt, fstype = line.split()[:3]
            inside = path == mnt or path.startswith(mnt.rstrip("/") + "/")
            if inside and len(mnt) >= len(best[1]):
                best = (fstype, mnt)
    return f"{best[0]} at {best[1]}"


def copy_window(w):
    from repro_torch.pipeline import Window
    return Window(ops=w.ops.copy(), keys=w.keys.copy(), vals=w.vals.copy(),
                  occupancy=w.occupancy, qids=list(w.qids),
                  slots=w.slots.copy(), t_open=w.t_open,
                  t_enq=w.t_enq.copy(), trigger=w.trigger,
                  keys2=w.keys2.copy())


def _timed(fn, times):
    def call(*args, **kw):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        times.append(time.perf_counter() - t0)
        return out
    return call


def drive_durable(idx, stream, B, d, crash=None, hit=1):
    """``stream`` through ``Dispatcher.run`` (depth 1) with a
    ``Durability`` over ``d`` (per-window fsync, a snapshot every
    SNAPSHOT_EVERY windows), dying at the ``hit``-th pass of fault point
    ``crash`` when one is given.  The collector's seal hook copies each
    window before the WAL sees it and records the acknowledged sequence
    numbers.  Returns a dict of the sealed copies, the acknowledged seqs,
    the dispatcher and the host times of appends, fsyncs and snapshots."""
    from repro_torch import faults
    from repro_torch.pipeline import (Collector, Dispatcher, Durability,
                                      WindowConfig)
    shutil.rmtree(d, ignore_errors=True)
    hits = [0]

    def hook(point):
        if point == crash:
            hits[0] += 1
            if hits[0] == hit:
                raise SimulatedCrash(point)

    out = dict(sealed=[], acked=[], append=[], fsync=[], snapshot=[],
               crashed=False)
    prev = faults.set_fault_hook(hook if crash else None)
    try:
        t0 = time.perf_counter()
        dur = Durability(d, idx, fsync="per_window",
                         snapshot_every=SNAPSHOT_EVERY)
        out["t_init"] = time.perf_counter() - t0
        dur.wal.sync = _timed(dur.wal.sync, out["fsync"])
        dur.snapshot = _timed(dur.snapshot, out["snapshot"])
        append = _timed(dur.on_seal, out["append"])

        def on_seal(win):
            out["sealed"].append(copy_window(win))
            out["acked"].append(append(win))

        disp = Dispatcher(idx, depth=1, max_span=MAX_SPAN, durability=dur)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            disp.run(stream, collector=Collector(WindowConfig(batch=B),
                                                 on_seal=on_seal))
            dur.close()
        except SimulatedCrash:
            out["crashed"] = True
        torch.cuda.synchronize()
        out["wall"] = time.perf_counter() - t0
    finally:
        faults.set_fault_hook(prev)
    if crash is not None:
        assert out["crashed"] and hits[0] == hit, \
            f"fault point {crash} was not reached"
    out["disp"] = disp
    return out


def stream_from(stream, start: int):
    """The arrivals of ``stream`` from position ``start`` on."""
    rest = type("Stream", (), {})()
    for name in ("t", "ops", "keys", "vals", "keys2"):
        setattr(rest, name, getattr(stream, name)[start:])
    return rest


def run_durable(idx_m, stream, B):
    """Phase 5: the durable path (see the module docstring).  Returns the
    crash-free durable run's launch counts."""
    from repro_torch import core as pi
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.core import RANGE
    from repro_torch.pipeline import (Dispatcher, Durability, WindowConfig,
                                      read_wal, record_window, recover)
    d = DURABLE_DIR
    os.makedirs(os.path.dirname(d), exist_ok=True)
    fs = filesystem_of(os.path.realpath(os.path.dirname(d)))
    n = len(stream.t)

    _, _, plain_wall = serve(idx_m, stream, B)
    reset_launches()
    run = drive_durable(idx_m, stream, B, d)
    launches = launch_counts()
    live = run["disp"].index
    sealed = run["sealed"]
    n_win = len(sealed)
    n_range_win = sum(bool((w.ops[:w.occupancy] == RANGE).any())
                      for w in sealed)
    assert launches["pi_probe"] == launches["bitonic_sort"] == n_win, \
        launches
    assert launches["pi_range"] == n_range_win > 0, launches
    app, fsy = np.array(run["append"]) * 1e3, np.array(run["fsync"]) * 1e3
    wal_dir = os.path.join(d, "wal")
    wal_bytes = sum(os.path.getsize(os.path.join(wal_dir, f))
                    for f in os.listdir(wal_dir))
    snaps = run["snapshot"]
    log(f"[durable] {n} mixed arrivals in {n_win} windows through "
        f"Dispatcher.run with a Durability (fsync per_window, snapshot "
        f"every {SNAPSHOT_EVERY}) under {d} on {fs}: {n / run['wall']:.1f} "
        f"arrivals/s; the same stream without durability "
        f"{n / plain_wall:.1f} arrivals/s; kernel launches {launches}")
    log(f"[durable] WAL append a window: mean {app.mean():.6f} ms, p99 "
        f"{np.percentile(app, 99):.6f} ms ({len(app)} appends, each with "
        f"its fsync); fsync: mean {fsy.mean():.6f} ms, p99 "
        f"{np.percentile(fsy, 99):.6f} ms ({len(fsy)} fsyncs); WAL bytes "
        f"{wal_bytes}")

    # reference states: a dispatcher without durability over the windows
    ref_states = [idx_m]
    plain = Dispatcher(idx_m, depth=0, max_span=MAX_SPAN)
    for w in sealed:
        plain.submit(copy_window(w))
        ref_states.append(plain.index)
    assert same_state(live, ref_states[-1]), "durability changed the state"

    # 1. crash-free: recover, and its two halves timed apart
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rec, tail = recover(d, device=DEVICE)
    torch.cuda.synchronize()
    t_recover = time.perf_counter() - t0
    assert rec.config.backend == "cuda" and same_state(rec, live), \
        "recover != the live state"
    ckpt = CheckpointManager(os.path.join(d, "ckpt"))
    step = ckpt.latest_step()
    snap_bytes = os.path.getsize(os.path.join(d, "ckpt", f"step_{step}",
                                              "host0.npz"))
    t0 = time.perf_counter()
    snap = ckpt.restore(step, pi.leaf_spec(live.config), device=DEVICE)
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    t0 = time.perf_counter()
    replay = Dispatcher(snap, depth=0, max_span=MAX_SPAN)
    for r in read_wal(os.path.join(d, "wal")):
        if r.seq > step:
            replay.submit(record_window(r))
    torch.cuda.synchronize()
    t_replay = time.perf_counter() - t0
    assert same_state(replay.index, live)
    log(f"[durable] snapshots: initial {1e3 * run['t_init']:.6f} ms "
        f"(with opening the WAL), periodic {[round(1e3 * x, 6) for x in snaps]}"
        f" ms, {snap_bytes} B each (step {step}); recover "
        f"{1e3 * t_recover:.6f} ms for {len(tail)} replayed windows: load "
        f"{1e3 * t_load:.6f} ms, replay {1e3 * t_replay:.6f} ms (timed "
        f"apart)")
    meta_path = os.path.join(d, "durability.json")
    with open(meta_path) as f:
        meta = json.load(f)
    meta["config"]["backend"] = "xla"
    with open(meta_path, "w") as f:
        json.dump(meta, f)
    rec_t, _ = recover(d, device=DEVICE)
    assert rec_t.config.backend == "torch" and same_state(rec_t, live), \
        "torch-backend recover != the live state"
    log("[durable] crash-free: recover equals the live state bit for bit, "
        "on the cuda and on the torch backend, and so does a dispatcher "
        "without durability over the same windows")
    del rec, rec_t, snap, replay

    # 2. a crash at each fault point; 3. resume after the first
    for point in CRASH_POINTS:
        hit = 3 if point.startswith("wal.") else 2
        crash = drive_durable(idx_m, stream, B, d, crash=point, hit=hit)
        got = crash["sealed"]
        assert [w.qids for w in got] == [w.qids for w in sealed[:len(got)]]
        acked = crash["acked"][-1] if crash["acked"] else 0
        rec, tail = recover(d, device=DEVICE)
        step = CheckpointManager(os.path.join(d, "ckpt")).latest_step()
        n_applied = step + len(tail)
        assert acked <= n_applied <= len(got), (point, acked, n_applied)
        if point == "wal.mid_append":
            assert n_applied == acked, (point, acked, n_applied)
        if point.startswith("ckpt."):
            assert n_applied == acked == len(got), (point, acked, n_applied)
        assert same_state(rec, ref_states[n_applied]), point
        log(f"[durable] crash at {point} (pass {hit}): {len(got)} windows "
            f"sealed, {acked} acknowledged, snapshot {step} + "
            f"{len(tail)} replayed = {n_applied}; the state equals a "
            f"dispatcher without durability over those windows")
        if point != "wal.mid_append":
            continue
        start = sum(w.n_arrivals for w in got[:n_applied])
        dur = Durability(d, rec, fsync="per_window",
                         snapshot_every=SNAPSHOT_EVERY)
        assert dur.wal.last_seq == n_applied
        resumed = Dispatcher(rec, depth=1, max_span=MAX_SPAN, durability=dur)
        resumed.run(stream_from(stream, start), WindowConfig(batch=B))
        dur.close()
        assert same_state(resumed.index, live), "resumed run != crash-free"
        again, _ = recover(d, device=DEVICE)
        assert same_state(again, live)
        log(f"[durable] resumed after the crash at {point}: a new "
            f"Durability over the recovered index took arrivals {start}.."
            f"{n - 1} to the crash-free state, and recover after it too")
        del resumed, again
    shutil.rmtree(d)
    return launches


# ---------------------------------------------------------------------------
# the LM path: the flash kernel, prefill and decode, the LM server
# ---------------------------------------------------------------------------

def flash_bound(B, Sq, H, KV, D, causal=True, itemsize=2,
                ops_per_s=BF16_OPS_PER_S):
    """The least time of the attention forward: ``flash_hbm_bytes`` (q and
    out once, k and v once a head) over the HBM rate, against the
    multiply-adds of QK^T and PV that the causal mask leaves, 4 B H D
    Sq (Sq + 1) / 2 operations, over the rate of the kernel's arithmetic
    (the bfloat16 tensor cores; float32 outside them for the float32
    kernel).  Returns (ms, bound by, operations)."""
    from repro_torch.kernels.flash_attention import flash_hbm_bytes
    pairs = Sq * (Sq + 1) // 2 if causal else Sq * Sq
    ops = 4 * B * H * D * pairs
    return (*bound(flash_hbm_bytes(B, Sq, Sq, H, KV, D, D, itemsize), ops,
                   ops_per_s), ops)


def _flash_inputs(g, B, S, H, KV, D, dt, unaligned=False):
    """q, k, v from a seeded normal; ``unaligned``: views one element into
    their buffers, so that no base is 16-byte aligned."""
    out = []
    for heads in (H, KV, KV):
        n = B * S * heads * D
        x = torch.randn(n + unaligned, generator=g, device=DEVICE).to(dt)
        out.append(x[int(unaligned):].view(B, S, heads, D))
    return out


def check_flash(iters):
    """``[kernels:flash]``: the kernel against its plain version on the
    card at ``FLASH_CASES``; device times of the bfloat16 kernel at phi3's
    prefill shape and of the float32 kernel at the float32 case, beside
    their plain version, ``F.scaled_dot_product_attention`` on the same
    tensors and their bounds."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as FA
    g = torch.Generator(device=DEVICE).manual_seed(SEED + 2)
    err, out = 0.0, {}
    for name, (B, S, H, KV, D), dt, opts in FLASH_CASES:
        opts = dict(opts)
        q, k, v = _flash_inputs(g, B, S, H, KV, D, dt,
                                opts.pop("unaligned", False))
        got = FA.flash_attention_fwd(q, k, v, **opts)
        torch.cuda.synchronize()
        want = FA.flash_attention_fwd_plain(q, k, v, **opts)
        e, share = FA.card_error(got, want)
        atol, rtol = FA.CARD_TOL[dt]
        assert np.isfinite(e) and share <= 1.0, (name, e, share)
        err = max(err, e)
        log(f"[kernels:flash] {name} {(B, S, H, KV, D)} {dt}: max_abs_err "
            f"{e:.6g} (tolerance {atol:g} + {rtol:g} |plain|; the largest "
            f"error is {share:.4g} of its element's limit)")
        if name in ("phi3", "float32"):
            f32 = dt == torch.float32
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            timed = dict(
                ms=device_ms(lambda: FA.flash_attention_fwd(q, k, v), iters,
                             "flash_f32_kernel" if f32
                             else "flash_fwd_kernel"),
                plain_ms=device_ms(lambda: FA.flash_attention_fwd_plain(
                    q, k, v), max(1, iters // 10)),
                library_ms=device_ms(lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True, enable_gqa=True), iters),
                bound=flash_bound(B, S, H, KV, D, itemsize=q.element_size(),
                                  ops_per_s=SCALAR_OPS_PER_S if f32
                                  else BF16_OPS_PER_S))
            ms, bnd = timed["ms"], timed["bound"]
            log(f"[kernels:flash] {name} {(B, S, H, KV, D)} {dt}: kernel "
                f"{ms:.6f} ms ({bnd[2] / ms / 1e9:.1f} TFLOP/s), plain "
                f"{timed['plain_ms']:.6f} ms, scaled_dot_product_attention "
                f"{timed['library_ms']:.6f} ms; bound {bnd[0]:.6f} ms "
                f"({bnd[1]}, {bnd[2]:.4g} operations at "
                f"{(SCALAR_OPS_PER_S if f32 else BF16_OPS_PER_S) / 1e12:g} "
                f"TFLOP/s); the kernel at {100 * bnd[0] / ms:.2f}% of its "
                f"bound")
            if name == "phi3":
                out = timed
            else:
                out["f32"] = timed
        del q, k, v, got, want
    out["err"] = err
    return out


def time_split(fn, tag):
    """Device time of one ``fn()`` by kernel class, from the profiler (the
    flash kernel, the matrix products of cuBLAS, the rest), beside the
    host's time to enqueue it and its count of PyTorch operators."""
    dev, ops = device_events(fn, 1)
    total = sum(t for _, t, _ in dev) / 1e3
    cls = {"flash": 0.0, "matmul": 0.0, "other": 0.0}
    for name, t, _ in dev:
        low = name.lower()
        key = "flash" if "flash_fwd_kernel" in name else "matmul" if any(
            w in low for w in ("gemm", "gemv", "nvjet", "xmma", "cutlass")) \
            else "other"
        cls[key] += t / 1e3
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    enqueue = time.perf_counter() - t0
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n_ops = sum(c for name, _, c in ops if name.startswith("aten::"))
    log(f"[lm] {tag} device time {total:.6f} ms: " + ", ".join(
        f"{k} {v:.6f} ms ({100 * v / total:.2f}%)" for k, v in cls.items())
        + f"; unprofiled: host enqueue {1e3 * enqueue:.6f} ms, wall "
        f"{1e3 * wall:.6f} ms; {n_ops} aten operator calls")
    for name, t, count in sorted(dev, key=lambda r: -r[1])[:6]:
        log(f"[lm] {tag}   {t / 1e3:10.6f} ms ({count}x) {name[:90]}")
    return total, cls


def run_lm():
    """``[lm]``: phi3-mini-3.8b at full width (see the module docstring).
    Returns the launch counts of its prefill and forward, and its
    numbers."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import (cast_floats, forward, init_params,
                                    make_decode_step, make_prefill_step,
                                    model_layout)
    from repro_torch.models import decode as dec
    from repro_torch.models.base import tree_leaves
    cfg = get_config(LM_ARCH)
    rng = np.random.default_rng(SEED)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    params32 = init_params(model_layout(cfg), gen, cfg.param_dtype)
    params = cast_floats(params32, cfg.compute_dtype)   # once, up front
    torch.cuda.synchronize()
    n_params = sum(x.numel() for x in tree_leaves(params))
    log(f"[lm] {LM_ARCH}: {cfg.n_layers} layers, d {cfg.d_model}, "
        f"{cfg.n_heads} heads ({cfg.n_kv} KV) of {cfg.hd}, d_ff {cfg.d_ff}, "
        f"vocab {cfg.vocab} ({cfg.vocab_padded} padded); {n_params} "
        f"parameters made and cast to {cfg.compute_dtype} in "
        f"{time.perf_counter() - t0:.3f} s")
    assert n_params == LM_PARAMS, n_params

    def toks(b, s):
        return torch.from_numpy(rng.integers(0, cfg.vocab, (b, s))
                                .astype(np.int32)).to(DEVICE)

    prefill = make_prefill_step(cfg, total_len=PREFILL_S + DECODE_STEPS)
    prefill(params, {"tokens": toks(1, 128)})          # warm-up
    tokens = toks(PREFILL_B, PREFILL_S)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    logits, cache = prefill(params, {"tokens": tokens})
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    launches = launch_counts()
    assert launches["flash_attention_fwd"] == cfg.n_layers, launches
    assert logits.shape == (PREFILL_B, 1, cfg.vocab_padded)
    assert torch.isfinite(logits).all()
    assert cache["k"].shape == (cfg.n_layers, PREFILL_B,
                                PREFILL_S + DECODE_STEPS, cfg.n_kv, cfg.hd)

    decode = make_decode_step(cfg)
    tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
    steps = []
    for i in range(DECODE_STEPS):
        t0 = time.perf_counter()
        tok, dl, cache = decode(params, {"cache": cache,
                                         "tokens": tok[:, None],
                                         "idx": PREFILL_S + i})
        torch.cuda.synchronize()
        steps.append(time.perf_counter() - t0)
        assert torch.isfinite(dl).all()
    assert int(cache["pos"][0, -1]) == PREFILL_S + DECODE_STEPS - 1
    steps = np.array(steps) * 1e3
    peak = torch.cuda.max_memory_allocated()
    log(f"[lm] prefill {PREFILL_B} x {PREFILL_S} tokens: "
        f"{1e3 * t_prefill:.6f} ms ({PREFILL_B * PREFILL_S / t_prefill:.1f} "
        f"tokens/s), flash kernel launches {launches['flash_attention_fwd']}"
        f"; {DECODE_STEPS} greedy decode steps at batch {PREFILL_B}: p50 "
        f"{np.percentile(steps, 50):.6f} ms, p99 "
        f"{np.percentile(steps, 99):.6f} ms; peak device memory "
        f"{peak / 2**30:.3f} GiB")
    split_prefill = time_split(lambda: prefill(params, {"tokens": tokens}),
                               "prefill")
    split_decode = time_split(lambda: decode(params, {
        "cache": cache, "tokens": tok[:, None],
        "idx": PREFILL_S + DECODE_STEPS - 1}), "decode step")
    del cache, logits

    reset_launches()
    fl, _ = forward(cfg, params, tokens=toks(1, 256))
    torch.cuda.synchronize()
    fwd = launch_counts()["flash_attention_fwd"]
    assert fwd == cfg.n_layers and torch.isfinite(fl).all(), fwd
    del fl

    # the model in float32: prefill (the kernel) against token-by-token
    # decode (plain einsums over the cache)
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    tokens = toks(CHECK_B, CHECK_S)
    pl, pcache = make_prefill_step(cfg32)(params32, {"tokens": tokens})
    dcache = dec.init_cache(cfg32, CHECK_B, CHECK_S, device=DEVICE)
    step32 = make_decode_step(cfg32)
    for t in range(CHECK_S):
        _, dl, dcache = step32(params32, {"cache": dcache,
                                          "tokens": tokens[:, t:t + 1],
                                          "idx": t})
    torch.cuda.synchronize()
    real = slice(0, cfg.vocab)           # the padding logits are -1e30
    errs = {"logits": (pl[..., real] - dl[..., real]).abs().max().item()}
    scale = {"logits": dl[..., real].abs().max().item()}
    for name in ("k", "v"):
        errs[name] = (pcache[name] - dcache[name]).abs().max().item()
        scale[name] = dcache[name].abs().max().item()
    assert torch.equal(pcache["pos"], dcache["pos"])
    rel = 1e-3       # float32 products of another order, 32 layers deep
    for name, e in errs.items():
        tol = rel * max(1.0, scale[name])
        log(f"[lm] float32 prefill vs {CHECK_S} decode steps, {name}: "
            f"max_abs_err {e:.6g} (tolerance {tol:.6g} = {rel} x "
            f"max(1, max |decode| = {scale[name]:.6g}))")
        assert np.isfinite(e) and e <= tol, (name, e, tol)
    del params32, pcache, dcache
    return dict(launches=launches, params=params, cfg=cfg,
                t_prefill=t_prefill, steps=steps, peak=peak,
                split_prefill=split_prefill, split_decode=split_decode)


def run_serve_lm(cfg, params):
    """``[serve:lm]``: the LM server at full width (see the module
    docstring).  Returns its launch counts."""
    from repro_torch.launch.serve import Request, Server
    from repro_torch.pipeline import recover
    rng = np.random.default_rng(SEED + 3)
    shutil.rmtree(SERVE_DIR, ignore_errors=True)
    srv = Server(cfg, params, n_slots=8, max_len=128, index_backend="cuda",
                 wal_dir=SERVE_DIR, device=DEVICE)
    waiting = [Request(rid=1000 + 7 * i, prompt=rng.integers(
        0, cfg.vocab, int(rng.integers(16, 49))), max_new=16)
        for i in range(SERVE_REQUESTS)]
    reqs = list(waiting)
    torch.cuda.synchronize()
    reset_launches()
    srv.pipeline_metrics.start(time.perf_counter())
    t0 = time.perf_counter()
    ticks = ranges = 0
    while waiting or srv.live:
        if waiting and srv.free:
            n = srv.admit(waiting[:len(srv.free)])
            waiting = waiting[n:]
        srv.tick()
        ticks += 1
        if ticks in (3, 20):     # mid-run: the table against the host
            lo, hi = 1000 + 7 * 2, 1000 + 7 * 11
            want = [(r, s) for r, s in srv.slot_of.items() if lo <= r <= hi]
            got = srv.session_range(lo, hi)
            assert got == (len(want), sum(s for _, s in want)), (got, want)
            ranges += 1
        assert ticks < 1000, "the server did not drain"
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    srv.pipeline_metrics.stop(time.perf_counter())
    launches = launch_counts()
    summary = srv.pipeline_metrics.summary()
    assert all(len(r.out) == r.max_new for r in reqs)
    assert all(0 <= t < cfg.vocab for r in reqs for t in r.out)
    assert int(srv.table.live_count) == 0 and ranges == 2
    assert launches["pi_probe"] == launches["bitonic_sort"] == \
        summary["windows"], (launches, summary["windows"])
    assert launches["pi_range"] == ranges, launches
    srv.close()
    rec, tail = recover(SERVE_DIR, device=DEVICE)
    assert same_state(rec, srv.table), "recovered table != live table"
    n_new = sum(len(r.out) for r in reqs)
    n_prompt = sum(len(r.prompt) for r in reqs)
    log(f"[serve:lm] {len(reqs)} requests ({n_prompt} prompt tokens, each "
        f"a decode step over the 8 slots, and {n_new} new tokens) in "
        f"{ticks} ticks, {wall:.6f} s: {len(reqs) / wall:.6f} requests/s, "
        f"{n_new / wall:.6f} new tokens/s, {(n_new + n_prompt) / wall:.6f} "
        f"tokens/s with the prompts; session table: {summary['windows']} "
        f"windows, {srv.queries_processed} index queries, p50 "
        f"{summary['p50_ms']:.6f} ms, p99 {summary['p99_ms']:.6f} ms; "
        f"session_range twice against the host; recover replayed "
        f"{len(tail)} windows to the live table bit for bit; kernel "
        f"launches {launches}")
    shutil.rmtree(SERVE_DIR)
    return launches


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", type=int, default=0, metavar="WINDOWS",
                    help="also profile this many windows (off: 0)")
    args = ap.parse_args(argv)

    if DEVICE == "cuda" and not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a card",
              file=sys.stderr)
        return 2

    from repro_torch import core as pi
    from repro_torch import data
    from repro_torch.kernels import build as kbuild

    # -- 1. build --------------------------------------------------------
    t_start = t0 = time.perf_counter()
    kbuild.build()
    log(f"[build] kernels built/loaded in {time.perf_counter() - t0:.3f} s "
        f"into {kbuild.BUILD_DIR}")
    ptxas = "".join(kbuild.build_log(name) for name in kbuild.SIGNATURES)
    regs = [int(w) for w in re.findall(r"Used (\d+) registers", ptxas)]
    spills = re.findall(r"(\d+) bytes spill stores", ptxas)
    log(f"[build] {len(regs)} kernel instantiations, at most "
        f"{max(regs, default=0)} registers a thread, spill stores "
        f"{sorted(set(spills)) or 'not reported'}")
    card = card_line()
    log(f"[card] {card}")
    n_keys = N_KEYS
    ycfg = data.YCSBConfig(n_keys=n_keys, key_space=1 << 30, batch=8192,
                           write_ratio=0.5, theta=0.9, seed=SEED)
    cfg = pi.PIConfig(capacity=2 * n_keys,
                      pending_capacity=max(8192 * 4, n_keys // 4),
                      fanout=8, backend="cuda")
    t0 = time.perf_counter()
    keys_np, vals_np = data.ycsb_dataset(ycfg)
    t_data = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    idx0 = pi.build(cfg, keys_np, vals_np, device=DEVICE)
    torch.cuda.synchronize()
    log(f"[index] n={n_keys} C={cfg.capacity} PC={cfg.pending_capacity} "
        f"F={cfg.fanout} W={cfg.seg_width_eff} S={cfg.num_segments} "
        f"H={cfg.num_levels} D={cfg.max_dirty}; data {t_data:.3f} s, "
        f"build {time.perf_counter() - t0:.3f} s, "
        f"{torch.cuda.memory_allocated() / 2**20:.1f} MiB on the card")

    # -- 2. kernels against their plain versions -------------------------
    rng = np.random.default_rng(SEED + 1)
    fresh = rng.integers(0, ycfg.key_space, cfg.pending_capacity // 4) \
        .astype(np.int32)
    q = mixed_queries(rng, keys_np, fresh, ycfg.batch, ycfg.key_space)
    window_keys = torch.from_numpy(data.ycsb_batch(ycfg, keys_np, 0)[1])
    window_keys = window_keys.to(DEVICE)
    check_kernels(idx0, q, window_keys, "fresh", ITERS)
    log(f"[time] {time.perf_counter() - t_start:.3f} s since the start")
    filled, _ = pi.insert_batch(idx0, torch.from_numpy(fresh).to(DEVICE),
                                torch.from_numpy(fresh).to(DEVICE))
    q = mixed_queries(rng, keys_np, fresh, ycfg.batch, ycfg.key_space)
    timing = check_kernels(filled, q, window_keys, "pending-filled", ITERS)
    log(f"[time] {time.perf_counter() - t_start:.3f} s since the start")
    lo, hi = range_queries(rng, keys_np, ycfg.batch, ycfg.key_space)
    range_fresh = check_range_kernel(idx0, lo, hi, "fresh", ITERS)
    log(f"[time] {time.perf_counter() - t_start:.3f} s since the start")
    dead = np.concatenate([rng.choice(keys_np, ycfg.batch // 2),
                           rng.choice(fresh, ycfg.batch // 2)])
    filled, _ = pi.delete_batch(filled, torch.from_numpy(dead).to(DEVICE))
    lo, hi = range_queries(rng, keys_np, ycfg.batch, ycfg.key_space)
    range_timing = check_range_kernel(filled, lo, hi, "pending-filled+deletes",
                                      ITERS)
    assert range_fresh["budget"] > 0 and range_timing["budget"] > 0, \
        "no check lane spends the walk's budget"
    lo, hi = ycsb_e_lanes(ycfg, keys_np, SEED + 5)
    range_ycsb = check_range_kernel(idx0, lo, hi, "ycsb-e window, fresh",
                                    ITERS)
    range_ycsb_p = check_range_kernel(
        filled, lo, hi, "ycsb-e window, pending-filled+deletes", ITERS)
    del filled
    log(f"[time] {time.perf_counter() - t_start:.3f} s since the start")
    bitonic = check_bitonic(rng, window_keys, ITERS)
    log(f"[time] {time.perf_counter() - t_start:.3f} s since the start")

    # -- 3. the main path -------------------------------------------------
    batches_np = [data.ycsb_batch(ycfg, keys_np, w)
                  for w in range(WINDOWS)]
    batches = [tuple(torch.from_numpy(a).to(DEVICE) for a in b)
               for b in batches_np]
    lookup_np = np.concatenate([
        rng.choice(keys_np, ycfg.batch // 2),
        rng.integers(-5, ycfg.key_space, ycfg.batch // 2)]).astype(np.int32)
    lookup_q = torch.from_numpy(lookup_np).to(DEVICE)

    for backend in ("cuda", "torch"):   # warm-up: first-call costs
        run_main_path(pi.with_backend(idx0, backend), batches[:2], lookup_q)

    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    run_cuda = run_main_path(idx0, batches, lookup_q)
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    summarize("cuda", run_cuda, ycfg.batch)
    log(f"[main:cuda] kernel launches {launches}; peak device memory "
        f"{peak / 2**20:.1f} MiB")
    assert run_cuda["incremental"], "rebuild after the windows: not incremental"

    t0 = time.perf_counter()
    order = np.argsort(keys_np)
    base = (dict(zip(keys_np.tolist(), vals_np.tolist())),
            keys_np[order].astype(np.int64), vals_np[order].astype(np.int64))
    ref = pi.RefIndex(dict(base[0]))
    check_against_ref(ref, batches_np, run_cuda, lookup_np)
    del ref
    log(f"[main:cuda] {WINDOWS} windows x {ycfg.batch} ops, both "
        f"rebuild tiers, lookup and traverse agree with RefIndex "
        f"(checked in {time.perf_counter() - t0:.3f} s)")

    run_torch = run_main_path(pi.with_backend(idx0, "torch"), batches,
                              lookup_q)
    summarize("torch", run_torch, ycfg.batch)
    for w, (a, b) in enumerate(zip(run_cuda["outs"], run_torch["outs"])):
        assert all(np.array_equal(x, y) for x, y in zip(a, b)), \
            f"window {w}: cuda and torch backends differ"
    for name, a, b in zip(("windows", "rebuild", "repack"),
                          run_cuda["states"], run_torch["states"]):
        assert same_state(a, b), f"state after {name}: backends differ"
    assert all(torch.equal(a, b) for a, b in zip(run_cuda["reads"],
                                                  run_torch["reads"]))
    log("[main] cuda and torch backends bit-identical: every window's "
        "results and flags, the states after the windows, the rebuild and "
        "the repack, and the reads")

    if args.profile:
        extra = [tuple(torch.from_numpy(a).to(DEVICE)
                       for a in data.ycsb_batch(ycfg, keys_np, w))
                 for w in range(WINDOWS, WINDOWS + args.profile)]
        profile_windows(run_cuda["states"][0], extra,
                        1e3 * run_cuda["t_windows"] / WINDOWS)

    del run_cuda, run_torch, batches
    log(f"[time] {time.perf_counter() - t_start:.3f} s since the start")

    # -- 4. the serving path ----------------------------------------------
    idx_m, mixed = mixed_setup(cfg, keys_np, vals_np, ycfg)
    serve_launches = run_serving(args, idx0, keys_np, ycfg, base, idx_m,
                                 mixed)
    log(f"[time] {time.perf_counter() - t_start:.3f} s since the start")

    # -- 5. the durable path ----------------------------------------------
    durable_launches = run_durable(idx_m, mixed, ycfg.batch)
    log(f"[time] {time.perf_counter() - t_start:.3f} s since the start")

    # -- 6. the flash kernel against its plain version --------------------
    flash = check_flash(ITERS)
    log(f"[time] {time.perf_counter() - t_start:.3f} s since the start")

    # -- 7. the LM path: prefill and decode at full width ------------------
    lm = run_lm()
    log(f"[time] {time.perf_counter() - t_start:.3f} s since the start")

    # -- 8. the LM server ---------------------------------------------------
    serve_lm_launches = run_serve_lm(lm["cfg"], lm["params"])
    lm_launches = lm["launches"]
    del lm
    log(f"[time] {time.perf_counter() - t_start:.3f} s since the start")

    # -- 9. launch counts -------------------------------------------------
    assert launches["pi_probe"] >= WINDOWS, launches
    assert launches["bitonic_sort"] == WINDOWS, launches
    assert launches["pi_search"] >= 1, launches
    paths = (launches, serve_launches, durable_launches, lm_launches,
             serve_lm_launches)

    def total(name):
        return sum(p[name] for p in paths)

    src = "src/repro_torch/kernels/csrc/pi_search.cu"
    kernels = [
        dict(name="pi_probe", route="cuda", source=src,
             replaces="src/repro/kernels/pi_search.py:309",
             launches=total("pi_probe"),
             max_abs_err=timing["probe_err"], ms=timing["probe_ms"],
             plain_ms=timing["probe_plain_ms"],
             bound_ms=timing["probe_bound"][0],
             bound_by=timing["probe_bound"][1], library_ms=None,
             searchsorted_pending_ms=timing["searchsorted_pending_ms"]),
        dict(name="pi_search", route="cuda", source=src,
             replaces="src/repro/kernels/pi_search.py:263",
             launches=launches["pi_search"],
             max_abs_err=timing["search_err"], ms=timing["search_ms"],
             plain_ms=timing["search_plain_ms"],
             bound_ms=timing["search_bound"][0],
             bound_by=timing["search_bound"][1], library_ms=None),
        dict(name="pi_range", route="cuda",
             source="src/repro_torch/kernels/csrc/pi_range.cu",
             replaces="src/repro/kernels/pi_range.py:112",
             launches=total("pi_range"),
             max_abs_err=max(range_fresh["err"], range_timing["err"],
                             range_ycsb["err"], range_ycsb_p["err"]),
             ms=range_timing["ms"], plain_ms=range_timing["plain_ms"],
             bound_ms=range_timing["bound"][0],
             bound_by=range_timing["bound"][1], library_ms=None),
        dict(name="bitonic_sort", route="cuda",
             source="src/repro_torch/kernels/csrc/bitonic_sort.cu",
             replaces="src/repro/kernels/bitonic_sort.py:55",
             launches=total("bitonic_sort"), max_abs_err=bitonic["err"],
             ms=bitonic["ms"], plain_ms=bitonic["plain_ms"],
             bound_ms=bitonic["bound"][0], bound_by=bitonic["bound"][1],
             library_ms=bitonic["library_ms"]),
        dict(name="flash_attention_fwd", route="cuda",
             source="src/repro_torch/kernels/csrc/flash_attention.cu",
             replaces="src/repro/kernels/flash_attention.py:77",
             launches=total("flash_attention_fwd"), max_abs_err=flash["err"],
             ms=flash["ms"], plain_ms=flash["plain_ms"],
             bound_ms=flash["bound"][0], bound_by=flash["bound"][1],
             library_ms=flash["library_ms"]),
    ]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
