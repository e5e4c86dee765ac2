#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port of PI (``src/repro_torch``).

Run from the root of a checkout, on a machine with one CUDA card:

    python3 chip_smoke.py

It builds the CUDA kernels from ``src/repro_torch/kernels/csrc`` and drives
one PI shard's point-op path at a real data size: 2^24 YCSB keys over a
2^30 key space, capacity 2^25, pending capacity 2^22, fanout 8, windows of
8192 operations (write ratio 0.5, zipf theta 0.9).  Phases:

1. build the kernels and the index; print the card's name and power limit;
2. hold each kernel against its plain PyTorch version on the card, bit for
   bit, at the main path's shapes, and time both with CUDA events;
3. run the main path — windows through ``step_single``, a two-tier
   ``rebuild`` (incremental), a ``repack``, then ``lookup`` and
   ``traverse`` — with the ``cuda`` backend, check every result against
   the ``RefIndex`` oracle, and run the same sequence again with the
   ``torch`` backend, which must agree bit for bit;
4. check that the main path launched every kernel.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.  Any failed check raises,
so the script exits non-zero and prints no result; so does a machine
without a CUDA card, or a directory without the rest of the repository.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

# H100 SXM peaks (NVIDIA data sheet): HBM bandwidth, and the non-tensor
# float32 rate, taken as the rate of the int32 compares these kernels do.
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12

DEVICE = "cuda"
N_KEYS = 1 << 24     # YCSB dataset size (paper: 2M..256M)
WINDOWS = 32         # windows of 8192 operations on the main path
ITERS = 200          # launches a kernel is timed over (plain version: 1/10)
SEED = 0


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


def device_events(fn, iters: int):
    """The device-side events (kernels, copies) of ``iters`` calls of
    ``fn``, from ``torch.profiler``, and the CPU-side operators:
    ([(name, self device us, count)], [(operator, self device us, count)])."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
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
    dev, _ = device_events(fn, iters)
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


def lower_bound_touch(pending, q):
    """(distinct pending bytes read by the branchless lower bound, compares)."""
    from repro_torch.kernels.pi_search import gather_fill, sentinel_for
    n = pending.numel()
    sent = sentinel_for(pending.dtype)
    p2 = 1 << max(0, (n - 1).bit_length())
    count = torch.zeros_like(q, dtype=torch.int64)
    read = []
    step = p2 >> 1
    while step:
        cand = count + step
        read.append(cand - 1)
        count = torch.where(gather_fill(pending, cand - 1, sent) < q, cand,
                            count)
        step >>= 1
    read.append(count)
    ppos = count + (gather_fill(pending, count, sent) < q)
    read.append(ppos.clamp_max(n - 1))
    return 4 * _unique(torch.cat(read), n), q.numel() * (len(read) + 1)


def bound(nbytes: int, ops: int):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / SCALAR_OPS_PER_S * 1e3
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


def check_kernels(idx, q, tag, iters):
    """Each kernel against its plain version at these shapes; timings."""
    from repro_torch.kernels import pi_search as K
    F = idx.config.fanout
    lv, st, pk = idx.levels, idx.keys, idx.pkeys

    def probe():
        return K.pi_probe(st, pk, q, fanout=F, levels=lv)

    def probe_plain():
        return K.pi_probe_plain(st, pk, q, fanout=F, levels=lv)

    def search():
        return K.pi_search(st, q, fanout=F, levels=lv)

    def search_plain():
        return K.pi_search_plain(st, q, fanout=F, levels=lv)

    got, want = probe(), probe_plain()
    s_got, s_want = search(), search_plain()
    # float32 keys: the kernel's second instantiation, on the cast keys
    stf, qf = st.float(), q.float()
    lvf = tuple(x.float() for x in lv)
    f_got = K.pi_search(stf, qf, fanout=F, levels=lvf)
    f_want = K.pi_search_plain(stf, qf, fanout=F, levels=lvf)
    torch.cuda.synchronize()
    probe_err = max(int((a.long() - b.long()).abs().max())
                    for a, b in zip(got, want))
    search_err = int((s_got.long() - s_want.long()).abs().max())
    for name, a, b in zip(("mpos", "ppos", "flags"), got, want):
        assert torch.equal(a, b), f"pi_probe {name} != plain ({tag})"
    assert torch.equal(s_got, s_want), f"pi_search != plain ({tag})"
    assert torch.equal(f_got, f_want), f"pi_search f32 != plain ({tag})"
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
        probe_one_query_ms=device_ms(
            lambda: K.pi_probe(st, pk, q[:1], fanout=F, levels=lv), iters,
            "pi_probe_kernel"),
        searchsorted_pending_ms=device_ms(
            lambda: torch.searchsorted(pk, q), iters))
    log(f"[kernels:{tag}] B={B} pn={int(idx.pn)} main hits={hits} "
        f"pending hits={p_hits} max_abs_err probe {probe_err} search "
        f"{search_err}; {d_bytes + p_bytes} B of keys touched")
    for name in ("probe", "search"):
        b = probe_bound if name == "probe" else search_bound
        log(f"[kernels:{tag}] pi_{name}: device {t[name + '_ms']:.6f} ms "
            f"(per call with the host's launch {t[name + '_call_ms']:.6f}"
            f" ms) | plain version device {t[name + '_plain_ms']:.6f} ms "
            f"(per call {t[name + '_plain_call_ms']:.6f} ms) | bound "
            f"{b[0]:.6f} ms by {b[1]}")
    log(f"[kernels:{tag}] pi_probe of one query: device "
        f"{t['probe_one_query_ms']:.6f} ms | partial yardstick "
        f"searchsorted(pending): device "
        f"{t['searchsorted_pending_ms']:.6f} ms")
    return dict(t, probe_err=probe_err, search_err=search_err,
                probe_bound=probe_bound, search_bound=search_bound)


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
    from repro_torch.kernels import pi_search as K

    # -- 1. build --------------------------------------------------------
    t0 = time.perf_counter()
    kbuild.build()
    log(f"[build] kernels built/loaded in {time.perf_counter() - t0:.3f} s "
        f"into {kbuild.BUILD_DIR}")
    ptxas = kbuild.build_log("pi_search")
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
    check_kernels(idx0, q, "fresh", ITERS)
    filled, _ = pi.insert_batch(idx0, torch.from_numpy(fresh).to(DEVICE),
                                torch.from_numpy(fresh).to(DEVICE))
    q = mixed_queries(rng, keys_np, fresh, ycfg.batch, ycfg.key_space)
    timing = check_kernels(filled, q, "pending-filled", ITERS)
    del filled

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

    K.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    run_cuda = run_main_path(idx0, batches, lookup_q)
    launches = dict(K.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    summarize("cuda", run_cuda, ycfg.batch)
    log(f"[main:cuda] kernel launches {launches}; peak device memory "
        f"{peak / 2**20:.1f} MiB")
    assert run_cuda["incremental"], "rebuild after the windows: not incremental"

    t0 = time.perf_counter()
    ref = pi.RefIndex(dict(zip(keys_np.tolist(), vals_np.tolist())))
    check_against_ref(ref, batches_np, run_cuda, lookup_np)
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

    # -- 4. launch counts -------------------------------------------------
    assert launches["pi_probe"] >= WINDOWS, launches
    assert launches["pi_search"] >= 1, launches

    src = "src/repro_torch/kernels/csrc/pi_search.cu"
    kernels = [
        dict(name="pi_probe", route="cuda", source=src,
             replaces="src/repro/kernels/pi_search.py:309",
             launches=launches["pi_probe"],
             max_abs_err=timing["probe_err"], ms=timing["probe_ms"],
             plain_ms=timing["probe_plain_ms"],
             bound_ms=timing["probe_bound"][0],
             bound_by=timing["probe_bound"][1], library_ms=None),
        dict(name="pi_search", route="cuda", source=src,
             replaces="src/repro/kernels/pi_search.py:263",
             launches=launches["pi_search"],
             max_abs_err=timing["search_err"], ms=timing["search_ms"],
             plain_ms=timing["search_plain_ms"],
             bound_ms=timing["search_bound"][0],
             bound_by=timing["search_bound"][1], library_ms=None),
    ]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
