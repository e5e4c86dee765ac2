"""Device time of the ``pi_probe`` and ``pi_search`` kernels by group size,
on one CUDA card.

    PYTHONPATH=src python scripts/probe_study.py [--groups 8 16]

Builds the index of ``chip_smoke.py`` (2^24 YCSB keys over a 2^30 key
space, capacity 2^25, pending capacity 2^22, fanout 8), fresh and with a
quarter of its pending buffer filled, and two lane sets of 8192 queries:
``chip_smoke.mixed_queries`` (stored keys, duplicates, misses, keys below
the minimum, sentinels, in random order) and one window's keys sorted, as
``execute`` probes them.  Each variant sets the lanes a query
(``PI_PROBE_GROUP`` of ``csrc/pi_search.cu``: 8, 16, 32; ``--groups``
picks them), is built by nvcc into ``build/kernels/`` (all builds at
once), held to ``pi_probe_plain`` / ``pi_search_plain`` bit for bit on
every index and lane set, and timed: both kernels' device time on each
(``torch.profiler``, 200 launches), one query's probe (the chain's
latency) and 132, 1024 and 4096 queries, beside ptxas's registers and
stack.  It also prints an empty kernel's time and the card's name and
power limit.
"""
import argparse
import ctypes
import os
import re
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

import chip_smoke as CS  # noqa: E402
from repro_torch import core as pi  # noqa: E402
from repro_torch import data  # noqa: E402
from repro_torch.kernels import build as kbuild  # noqa: E402
from repro_torch.kernels import pi_search as K  # noqa: E402

GROUPS = (8, 16, 32)
SCALING = (1, 132, 1024, 4096)   # batch sizes of the pi_probe scaling line


def variant_source(group):
    src = (kbuild.CSRC / "pi_search.cu").read_text()
    src, n = re.subn(r"#define PI_PROBE_GROUP \d+",
                     f"#define PI_PROBE_GROUP {group}", src)
    assert n == 1
    return src


def build_variants(groups):
    """Build every variant at once; {group: (library, ptxas summary)}."""
    kbuild.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for g in groups:
        cu = kbuild.BUILD_DIR / f"pi_search_g{g}.cu"
        cu.write_text(variant_source(g))
        so = cu.with_suffix(".so")
        jobs[g] = so, subprocess.Popen(
            [kbuild.nvcc(), *kbuild.NVCC_FLAGS, "-I", str(kbuild.CSRC), "-o",
             str(so), str(cu)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
    out = {}
    for g, (so, proc) in jobs.items():
        log, _ = proc.communicate()
        assert proc.returncode == 0, log
        lib = ctypes.CDLL(str(so))
        for fn, argtypes in kbuild.SIGNATURES["pi_search"].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        out[g] = lib, ptxas_summary(log)
    return out


def ptxas_summary(log):
    """Registers and stack of the int32 probe kernel at F = 8."""
    blocks = log.split("Compiling entry function")
    for b in blocks:
        if "pi_probe_kernelIiLi8E" in b:
            regs = re.search(r"Used (\d+) registers", b)
            stack = re.search(r"(\d+) bytes stack frame", b)
            return (f"{regs.group(1) if regs else '?'} registers, "
                    f"{stack.group(1) if stack else '?'} B stack")
    return "not reported"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--groups", type=int, nargs="+", default=GROUPS,
                    help="group sizes to build (default: 8 16 32)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("probe_study: needs a CUDA card", file=sys.stderr)
        return 2
    print(CS.card_line(), flush=True)
    libs = build_variants(args.groups)
    ycfg = data.YCSBConfig(n_keys=CS.N_KEYS, key_space=1 << 30, batch=8192,
                           write_ratio=0.5, theta=0.9, seed=CS.SEED)
    cfg = pi.PIConfig(capacity=2 * CS.N_KEYS,
                      pending_capacity=max(8192 * 4, CS.N_KEYS // 4),
                      fanout=8, backend="cuda")
    keys_np, vals_np = data.ycsb_dataset(ycfg)
    idx0 = pi.build(cfg, keys_np, vals_np, device="cuda")
    rng = np.random.default_rng(CS.SEED + 1)
    fresh = rng.integers(0, ycfg.key_space, cfg.pending_capacity // 4) \
        .astype(np.int32)
    filled, _ = pi.insert_batch(idx0, torch.from_numpy(fresh).cuda(),
                                torch.from_numpy(fresh).cuda())
    mixed = CS.mixed_queries(rng, keys_np, fresh, ycfg.batch, ycfg.key_space)
    window = torch.from_numpy(data.ycsb_batch(ycfg, keys_np, 0)[1]).cuda()
    cases = {}
    for itag, idx in (("fresh", idx0), ("pending-filled", filled)):
        for ltag, q in (("mixed", mixed), ("sorted window",
                                           torch.sort(window).values)):
            inputs = (idx.keys, idx.pkeys, q)
            kw = dict(fanout=8, levels=idx.levels)
            cases[f"{itag}, {ltag}"] = (
                inputs, kw, K.pi_probe_plain(*inputs, **kw),
                K.pi_search_plain(idx.keys, q, **kw))
    print(f"empty kernel: device {CS.empty_kernel_ms(200):.6f} ms",
          flush=True)
    load = K.load_library
    try:
        for g in args.groups:
            lib, ptxas = libs[g]
            K.load_library = lambda name: lib
            name = f"G={g}"
            for tag, (inputs, kw, want_p, want_s) in cases.items():
                st, pk, q = inputs

                def probe():
                    return K.pi_probe(st, pk, q, **kw)

                def search():
                    return K.pi_search(st, q, **kw)
                got_p, got_s = probe(), search()
                torch.cuda.synchronize()
                assert all(torch.equal(a, b) for a, b in zip(got_p, want_p)), \
                    (name, tag, "probe")
                assert torch.equal(got_s, want_s), (name, tag, "search")
                p_ms = CS.device_ms(probe, 200, "pi_probe_kernel")
                s_ms = CS.device_ms(search, 200, "pi_search_kernel")
                print(f"{name}: {tag}: pi_probe {p_ms:.6f} ms, pi_search "
                      f"{s_ms:.6f} ms, equal to the plain versions",
                      flush=True)
            st, pk, q = cases["pending-filled, mixed"][0]
            by_b = {}
            for b in SCALING:
                by_b[b] = CS.device_ms(
                    lambda: K.pi_probe(st, pk, q[:b], fanout=8,
                                       levels=filled.levels), 200,
                    "pi_probe_kernel")
            print(f"{name}: one query's pi_probe {by_b[1]:.6f} ms; "
                  + ", ".join(f"{b} queries {ms:.6f} ms"
                              for b, ms in by_b.items() if b > 1)
                  + f"; ptxas (int32 probe, F = 8): {ptxas}", flush=True)
    finally:
        K.load_library = load
    return 0


if __name__ == "__main__":
    sys.exit(main())
