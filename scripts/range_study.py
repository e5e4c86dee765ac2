"""Device time of the ``pi_range`` kernel by group size and walk unroll, on
one CUDA card.

    PYTHONPATH=src python scripts/range_study.py

Builds the index of ``chip_smoke.py`` (2^24 YCSB keys over a 2^30 key
space, capacity 2^25, pending capacity 2^22, fanout 8) and two lane sets:
``chip_smoke.range_queries`` (8192 lanes: YCSB-E scans, empty and inert
lanes, 256 ranges past the 1024-rank budget) and one window of the YCSB-E
stream (``chip_smoke.ycsb_e_lanes``).  For each walk unroll (rounds of G
ranks a walk step reads: ``PI_RANGE_UNROLL``) and each group size (lanes a
query: ``PI_RANGE_GROUP``) -- constants of ``csrc/pi_range.cu``, edited
into a variant built by nvcc into ``build/kernels/`` -- it checks the
kernel against ``pi_range_plain`` bit for bit and prints its device time
(``torch.profiler``, 200 launches), and the card's name and power limit.
"""
import ctypes
import itertools
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
from repro_torch.core.engine import range_tables  # noqa: E402
from repro_torch.kernels import build as kbuild  # noqa: E402
from repro_torch.kernels import pi_range as KR  # noqa: E402

UNROLLS = (1, 2, 4)
GROUPS = (8, 16, 32)


def variant_library(unroll, group):
    """``csrc/pi_range.cu`` with ``PI_RANGE_UNROLL`` set to ``unroll`` and
    ``PI_RANGE_GROUP`` to ``group``, built by nvcc and loaded with the
    wrapper's argument types."""
    src = (kbuild.CSRC / "pi_range.cu").read_text()
    for name, value in (("UNROLL", unroll), ("GROUP", group)):
        src, n = re.subn(rf"#define PI_RANGE_{name} \d+",
                         f"#define PI_RANGE_{name} {value}", src)
        assert n == 1, name
    cu = kbuild.BUILD_DIR / f"pi_range_unroll{unroll}_group{group}.cu"
    so = cu.with_suffix(".so")
    kbuild.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu.write_text(src)
    subprocess.run([kbuild.nvcc(), *kbuild.NVCC_FLAGS, "-I",
                    str(kbuild.CSRC), "-o", str(so), str(cu)], check=True,
                   capture_output=True)
    lib = ctypes.CDLL(str(so))
    for fn, argtypes in kbuild.SIGNATURES["pi_range"].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def main():
    if not torch.cuda.is_available():
        print("range_study: needs a CUDA card", file=sys.stderr)
        return 2
    print(CS.card_line(), flush=True)
    ycfg = data.YCSBConfig(n_keys=CS.N_KEYS, key_space=1 << 30, batch=8192,
                           write_ratio=0.5, theta=0.9, seed=CS.SEED)
    cfg = pi.PIConfig(capacity=2 * CS.N_KEYS,
                      pending_capacity=max(8192 * 4, CS.N_KEYS // 4),
                      fanout=8, backend="cuda")
    keys_np, vals_np = data.ycsb_dataset(ycfg)
    idx = pi.build(cfg, keys_np, vals_np, device="cuda")
    rng = np.random.default_rng(CS.SEED + 1)
    lanes = {"check lanes": CS.range_queries(rng, keys_np, ycfg.batch,
                                             ycfg.key_space),
             "ycsb-e window": CS.ycsb_e_lanes(ycfg, keys_np, CS.SEED + 5)}
    live, rank, d2s, plive = range_tables(idx)
    load = KR.load_library
    try:
        wants = {}
        for tag, (lo, hi) in lanes.items():
            args = (idx.keys, live, idx.vals, rank, d2s, idx.pkeys,
                    idx.pvals, plive, lo, hi)
            wants[tag] = args, KR.pi_range_plain(
                *args, fanout=8, max_span=CS.MAX_SPAN, levels=idx.levels)
        for unroll, group in itertools.product(UNROLLS, GROUPS):
            lib = variant_library(unroll, group)
            KR.load_library = lambda name: lib
            for tag, (args, want) in wants.items():
                def run():
                    return KR.pi_range(*args, fanout=8, max_span=CS.MAX_SPAN,
                                       levels=idx.levels)
                got = run()
                torch.cuda.synchronize()
                assert all(torch.equal(a, b) for a, b in zip(got, want))
                ms = CS.device_ms(run, 200, "pi_range_group_kernel")
                print(f"{tag}: unroll {unroll}, {group} lanes a query: "
                      f"{ms:.6f} ms, equal to the plain version", flush=True)
    finally:
        KR.load_library = load
    return 0


if __name__ == "__main__":
    sys.exit(main())
