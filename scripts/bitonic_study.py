"""How fast the bitonic kernel sorts on one CUDA card, at each tile shape
the kernel is built for, beside ``torch.argsort(stable=True)``.

    PYTHONPATH=src python scripts/bitonic_study.py

1. The compiler's report (``-Xptxas -v``) of every instantiation of
   ``bitonic_sort_kernel`` and ``bitonic_merge_kernel``: registers, and
   the bytes of stack frame and of spill stores and loads, which must all
   be 0.
2. For each register width a thread may take at a tile (the one-block
   tiles 2^9, 2^11 and 2^13, and the multi-pass plan at 2^20, whose tiles
   are 2^12 and 2^13), built into a variant of the source with every such
   tile, and for the plan's multi-stride passes on 2^13 tiles instead of
   2^12: the kernel bit for bit against ``bitonic_sort_ref`` on keys with
   many ties, then its device time per sort (``torch.profiler``, the
   kernels whose name holds ``bitonic``) and its launches per sort, beside
   the stable argsort's device time.  The module's ``LOG_R`` table and
   ``LOG_GATHER`` hold the choices ``chip_smoke.py`` and the engine use.
3. Where the time goes at 2^13 and 2^20 pairs: the kernel beside variants
   built from its source without a part of its work (the lane strides,
   the register strides, both, or every stage: wrong sorts, timed only).

Prints one line per measurement, and the card's name and power limit.
"""
import ctypes
import functools
import os
import re
import subprocess
import sys
import time

import torch

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

from chip_smoke import card_line, device_events  # noqa: E402
from repro_torch.kernels import bitonic_sort as BS  # noqa: E402
from repro_torch.kernels import build as kbuild  # noqa: E402
from repro_torch.kernels.ref import bitonic_sort_ref  # noqa: E402

ITERS = 100
# text of csrc/bitonic_sort.cu -> its replacement in each variant: the
# kernel without a part of its work (wrong sorts, timed only)
PARTS = {
    "without lane strides": [(
        "    ce_lanes<LOG_R, QP - LOG_R, PD>(x, tp, lane, desc);",
        "    (void)lane;")],
    "without register strides": [(
        "    ce_regs<LOG_R, QP, PD>(x, tp, desc);", "    (void)tp;")],
    "without compare-exchanges": [
        ("    ce_lanes<LOG_R, QP - LOG_R, PD>(x, tp, lane, desc);",
         "    (void)lane;"),
        ("    ce_regs<LOG_R, QP, PD>(x, tp, desc);", "    x[0] ^= QP;")],
    "load and store only": [
        ("  if (S >= s0) sort_strides<LOG_R, LOG_T, S, S>(x, smem, tp, lane, "
         "desc);", "  (void)s0;"),
        ("  if (Q < lo) return;", "  return;")],
}
# the kernel also built for the register widths the module does not use
WIDTHS = [("#define BITONIC_TILES(X)",
           "#define BITONIC_TILES(X) X(2, 9) X(3, 9) X(4, 9) X(3, 11) "
           "X(4, 11) X(3, 12) X(4, 12) X(5, 12) X(3, 13) X(4, 13) X(5, 13)")]
# (batch, {tile: log2 of the pairs a thread holds}, pass_plan options) of
# each variant
VARIANTS = [
    (1 << 9, {9: 2}, {}), (1 << 9, {9: 3}, {}), (1 << 9, {9: 4}, {}),
    (1 << 11, {11: 3}, {}), (1 << 11, {11: 4}, {}),
    (1 << 13, {13: 3}, {}), (1 << 13, {13: 4}, {}), (1 << 13, {13: 5}, {}),
    (1 << 20, {12: 4, 13: 4}, {}), (1 << 20, {12: 3, 13: 3}, {}),
    (1 << 20, {12: 5, 13: 5}, {}), (1 << 20, {12: 3, 13: 4}, {}),
    (1 << 20, {12: 4, 13: 4}, {"log_gather": 13}),
    (1 << 20, {12: 3, 13: 3}, {"log_gather": 13}),
]


def ptxas_report():
    """(kernel, registers, bytes of stack frame and spills) of each
    instantiation."""
    log = kbuild.build_log("bitonic_sort")
    rows, name, spill = [], None, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and name:
            spill = sum(int(x) for x in m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            rows.append((name, int(m.group(1)), spill))
            name, spill = None, None
    return rows


def per_sort(fn):
    """(device ms, launches) per call of ``fn``, kernels named bitonic."""
    dev, _ = device_events(fn, ITERS, operators=False)
    rows = [(t, n) for name, t, n in dev if "bitonic" in name]
    return sum(t for t, _ in rows) / ITERS / 1e3, \
        sum(n for _, n in rows) / ITERS


def variant_entries(variants):
    """{name: ``bitonic_sort`` of the kernel's source with the name's
    edits applied}, built by nvcc into ``build/kernels/``, all at once."""
    jobs = {}
    for name, edits in variants.items():
        src = (kbuild.CSRC / "bitonic_sort.cu").read_text()
        for old, new in edits:
            assert src.count(old) == 1, (name, old)
            src = src.replace(old, new)
        cu = kbuild.BUILD_DIR / f"bitonic_variant_{name.replace(' ', '_')}.cu"
        kbuild.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        cu.write_text(src)
        so = cu.with_suffix(".so")
        jobs[name] = (so, subprocess.Popen(
            [kbuild.nvcc(), *kbuild.NVCC_FLAGS, "-o", str(so), str(cu)],
            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL))
    entries = {}
    for name, (so, proc) in jobs.items():
        assert proc.wait() == 0, f"variant {name} did not build"
        fn = ctypes.CDLL(str(so)).bitonic_sort
        fn.argtypes = kbuild.SIGNATURES["bitonic_sort"]["bitonic_sort"]
        fn.restype = ctypes.c_int
        entries[name] = fn
    return entries


def sorter(fn, k, v):
    """A call of entry ``fn`` on (k, v) as ``BS.bitonic_sort`` makes it,
    and the (keys, values) it writes."""
    log_n = BS.network_log(k.numel())
    plan, n_passes = BS._plan_array(log_n)
    scratch = torch.empty(1 << log_n, dtype=torch.int64, device=k.device)
    ko, vo = torch.empty_like(k), torch.empty_like(v)

    def run():
        rc = fn(k.data_ptr(), v.data_ptr(), ko.data_ptr(), vo.data_ptr(),
                scratch.data_ptr(), k.numel(), log_n, 0, plan, n_passes,
                torch.cuda.current_stream().cuda_stream)
        assert rc == 0, rc
    return run, (ko, vo)


def main():
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    t0 = time.perf_counter()
    BS.load_library("bitonic_sort")
    print(f"[build] bitonic_sort.cu in {time.perf_counter() - t0:.1f} s")
    for name, regs, spill in ptxas_report():
        print(f"[ptxas] {name}: {regs} registers, {spill} bytes of stack "
              f"and spills")
        assert spill == 0, f"{name} spills"
    g = torch.Generator(device="cuda").manual_seed(0)
    default = dict(BS.LOG_R)
    t0 = time.perf_counter()
    variants = variant_entries(dict(PARTS, widths=WIDTHS))
    print(f"[build] {len(variants)} variants in "
          f"{time.perf_counter() - t0:.1f} s")
    widths_fn = variants.pop("widths")
    plan = BS.pass_plan
    for B, widths, options in VARIANTS:
        BS.LOG_R.update(widths)
        BS.pass_plan = functools.partial(plan, **options)
        BS._plan_array.cache_clear()
        k = torch.randint(0, max(2, B // 4), (B,), device="cuda",
                          dtype=torch.int32, generator=g)
        v = torch.randperm(B, device="cuda", generator=g).int()
        run, out = sorter(widths_fn, k, v)
        run()
        want = bitonic_sort_ref(k, v)
        assert all(torch.equal(a, b) for a, b in zip(out, want)), widths
        ms, launches = per_sort(run)
        dev, _ = device_events(lambda: torch.argsort(k, stable=True), ITERS,
                               operators=False)
        lib_ms = sum(t for _, t, _ in dev) / ITERS / 1e3
        tiles = ", ".join(f"2^{t}: {1 << r} pairs a thread"
                          for t, r in sorted(widths.items()))
        print(f"[widths] B=2^{B.bit_length() - 1} ({tiles}; {options}): "
              f"device {ms:.6f} ms, {launches:g} launches a sort | "
              f"torch.argsort(stable) {lib_ms:.6f} ms")
        BS.LOG_R.clear()
        BS.LOG_R.update(default)
    BS.pass_plan = plan
    BS._plan_array.cache_clear()
    entries = {"the kernel": BS.load_library("bitonic_sort").bitonic_sort}
    entries.update(variants)
    for B in (1 << 13, 1 << 20):
        k = torch.randint(0, B // 4, (B,), device="cuda", dtype=torch.int32,
                          generator=g)
        v = torch.randperm(B, device="cuda", generator=g).int()
        for name, fn in entries.items():
            ms, launches = per_sort(sorter(fn, k, v)[0])
            print(f"[parts] B=2^{B.bit_length() - 1} {name}: device "
                  f"{ms:.6f} ms, {launches:g} launches")
    print(f"card: {card_line()}")


if __name__ == "__main__":
    main()
