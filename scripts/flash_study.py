"""How close the bfloat16 flash kernel comes to its plain version, and how
fast it runs at each head dim, on one CUDA card.

    PYTHONPATH=src python scripts/flash_study.py [--seeds 0 1 2]

1. At phi3-mini's prefill shape (8, 2048, 32, 96), causal, for each seed
   (q, k, v drawn as ``chip_smoke.py`` draws them from a CUDA generator;
   its ``[kernels:flash]`` phi3 case is seed 2): the largest share of
   ``CARD_TOL`` that an output of the kernel uses against the plain
   version, and how many outputs use more than a quarter and more than
   half of it.  Beside it, the same for a plain version whose scores are
   float32 sums (over the head dim in another order) against the plain
   version's exactly rounded scores: what two float32 orders of the same
   sums can differ by under the same bar.
2. The kernel's device time (CUDA events over 20 launches) and TFLOP/s at
   head dims 64, 96, 128 and 256 (8 x 2048 tokens, causal, heads chosen
   to keep 3072 channels), beside ``F.scaled_dot_product_attention``.
3. Where its time goes at phi3's shape: the kernel beside two variants
   built from its source, one without the softmax (the products alone,
   wrong numbers) and one without the products (the softmax alone on
   whatever the registers hold).

With ``--float32`` it studies the float32 kernel instead:

1. At the float32 case of ``chip_smoke.py`` (2, 512, 32, 32, 96), causal:
   the largest share of ``CARD_TOL`` (1e-5) against the plain version,
   the device time (CUDA events over 20 launches) and TFLOP/s beside
   ``F.scaled_dot_product_attention`` in float32.
2. The same time and share for variants built from the kernel's source:
   4 query rows a thread at D = 96, the query tiles of a head side by side
   in the grid (not every head's heaviest first), no skip of causal tiles
   past a warp's rows, other unrolling of the S and P.V loops, and two
   with wrong numbers: one without P.V, one without S.
3. The kernel and SDPA at head dims 16 .. 256 (2 x 512 tokens, causal,
   heads chosen to keep 3072 channels).

Prints one line per measurement, and the card's name and power limit.
"""
import argparse
import ctypes
import math
import os
import re
import subprocess
import sys

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch.kernels import build as kbuild  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402

# text of csrc/flash_attention.cu -> its replacement in each variant
VARIANTS = {
    "without the softmax": [(
        "      softmax_tile<D>(sc, sc2, m, l, corr, kb, whole(kb), Sk, causal,"
        " window,\n                      softcap, ra, cq);",
        "      corr[0] = corr[1] = 1.f;")],
    "without the products": [(
        "    if (kk < Sh::NH)\n      wgmma_ss<BK>(sc, da, db, kk > 0);\n"
        "    else\n      wgmma_ss<BK>(sc2, da, db, kk > Sh::NH);",
        "    (void)da, (void)db;"), (
        "    wgmma_rs<D>(o, pa[kk], smem_desc<Sh::SW>(sv + kk * 16 * Sh::SW,\n"
        "                                             Sh::BK * Sh::SW),\n"
        "                1);",
        "    (void)sv;")],
}


F32_VARIANTS = {
    "4 rows a thread (64 rows a block)": [(
        "static constexpr int TM = D >= 128 ? 4 : 8;",
        "static constexpr int TM = 4;")],
    "query tiles of a head side by side": [(
        "  const int qt = gridDim.z - 1 - blockIdx.z;\n"
        "  const int h = blockIdx.x;\n  const int b = blockIdx.y;",
        "  const int qt = gridDim.x - 1 - blockIdx.x;\n"
        "  const int h = blockIdx.y;\n  const int b = blockIdx.z;"), (
        "dim3 grid(H, B, (Sq + Sh::BQ - 1) / Sh::BQ);",
        "dim3 grid((Sq + Sh::BQ - 1) / Sh::BQ, H, B);")],
    "without the causal skip": [(
        "if (causal && kb > q0 + warp_rows) continue;", "")],
    "S unrolled by 2": [(
        "#pragma unroll 1\n    for (int d = d0;",
        "#pragma unroll 2\n    for (int d = d0;")],
    "P.V unrolled by 2": [(
        "#pragma unroll 4\n    for (int kk = kh;",
        "#pragma unroll 2\n    for (int kk = kh;")],
    "P.V unrolled by 8": [(
        "#pragma unroll 4\n    for (int kk = kh;",
        "#pragma unroll 8\n    for (int kk = kh;")],
    "without P.V": [("for (int kk = kh; kk < kh + BK / 2; ++kk) {",
                     "for (int kk = kh; kk < kh; ++kk) {")],
    "without S": [("for (int d = d0; d < d0 + D / 2; d += 2) {",
                   "for (int d = d0; d < d0; d += 2) {")],
    "without S and P.V": [
        ("for (int d = d0; d < d0 + D / 2; d += 2) {",
         "for (int d = d0; d < d0; d += 2) {"),
        ("for (int kk = kh; kk < kh + BK / 2; ++kk) {",
         "for (int kk = kh; kk < kh; ++kk) {")],
    "without the loads of later tiles": [(
        "if (t + 1 < t_end) load_kv(t + 1, stage ^ 1);", "")],
}


def shares(got, want):
    err = (got.float() - want.float()).abs()
    share = err / (FA.CARD_TOL[want.dtype][0]
                   + FA.CARD_TOL[want.dtype][1] * want.float().abs())
    return (f"largest share {share.max().item():.4f}, "
            f"{int((share > 0.25).sum())} outputs above 0.25, "
            f"{int((share > 0.5).sum())} above 0.5 of {share.numel()}")


def float32_score_plain(q, k, v):
    """The plain version with float32 score sums, the head dim reversed."""
    einsum = torch.einsum

    def float32_scores(eq, a, b):
        if eq == "bqhd,bkhd->bhqk":
            return einsum(eq, a.float().flip(-1), b.float().flip(-1)).double()
        return einsum(eq, a, b)
    torch.einsum = float32_scores
    try:
        return FA.flash_attention_fwd_plain(q, k, v)
    finally:
        torch.einsum = einsum


def ms(fn, iters=20):
    for _ in range(3):
        fn()
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def variant_entry(name, edits, entry="flash_fwd_bf16"):
    """``entry`` of the kernel's source with ``edits`` applied, built by
    nvcc into ``build/kernels/``."""
    src = (kbuild.CSRC / "flash_attention.cu").read_text()
    for old, new in edits:
        assert src.count(old) >= 1, (name, old)
        src = src.replace(old, new)
    tag = re.sub(r"\W+", "_", name)
    cu = kbuild.BUILD_DIR / f"flash_variant_{tag}.cu"
    so = cu.with_suffix(".so")
    kbuild.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu.write_text(src)
    subprocess.run([kbuild.nvcc(), *kbuild.NVCC_FLAGS, "-I",
                    str(kbuild.CSRC), "-o", str(so), str(cu)], check=True,
                   capture_output=True)
    fn = getattr(ctypes.CDLL(str(so)), entry)
    fn.argtypes = kbuild.SIGNATURES["flash_attention"][entry]
    fn.restype = ctypes.c_int
    return fn


def launcher(fn, q, k, v):
    B, S, H, D = q.shape
    out = torch.empty_like(q)
    scale = ctypes.c_float(FA.weak_scalar(1 / math.sqrt(D), q.dtype))

    def run():
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B,
                S, S, H, k.shape[2], D, 1, 0, ctypes.c_float(0.0), scale,
                torch.cuda.current_stream().cuda_stream)
        assert rc == 0, rc
        return out
    return run


def sdpa(q, k, v):
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    return lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True)


def float32_main():
    B, S, H, D = 2, 512, 32, 96
    ops = 4 * B * H * D * S * (S + 1) / 2
    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn(B, S, H, D, generator=g, device="cuda")
               for _ in range(3))
    want = FA.flash_attention_fwd_plain(q, k, v)
    got = FA.flash_attention_fwd(q, k, v)
    torch.cuda.synchronize()
    t, t_lib = ms(lambda: FA.flash_attention_fwd(q, k, v)), ms(sdpa(q, k, v))
    print(f"float32 {(B, S, H, H, D)}: kernel {t:.6f} ms "
          f"({ops / t / 1e9:.1f} TFLOP/s), {shares(got, want)}; "
          f"scaled_dot_product_attention {t_lib:.6f} ms "
          f"({ops / t_lib / 1e9:.1f} TFLOP/s)", flush=True)
    for name, edits in F32_VARIANTS.items():
        run = launcher(variant_entry(name, edits, "flash_fwd_f32"), q, k, v)
        out = run()
        torch.cuda.synchronize()
        print(f"float32 variant {name}: {ms(run):.6f} ms, "
              f"{shares(out, want)}", flush=True)
    for D in (16, 32, 64, 128, 256):
        H = 3072 // D
        q, k, v = (torch.randn(B, S, H, D, generator=g, device="cuda")
                   for _ in range(3))
        ops = 4 * B * H * D * S * (S + 1) / 2
        t, t_lib = ms(lambda: FA.flash_attention_fwd(q, k, v)), \
            ms(sdpa(q, k, v))
        print(f"float32 D={D} H={H}: kernel {t:.6f} ms "
              f"({ops / t / 1e9:.1f} TFLOP/s), scaled_dot_product_attention "
              f"{t_lib:.6f} ms ({ops / t_lib / 1e9:.1f} TFLOP/s)", flush=True)
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--float32", action="store_true",
                    help="study the float32 kernel instead")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("flash_study: needs a CUDA card", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    if args.float32:
        return float32_main()
    B, S, H, D = 8, 2048, 32, 96
    for seed in args.seeds:
        g = torch.Generator(device="cuda").manual_seed(seed)
        q, k, v = (torch.randn(B * S * H * D, generator=g, device="cuda")
                   .to(torch.bfloat16).view(B, S, H, D) for _ in range(3))
        want = FA.flash_attention_fwd_plain(q, k, v)
        got = FA.flash_attention_fwd(q, k, v)
        torch.cuda.synchronize()
        print(f"seed {seed}: kernel against the plain version: "
              f"{shares(got, want)}", flush=True)
        print(f"seed {seed}: float32 score sums against exactly rounded "
              f"ones: {shares(float32_score_plain(q, k, v), want)}",
              flush=True)
        del q, k, v, want, got
    g = torch.Generator(device="cuda").manual_seed(0)
    for D in (64, 96, 128, 256):
        H = 3072 // D
        q, k, v = (torch.randn(B, S, H, D, generator=g, device="cuda")
                   .to(torch.bfloat16) for _ in range(3))
        ops = 4 * B * H * D * S * (S + 1) / 2
        t = ms(lambda: FA.flash_attention_fwd(q, k, v))
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        t_lib = ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True))
        print(f"D={D} H={H}: kernel {t:.6f} ms ({ops / t / 1e9:.1f} "
              f"TFLOP/s), scaled_dot_product_attention {t_lib:.6f} ms "
              f"({ops / t_lib / 1e9:.1f} TFLOP/s)", flush=True)
        del q, k, v
    B, S, H, D = 8, 2048, 32, 96
    q, k, v = (torch.randn(B, S, H, D, generator=g, device="cuda")
               .to(torch.bfloat16) for _ in range(3))
    t = ms(lambda: FA.flash_attention_fwd(q, k, v))
    print(f"phi3 shape: kernel {t:.6f} ms", flush=True)
    for name, edits in VARIANTS.items():
        t = ms(launcher(variant_entry(name, edits), q, k, v))
        print(f"phi3 shape: kernel {name} {t:.6f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
