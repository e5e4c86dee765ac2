"""Write ``src/repro_torch/kernels/csrc/wgmma_bf16.cuh``: the Hopper
``wgmma.mma_async`` instructions the flash kernel issues, one inline-PTX
function per shape, with every accumulator register spelled out (PTX
names each one, and the preprocessor cannot count them).

    python scripts/gen_wgmma.py

* ``wgmma_ss<N>``: m64nNk16, bf16 A and B from shared memory (both
  K-major), float32 accumulator; N in ``SS_N`` (the key tiles of S = QK^T).
* ``wgmma_rs<N>``: m64nNk16, bf16 A from registers (four 32-bit
  registers, two bf16 each), B from shared memory MN-major (the transpose
  bit set), float32 accumulator; N in ``RS_N`` (the head dims of O += PV).

``scale_d`` = 0 overwrites the accumulator, 1 adds to it.
"""
from pathlib import Path

SS_N = (64, 128)
RS_N = (16, 32, 64, 96, 128, 256)
OUT = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / \
    "kernels" / "csrc" / "wgmma_bf16.cuh"


def regs(n_acc: int, first: int = 0) -> str:
    return ", ".join(f"%{first + i}" for i in range(n_acc))


def outs(n_acc: int) -> str:
    return ", ".join(f'"+f"(d[{i}])' for i in range(n_acc))


def ss(n: int) -> str:
    a = n // 2
    return f"""template <>
__device__ __forceinline__ void wgmma_ss<{n}>(float (&d)[{a}], uint64_t da,
                                              uint64_t db, int scale_d) {{
  asm volatile(
      "{{\\n.reg .pred p;\\nsetp.ne.b32 p, %{a + 2}, 0;\\n"
      "wgmma.mma_async.sync.aligned.m64n{n}k16.f32.bf16.bf16 "
      "{{{regs(a)}}}, %{a}, %{a + 1}, p, 1, 1, 0, 0;\\n}}\\n"
      : {outs(a)}
      : "l"(da), "l"(db), "r"(scale_d));
}}
"""


def rs(n: int) -> str:
    a = n // 2
    return f"""template <>
__device__ __forceinline__ void wgmma_rs<{n}>(float (&d)[{a}], const uint32_t (&x)[4],
                                              uint64_t db, int scale_d) {{
  asm volatile(
      "{{\\n.reg .pred p;\\nsetp.ne.b32 p, %{a + 5}, 0;\\n"
      "wgmma.mma_async.sync.aligned.m64n{n}k16.f32.bf16.bf16 "
      "{{{regs(a)}}}, {{%{a}, %{a + 1}, %{a + 2}, %{a + 3}}}, %{a + 4}, p, 1, 1, 1;\\n}}\\n"
      : {outs(a)}
      : "r"(x[0]), "r"(x[1]), "r"(x[2]), "r"(x[3]), "l"(db), "r"(scale_d));
}}
"""


def main() -> None:
    parts = [
        "// Written by scripts/gen_wgmma.py; edit that script, not this file.\n"
        "//\n"
        "// wgmma_ss<N>: D(64 x N, f32) (+)= A(64 x 16, bf16, smem, K-major)\n"
        "//   . B(16 x N, bf16, smem, K-major), A and B by descriptor.\n"
        "// wgmma_rs<N>: the same with A from registers (the m64k16 A\n"
        "//   fragment) and B MN-major (transpose bit set).\n"
        "// scale_d = 0 overwrites D, 1 accumulates into it.\n\n"
        "#pragma once\n#include <cstdint>\n\n"
        "template <int N>\n"
        "__device__ void wgmma_ss(float (&d)[N / 2], uint64_t da, uint64_t db,\n"
        "                         int scale_d);\n"
        "template <int N>\n"
        "__device__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&x)[4],\n"
        "                         uint64_t db, int scale_d);\n\n"]
    parts += [ss(n) + "\n" for n in SS_N]
    parts += [rs(n) + "\n" for n in RS_N]
    OUT.write_text("".join(parts).rstrip() + "\n")


if __name__ == "__main__":
    main()
