// Fused batched range aggregation (the paper's §3.2.5) on Hopper, sm_90a.
//
// pi_range_kernel replaces the TPU kernel repro/kernels/pi_range.py::
// pi_range (body _range_kernel): for each query [lo, hi] the int32
// (count, sum of values) of the live keys in range, in three stages --
//   1. the descent on lo (the one of pi_search.cu, from pi_descend.cuh)
//      and r0 = rank[floor], or 0 on underflow;
//   2. a walk over the next max_span occupied ranks through dense2slot,
//      so that segment slack never spends the budget; tombstones keep
//      their key and rank, so they spend it, but the live gate keeps
//      them out of the aggregate;
//   3. the live pending keys in [lo, hi].
// It runs on the windowed dispatcher's path: one launch per window that
// holds a RANGE (pipeline/ranges.py::execute_ranges).
//
// One thread per query, as pi_probe_kernel.  Three points of the TPU
// design are changed, with the same results:
// * The pending pass.  The TPU kernel compares every query with all PC
//   pending slots; at PC = 2^22 and 8192 queries that is 3.4e10 key
//   reads a window.  The pending buffer is sorted over all PC lanes and
//   sentinel-padded, so the keys in [lo, hi] are the one run
//   [lb(lo), ub(hi)): two branchless bounds (log2(PC) dependent loads
//   each) and two reads of each prefix table -- pcnt, the live count, and
//   psum, the int32-wrapped sum of live values, both (PC+1,) and built
//   by the wrapper -- give the run's aggregate.  Differences of prefix
//   sums are exact modulo 2^32.  ub(hi) is computed as its own bound,
//   never as lb(hi + 1), because hi may be INT_MAX; an empty range
//   (lo > hi, which includes the inert lo = sentinel, hi = 0 lanes) does
//   nothing and gives (0, 0).
// * The walk.  The TPU kernel always takes max_span steps.  Keys ascend
//   with occupied rank (invariants L1-L5 of core/index.py), so the walk
//   stops at the first key > hi, or where dense2slot reads C (past the
//   last occupied rank): its cost follows the range's length, not the
//   budget.
// * Integer wrap.  Signed overflow is undefined in C++; the sum is
//   accumulated in unsigned int and reinterpreted at the end, which is
//   the int32 wrap of the JAX version.
//
// What bounds it on this card: dependent loads, as pi_probe -- the
// descent (H+1 groups of F keys), then the walk, one d2s -> slot -> key
// chain per step, then two bounds over the pending buffer.  At the main
// path's shapes (YCSB-E scans of ~1..100 keys) the distinct bytes a
// launch touches are a few MB, a microsecond of HBM bandwidth, so
// latency and L2 hits set its time.  Lanes of one warp walk different
// lengths and diverge; a warp per long range is left for later work.
//
// Build and interface as pi_search.cu: a plain C entry point that
// launches on the caller's stream, does not synchronise, and returns
// cudaGetLastError().

#include "pi_descend.cuh"

template <int FT>
__global__ void __launch_bounds__(PI_BLOCK)
pi_range_kernel(Levels<int> lv, const int* __restrict__ storage, int C,
                const int* __restrict__ live, const int* __restrict__ vals,
                const int* __restrict__ rank, const int* __restrict__ d2s,
                const int* __restrict__ pending, int PC, int P2,
                const int* __restrict__ pcnt, const int* __restrict__ psum,
                const int* __restrict__ lo, const int* __restrict__ hi,
                int B, int fanout, int max_span, int* __restrict__ cnt_out,
                int* __restrict__ sum_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;
  const int l = __ldg(lo + i);
  const int h = __ldg(hi + i);
  int cnt = 0;
  unsigned int sum = 0u;
  if (l <= h) {
    // 1. scan start: the floor of lo, then its occupied rank
    bool under;
    const long long pos = descend<int, FT>(lv, storage, C, l, fanout, &under);
    const long long pc = pos < C - 1 ? pos : C - 1;
    const int r0 = under ? 0 : __ldg(rank + pc);
    // 2. walk occupied ranks r0 .. r0 + max_span - 1 (and < C)
    long long r = r0 > 0 ? r0 : 0;
    const long long r_end = r + max_span < C ? r + max_span : C;
    for (; r < r_end; ++r) {
      const int slot = __ldg(d2s + r);
      if ((unsigned)slot >= (unsigned)C) break;  // C: past the last rank
      const int k = __ldg(storage + slot);
      if (k > h) break;                           // keys ascend with rank
      if (k >= l && __ldg(live + slot) > 0) {
        ++cnt;
        sum += (unsigned)__ldg(vals + slot);
      }
    }
    // 3. the pending run [lb(lo), ub(hi)) from the prefix tables
    const int a = bound<int, false>(pending, PC, P2, l);
    const int b = bound<int, true>(pending, PC, P2, h);
    cnt += __ldg(pcnt + b) - __ldg(pcnt + a);
    sum += (unsigned)__ldg(psum + b) - (unsigned)__ldg(psum + a);
  }
  cnt_out[i] = cnt;
  sum_out[i] = (int)sum;
}

extern "C" {

int pi_range_i32(const void* const* level_ptrs, const int* level_lens,
                 int n_levels, const void* storage, int C, const void* live,
                 const void* vals, const void* rank, const void* d2s,
                 const void* pending, int PC, const void* pcnt,
                 const void* psum, const void* lo, const void* hi, int B,
                 int fanout, int max_span, void* cnt, void* sum,
                 void* stream) {
  Levels<int> lv;
  if (!make_levels(&lv, level_ptrs, level_lens, n_levels) || fanout < 2 ||
      PC < 1 || C < 1 || max_span < 0)
    return (int)cudaErrorInvalidValue;
  const int P2 = pow2_at_least(PC);
  const dim3 grid((B + PI_BLOCK - 1) / PI_BLOCK), block(PI_BLOCK);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PI_RANGE_ARGS                                                      \
  lv, static_cast<const int*>(storage), C, static_cast<const int*>(live),  \
      static_cast<const int*>(vals), static_cast<const int*>(rank),        \
      static_cast<const int*>(d2s), static_cast<const int*>(pending), PC,  \
      P2, static_cast<const int*>(pcnt), static_cast<const int*>(psum),    \
      static_cast<const int*>(lo), static_cast<const int*>(hi), B, fanout, \
      max_span, static_cast<int*>(cnt), static_cast<int*>(sum)
  switch (fanout) {
    case 2: pi_range_kernel<2><<<grid, block, 0, s>>>(PI_RANGE_ARGS); break;
    case 4: pi_range_kernel<4><<<grid, block, 0, s>>>(PI_RANGE_ARGS); break;
    case 8: pi_range_kernel<8><<<grid, block, 0, s>>>(PI_RANGE_ARGS); break;
    case 16: pi_range_kernel<16><<<grid, block, 0, s>>>(PI_RANGE_ARGS); break;
    default: pi_range_kernel<0><<<grid, block, 0, s>>>(PI_RANGE_ARGS); break;
  }
#undef PI_RANGE_ARGS
  return (int)cudaGetLastError();
}

}  // extern "C"
