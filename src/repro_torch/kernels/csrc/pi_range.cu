// Fused batched range aggregation (the paper's §3.2.5) on Hopper, sm_90a.
//
// pi_range_group_kernel replaces the TPU kernel repro/kernels/pi_range.py::
// pi_range (body _range_kernel): for each query [lo, hi] the int32
// (count, sum of values) of the live keys in range, in three stages --
//   1. the descent on lo (pi_search.cu's, read by the group:
//      group_descend in pi_descend.cuh) and r0 = rank[floor], or 0 on
//      underflow;
//   2. a walk over the next max_span occupied ranks through dense2slot,
//      so that segment slack never spends the budget; tombstones keep
//      their key and rank, so they spend it, but the live gate keeps
//      them out of the aggregate;
//   3. the live pending keys in [lo, hi].
// It runs on the windowed dispatcher's path: one launch per window that
// holds a RANGE (pipeline/ranges.py::execute_ranges).
//
// A group of G = PI_RANGE_GROUP lanes per query (8, 16 or 32; 32 was the
// fastest of the three in scripts/range_study.py, which builds the others
// by editing the constant; kernels/pi_range.py::RANGE_GROUP mirrors it).
// Three points of the TPU design are changed, with the same results:
// * The pending pass.  The TPU kernel compares every query with all PC
//   pending slots; at PC = 2^22 and 8192 queries that is 3.4e10 key
//   reads a window.  The pending buffer is sorted over all PC lanes and
//   sentinel-padded, so the keys in [lo, hi] are the one run
//   [lb(lo), ub(hi)): two bounds (group_bounds, a G-ary search: G pivots
//   a round, ceil(log_G(P2)) rounds -- 5 at PC = 2^22 and G = 32, where
//   one thread's binary search takes 22 dependent loads) and two reads of
//   each prefix table -- pcnt, the live count, and psum, the int32-wrapped
//   sum of live values, both (PC+1,) and built by the wrapper -- give the
//   run's aggregate.  Differences of prefix sums are exact modulo 2^32.
//   ub(hi) is computed as its own bound, never as lb(hi + 1), because hi
//   may be INT_MAX; an empty range (lo > hi, which includes the inert
//   lo = sentinel, hi = 0 lanes) does nothing and gives (0, 0).
// * The walk.  The TPU kernel always takes max_span steps.  Keys ascend
//   with occupied rank (invariants L1-L5 of core/index.py), so the walk
//   stops at the first key > hi, or where dense2slot reads C (past the
//   last occupied rank): its cost follows the range's length, not the
//   budget.  A round covers PI_RANGE_UNROLL x G ranks: lane j reads
//   dense2slot at r + j + G u (coalesced), then the slot's key, live flag
//   and value (independent loads); a ballot finds the first rank that
//   stops the walk, and the lanes before it add their live keys >= lo.
//   A walk of the 1024-rank budget is 16 rounds of two dependent loads at
//   G = 32, where one thread walked 1024 rounds.
// * Integer wrap.  Signed overflow is undefined in C++; the sums are
//   accumulated in unsigned int, reduced over the group by shuffles (the
//   wrap is the same in any order) and reinterpreted at the end, which is
//   the int32 wrap of the JAX version.
//
// What bounds it on this card: dependent loads, as pi_probe -- the
// descent (H+1 groups of F keys, one round each), then the walk's rounds,
// then the bounds' rounds.  At the main path's shapes (YCSB-E scans of
// ~1..100 keys) the distinct bytes a launch touches are a few MB, a
// microsecond of HBM bandwidth, so latency and L2 hits set its time.  One
// thread per query (the first port) left 8192 lanes, ~2 warps an SM, too
// few to hide that latency, and a launch lasted as long as its longest
// walk; G lanes a query put G x 8192 lanes in flight and divide the
// longest chain of loads by ~G.
//
// Build and interface as pi_search.cu: a plain C entry point that
// launches on the caller's stream, does not synchronise, and returns
// cudaGetLastError().

#include "pi_descend.cuh"

#define PI_RANGE_UNROLL 2  // rounds of G ranks a walk step reads at once
#define PI_RANGE_GROUP 32  // lanes a query: 8, 16 or 32

static_assert(PI_RANGE_GROUP == 8 || PI_RANGE_GROUP == 16 ||
                  PI_RANGE_GROUP == 32,
              "a query's group is 8, 16 or 32 lanes of one warp");

template <int FT>
__global__ void __launch_bounds__(PI_BLOCK)
pi_range_group_kernel(Levels<int> lv, const int* __restrict__ storage, int C,
                      const int* __restrict__ live,
                      const int* __restrict__ vals,
                      const int* __restrict__ rank,
                      const int* __restrict__ d2s,
                      const int* __restrict__ pending, int PC, int P2,
                      const int* __restrict__ pcnt,
                      const int* __restrict__ psum,
                      const int* __restrict__ lo, const int* __restrict__ hi,
                      int B, int fanout, int max_span,
                      int* __restrict__ cnt_out, int* __restrict__ sum_out) {
  constexpr int U = PI_RANGE_UNROLL;
  constexpr int G = PI_RANGE_GROUP;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int i = (int)(t / G);  // the query; the whole group agrees
  const int lane = (int)(t % G);
  if (i >= B) return;
  const int l = __ldg(lo + i);
  const int h = __ldg(hi + i);
  int cnt = 0;
  unsigned int sum = 0u;
  if (l <= h) {
    // 1. scan start: the floor of lo, then its occupied rank
    bool under;
    const long long pos =
        group_descend<int, FT, G>(lv, storage, C, l, fanout, lane, &under);
    const long long pc = pos < C - 1 ? pos : C - 1;
    const int r0 = under ? 0 : __ldg(rank + pc);
    // 2. walk occupied ranks r0 .. r0 + max_span - 1 (and < C), U x G a
    //    round; the walk stops at the first rank that is past r_end, has
    //    no slot (C) or holds a key > hi
    long long r = r0 > 0 ? r0 : 0;
    const long long r_end = r + max_span < C ? r + max_span : C;
    while (r < r_end) {
      int slot[U], key[U], lv_[U], val[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const long long rr = r + u * G + lane;
        slot[u] = rr < r_end ? __ldg(d2s + rr) : C;
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const bool in = (unsigned)slot[u] < (unsigned)C;
        key[u] = in ? __ldg(storage + slot[u]) : INT_MAX;
        lv_[u] = in ? __ldg(live + slot[u]) : 0;
        val[u] = in ? __ldg(vals + slot[u]) : 0;
      }
      int first = U * G;  // the first stop, in rank order, or none
#pragma unroll
      for (int u = U - 1; u >= 0; --u) {
        const bool stop = (unsigned)slot[u] >= (unsigned)C || key[u] > h;
        const unsigned m = __ballot_sync(group_mask<G>(), stop) &
                           group_mask<G>();
        if (m) first = u * G + __ffs(m >> ((threadIdx.x & 31) & ~(G - 1))) - 1;
      }
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (u * G + lane < first && key[u] >= l && lv_[u] > 0) {
          ++cnt;
          sum += (unsigned)val[u];
        }
      if (first < U * G) break;
      r += U * G;
    }
    cnt = group_sum<G>(cnt);
    sum = group_sum<G>(sum);
    // 3. the pending run [lb(lo), ub(hi)) from the prefix tables
    int a, b;
    group_bounds<int, G>(pending, PC, P2, l, h, lane, &a, &b);
    cnt += __ldg(pcnt + b) - __ldg(pcnt + a);
    sum += (unsigned)__ldg(psum + b) - (unsigned)__ldg(psum + a);
  }
  if (lane == 0) {
    cnt_out[i] = cnt;
    sum_out[i] = (int)sum;
  }
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
  const dim3 grid(
      (unsigned)(((long long)B * PI_RANGE_GROUP + PI_BLOCK - 1) / PI_BLOCK));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PI_RANGE_LAUNCH(FT)                                                 \
  pi_range_group_kernel<FT><<<grid, PI_BLOCK, 0, s>>>(                      \
      lv, static_cast<const int*>(storage), C,                              \
      static_cast<const int*>(live), static_cast<const int*>(vals),         \
      static_cast<const int*>(rank), static_cast<const int*>(d2s),          \
      static_cast<const int*>(pending), PC, P2,                             \
      static_cast<const int*>(pcnt), static_cast<const int*>(psum),         \
      static_cast<const int*>(lo), static_cast<const int*>(hi), B, fanout,  \
      max_span, static_cast<int*>(cnt), static_cast<int*>(sum))
  switch (fanout) {
    case 2: PI_RANGE_LAUNCH(2); break;
    case 4: PI_RANGE_LAUNCH(4); break;
    case 8: PI_RANGE_LAUNCH(8); break;
    case 16: PI_RANGE_LAUNCH(16); break;
    default: PI_RANGE_LAUNCH(0); break;
  }
#undef PI_RANGE_LAUNCH
  return (int)cudaGetLastError();
}

}  // extern "C"
