// The index-layer descent (the paper's Alg. 2) and the branchless bound
// over a sorted buffer, shared by pi_search.cu and pi_range.cu: per thread
// (descend, bound) and per group of lanes (group_descend, group_bounds).
//
// Nothing is padded: an index past the end of an array reads as the
// sentinel, which is what the TPU version's padding held.

#pragma once

#include <climits>

#include <cuda_runtime.h>

#define PI_MAX_LEVELS 32
#define PI_BLOCK 256

template <typename T>
struct Levels {
  const T* ptr[PI_MAX_LEVELS];  // bottom-up: ptr[0] is level 1
  int len[PI_MAX_LEVELS];
  int n;
};

template <typename T> __device__ __forceinline__ T sentinel();
template <> __device__ __forceinline__ int sentinel<int>() { return INT_MAX; }
template <> __device__ __forceinline__ float sentinel<float>() {
  return __int_as_float(0x7f800000);  // +inf
}

template <typename T>
__device__ __forceinline__ T load_or_sentinel(const T* a, long long n,
                                              long long i) {
  return i < n ? __ldg(a + i) : sentinel<T>();
}

// Floor slot of q: rank in the top level, then pos = pos*F + rank in the
// F-key child group of every lower level and of storage.
template <typename T, int FT>
__device__ __forceinline__ long long descend(const Levels<T>& lv,
                                             const T* storage, int C, T q,
                                             int fanout, bool* underflow) {
  const int F = FT > 0 ? FT : fanout;
  const T* top = lv.n ? lv.ptr[lv.n - 1] : storage;
  // without levels the storage is the top, read at least F wide
  const int top_len = lv.n ? lv.len[lv.n - 1] : C;
  const int top_width = lv.n ? top_len : (C > F ? C : F);
  int cnt = 0;
  for (int j = 0; j < top_width; ++j)
    cnt += load_or_sentinel(top, top_len, j) <= q;
  *underflow = cnt == 0;
  long long pos = cnt > 0 ? cnt - 1 : 0;
  for (int l = lv.n - 2; l >= -1; --l) {
    const T* arr = l >= 0 ? lv.ptr[l] : storage;
    const long long len = l >= 0 ? lv.len[l] : C;
    const long long base = pos * F;
    int c = 0;
#pragma unroll
    for (int j = 0; j < F; ++j) c += load_or_sentinel(arr, len, base + j) <= q;
    pos = base + (c > 0 ? c - 1 : 0);
  }
  return pos;
}

// #{i : a[i] < q} (kRight: a[i] <= q) over the sorted a[0..n), read as P2
// wide (P2 the least power of two >= n), capped at n.  The cap matters
// only for kRight with q == the sentinel, where the reads past the end
// compare true; q + 1 is never formed, so q may be INT_MAX.
template <typename T, bool kRight>
__device__ __forceinline__ int bound(const T* a, int n, int P2, T q) {
  int count = 0;
  for (int step = P2 >> 1; step; step >>= 1) {
    const int cand = count + step;
    const T k = load_or_sentinel(a, n, cand - 1);
    count = (kRight ? k <= q : k < q) ? cand : count;
  }
  const T k = load_or_sentinel(a, n, count);
  count += (kRight ? k <= q : k < q) ? 1 : 0;
  return count < n ? count : n;
}

// ---------------------------------------------------------------------------
// group versions: G lanes of one warp (G a power of two <= 32) serve one
// query together.  Every lane of the group must call them with the same
// query; each returns the same value in every lane.  They read in one round
// what the per-thread versions read in up to log2(G) dependent loads.
// ---------------------------------------------------------------------------

// The group's lanes in the warp, for __ballot_sync and __shfl_xor_sync.
template <int G>
__device__ __forceinline__ unsigned group_mask() {
  static_assert(G >= 2 && G <= 32 && (G & (G - 1)) == 0, "G: 2 .. 32");
  if (G == 32) return 0xffffffffu;
  return ((1u << G) - 1u) << ((threadIdx.x & 31) & ~(G - 1));
}

// How many lanes of the group hold pred.
template <int G>
__device__ __forceinline__ int group_count(bool pred) {
  const unsigned m = group_mask<G>();
  return __popc(__ballot_sync(m, pred) & m);
}

// descend(), with the F keys of a level's group read by F lanes at once
// (G at a time when F > G) and counted by a ballot; the top level is read
// G keys a round.  lane: this lane's index in the group.
template <typename T, int FT, int G>
__device__ __forceinline__ long long group_descend(const Levels<T>& lv,
                                                   const T* storage, int C,
                                                   T q, int fanout, int lane,
                                                   bool* underflow) {
  const int F = FT > 0 ? FT : fanout;
  const T* top = lv.n ? lv.ptr[lv.n - 1] : storage;
  const int top_len = lv.n ? lv.len[lv.n - 1] : C;
  const int top_width = lv.n ? top_len : (C > F ? C : F);
  int cnt = 0;
  for (int j = lane; j - lane < top_width; j += G)
    cnt += group_count<G>(j < top_width && load_or_sentinel(top, top_len, j) <= q);
  *underflow = cnt == 0;
  long long pos = cnt > 0 ? cnt - 1 : 0;
  for (int l = lv.n - 2; l >= -1; --l) {
    const T* arr = l >= 0 ? lv.ptr[l] : storage;
    const long long len = l >= 0 ? lv.len[l] : C;
    const long long base = pos * F;
    int c = 0;
#pragma unroll
    for (int j0 = 0; j0 < F; j0 += G)
      c += group_count<G>(j0 + lane < F &&
                          load_or_sentinel(arr, len, base + j0 + lane) <= q);
    pos = base + (c > 0 ? c - 1 : 0);
  }
  return pos;
}

// bound<T, false>(a, n, P2, ql) and bound<T, true>(a, n, P2, qr) at once,
// by a G-ary search: a round probes G pivots of the window that holds the
// count (lane j the (j+1)-th of G equal parts), a ballot counts the pivots
// below q (they are a prefix: a is sorted), and the window narrows by G.
// That is ceil(log_G(P2)) rounds, the two bounds' loads side by side
// in every lane.  The count is taken over a[0..n) alone, which is the
// per-thread bound's count capped at n; q + 1 is never formed, so qr may be
// the sentinel.
template <typename T, int G>
__device__ __forceinline__ void group_bounds(const T* a, int n, int P2,
                                             T ql, T qr, int lane, int* left,
                                             int* right) {
  int cl = 0, cr = 0;
  for (int w = P2; w > 0;) {
    const int s = w > G ? w / G : 1;  // the width of a part
    const bool probe = lane < w / s;
    const int il = cl + (lane + 1) * s - 1, ir = cr + (lane + 1) * s - 1;
    const bool tl = probe && il < n && __ldg(a + il) < ql;
    const bool tr = probe && ir < n && __ldg(a + ir) <= qr;
    cl += group_count<G>(tl) * s;
    cr += group_count<G>(tr) * s;
    w = s > 1 ? s : 0;
  }
  *left = cl;
  *right = cr;
}

// The sum over the group's lanes, every lane getting it (wrap-around sums
// in unsigned give the same bits in any order).
template <int G, typename U>
__device__ __forceinline__ U group_sum(U x) {
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1)
    x += __shfl_xor_sync(group_mask<G>(), x, off);
  return x;
}

template <typename T>
static bool make_levels(Levels<T>* lv, const void* const* ptrs,
                        const int* lens, int n) {
  if (n < 0 || n > PI_MAX_LEVELS) return false;
  for (int l = 0; l < PI_MAX_LEVELS; ++l) {
    lv->ptr[l] = l < n ? static_cast<const T*>(ptrs[l]) : nullptr;
    lv->len[l] = l < n ? lens[l] : 0;
  }
  lv->n = n;
  return true;
}

static inline int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}
