// The index-layer descent (the paper's Alg. 2) and the branchless bound
// over a sorted buffer, shared by pi_search.cu and pi_range.cu.
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
