// The index-layer descent (the paper's Alg. 2) and the G-ary bound over a
// sorted buffer, shared by pi_search.cu and pi_range.cu, each run by a
// group of lanes: whole (group_descend, group_bounds: pi_range.cu) or a
// round at a time (GroupDescent, GroupLowerBound: pi_search.cu).
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

// ---------------------------------------------------------------------------
// G lanes of one warp (G a power of two <= 32) serve one query together.
// Every lane of the group must call these with the same query; each
// returns the same value in every lane.  They read in one round what one
// thread would read in up to log2(G) dependent loads.
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

// The floor slot of q: its rank in the top level, then pos = pos*F + rank
// in the F-key child group of every lower level and of storage.  A group's
// F keys are read by F lanes at once (G at a time when F > G) and counted
// by a ballot; the top level is read G keys a round.  lane: this lane's
// index in the group.
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

// #{i : a[i] < ql} and #{i : a[i] <= qr} over the sorted a[0..n), read
// as P2 wide (P2 the least power of two >= n), at once, by a G-ary search:
// a round probes G pivots of the window that holds the count (lane j the
// (j+1)-th of G equal parts), a ballot counts the pivots below q (they are
// a prefix: a is sorted), and the window narrows by G.
// That is ceil(log_G(P2)) rounds, the two bounds' loads side by side
// in every lane.  The count is taken over a[0..n) alone, which is a
// binary search's count capped at n; q + 1 is never formed, so qr may be
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

// ---------------------------------------------------------------------------
// step-wise group versions (pi_search.cu): the descent and a one-sided G-ary
// bound cut into rounds, each round split into issue() (its loads) and
// consume() (its ballots), so that a kernel can put one round of each in
// flight together.  Every lane of the group calls them with the same query;
// the state is the same in every lane after each consume().  All 32 lanes
// of the warp must call them together (a spare group serves a copy of a
// query), so that ballots and shuffles take the whole warp's mask and need
// no divergence check.  Their loads are branch-free (key_at), so that a
// round's loads leave back to back.  Positions are unsigned 32-bit: where
// one wraps (a sentinel query over an index near 2^31 keys), it wraps as
// the plain version's int32 positions do.
// ---------------------------------------------------------------------------

// One array as a round reads it.  n >= 1.
template <typename T>
struct LevelView {
  const T* p;
  unsigned n;
};

// a[i], the sentinel past the end; the load is issued for any i (clamped
// to the last key), so that it needs no branch.
template <typename T>
__device__ __forceinline__ T key_at(const LevelView<T>& a, unsigned i) {
  const unsigned c = i < a.n ? i : a.n - 1;
  const T k = __ldg(a.p + c);
  return i < a.n ? k : sentinel<T>();
}

// How many lanes of this lane's group hold pred; the whole warp calls it.
template <int G>
__device__ __forceinline__ int warp_group_count(bool pred) {
  return __popc(__ballot_sync(0xffffffffu, pred) & group_mask<G>());
}

// keys[idx / G] of lane idx % G, in every lane of the group (idx the same
// in every lane of the group); the whole warp calls it.  One shuffle per
// register, then a select among their values: a select among the
// registers themselves may be compiled to an indexed load, which puts the
// array in local memory.
template <int G, typename T, int U>
__device__ __forceinline__ T group_take(const T (&keys)[U], unsigned idx) {
  T v = keys[0];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const T r = __shfl_sync(0xffffffffu, keys[u], idx % G, G);
    v = idx / G == (unsigned)u ? r : v;
  }
  return v;
}

// The top level, or the k-th array below it, top-down (levels H-1 .. 1,
// then storage); k = -1 is the top (the storage when there is no level).
template <typename T>
__device__ __forceinline__ LevelView<T> level_view(const Levels<T>& lv,
                                                   const T* storage, int C,
                                                   int k) {
  const int l = lv.n - 2 - k;
  if (l < 0 || l >= lv.n) return {storage, (unsigned)C};
  return {lv.ptr[l], (unsigned)lv.len[l]};
}

// group_descend() a round at a time.  top() reads the top level (one
// round while it holds <= G keys); each issue()/consume() then reads the
// F-key child group of one array below it.  A lane with no key to read
// loads lane 0's and is left out of the count.  The array a round reads
// (va) is looked up a round ahead: its pointer and length come from the
// kernel's parameters at an index that depends on no key, so that lookup
// overlaps the round before.  After the last round, storage_key() gives
// storage[pos] from the lane that read it, where one did: not when the
// descent had no level (the top was the storage), for a run-time F above
// G, or when pos lies past the storage's end.
template <typename T, int FT, int G>
struct GroupDescent {
  static constexpr int U = FT > 0 ? (FT + G - 1) / G : 1;
  unsigned pos, base, last;  // last: the key at pos in the round's registers
  int next, n_below;  // the next array below the top, and how many there are
  bool under;
  T k[U];
  LevelView<T> va;  // the array the next round reads

  __device__ __forceinline__ void top(const Levels<T>& lv, const T* storage,
                                      int C, T q, int F, int lane) {
    const LevelView<T> a = level_view(lv, storage, C, -1);
    va = level_view(lv, storage, C, 0);
    const int width = lv.n ? (int)a.n : (C > F ? C : F);
    int cnt = 0;
    for (int j = lane; j - lane < width; j += G)
      cnt += warp_group_count<G>(j < width && key_at(a, j) <= q);
    under = cnt == 0;
    pos = cnt > 0 ? cnt - 1 : 0;
    next = 0;
    n_below = lv.n;
  }

  __device__ __forceinline__ bool active() const { return next < n_below; }

  __device__ __forceinline__ void issue(const Levels<T>& lv, const T* storage,
                                        int C, int F, int lane) {
    base = pos * F;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = u * G + lane;
      k[u] = key_at(va, j < F ? base + j : base);
    }
    va = level_view(lv, storage, C, next + 1);
  }

  __device__ __forceinline__ void consume(const Levels<T>& lv,
                                          const T* storage, int C, T q, int F,
                                          int lane) {
    int c = 0;
#pragma unroll
    for (int u = 0; u < U; ++u)
      c += warp_group_count<G>(u * G + lane < F && k[u] <= q);
    if (FT == 0 && F > G) {  // a run-time F wider than the group
      const LevelView<T> a = level_view(lv, storage, C, next);
      for (int j0 = G; j0 < F; j0 += G)
        c += warp_group_count<G>(j0 + lane < F &&
                                 key_at(a, base + j0 + lane) <= q);
    }
    last = c > 0 ? c - 1 : 0;
    pos = base + last;
    next += 1;
  }

  // storage[pos] where the last round read it (*have); the whole warp
  // calls it after the last round.
  __device__ __forceinline__ T storage_key(int C, int F, bool* have) const {
    *have = n_below > 0 && pos < (unsigned)C && F <= G * U;
    if (!*have) return sentinel<T>();
    return group_take<G>(k, last);
  }
};

// The left half of group_bounds() a round at a time: #{i : a[i] < q} over
// a[0..n), read as P2 wide, ceil(log_G(P2)) rounds of G pivots.  A lane
// with no pivot (past the end, or beyond the round's parts) holds the
// sentinel, which is below no q.  After the last round, key() gives
// a[count] from the lane that probed it, where one did: always when
// count < n, since the window's last key, the pivot that stopped the round
// before, is probed again and is not below q, unless the window is the
// tail of the P2-wide array, where count reaching the window's end is
// count >= n.
template <typename T, int G>
struct GroupLowerBound {
  unsigned count, w, s, parts, m;  // w, s: powers of two

  __device__ __forceinline__ void start(int P2) {
    count = 0;
    w = P2;
  }

  __device__ __forceinline__ bool active() const { return w > 0; }

  __device__ __forceinline__ T issue(const T* a, int n, int lane) {
    s = w > G ? w / G : 1;
    parts = w > G ? G : w;
    const bool probe = lane < parts;  // else lane 0's pivot, left out
    const unsigned il = count + ((probe ? lane : 0) + 1) * s - 1;
    const T k = __ldg(a + (il < (unsigned)n ? il : n - 1));
    return probe && il < (unsigned)n ? k : sentinel<T>();
  }

  __device__ __forceinline__ void consume(T k, T q) {
    m = warp_group_count<G>(k < q);
    count += m * s;
    w = s > 1 ? s : 0;
  }

  // a[count] where the last round probed it (*have), from that round's
  // key k; the whole warp calls it after the last round.
  __device__ __forceinline__ T key(T k, bool* have) const {
    *have = m < parts;
    return __shfl_sync(0xffffffffu, k, *have ? m : 0, G);
  }
};
