// PI index-layer descent (the paper's Alg. 2) on Hopper, sm_90a.
//
// pi_search_kernel replaces the TPU kernel repro/kernels/pi_search.py::
// pi_search (body _descend_kernel -> _descend): the floor slot of each
// query over the gapped storage layer, -1 on underflow.
//
// pi_probe_kernel replaces repro/kernels/pi_search.py::pi_probe (body
// _probe_kernel -> _descend + _lower_bound): the same descent fused with
// the lower bound over the sorted pending buffer, giving (mpos, ppos,
// flags) in one launch.  It is the main-path kernel: every execute and
// lookup.  Both take int32 and float32 keys.
//
// What bounds them on this card: dependent loads, not bytes or compares.
// At the main path's shapes (C = 2^25, F = 8, H = 8 levels of 2^22 .. 2
// keys, PC = 2^22, B = 8192) a launch touches ~1 MB of distinct keys,
// ~0.3 us of HBM bandwidth; what it waits for is the chain of loads each
// query makes, one depending on the other: the query, the top level, one
// F-key group per lower level and for storage (9 rounds), and the pending
// bound.  The first port ran one thread per query: its pending bound, a
// binary search of 23 loads, started only after the descent, plus one
// load each for storage[mpos] and pending[ppos] -- ~34 loads in series --
// and 8192 threads filled 32 blocks, so 100 of the 132 SMs sat idle.
//
// What this design does:
// * A group of G = PI_PROBE_GROUP lanes of one warp serves a query
//   (kernels/pi_search.py::PROBE_GROUP mirrors it), so 8192 queries
//   spread over every SM.  G = 8 was the fastest of 8, 16 and 32 at 8192
//   queries (scripts/probe_study.py): one query's chain is shortest at 32,
//   but there each query takes a whole warp, and the launch's time grows
//   with the batch well before 8192 queries.
// * The descent reads a level's F-key child group in one coalesced round
//   and counts it by a ballot (GroupDescent in pi_descend.cuh, the rounds
//   of group_descend).  The pending bound is a G-ary search
//   (GroupLowerBound, the one-sided half of group_bounds): 8 rounds at
//   G = 8 and PC = 2^22, where the binary search took 23.
// * The two chains are interleaved: each round issues the descent's load
//   and the bound's, then runs both ballots, so a query waits for about
//   max(10, 8) round trips, not their sum.
// * What a round costs besides its load is cut down: the loads are
//   branch-free (an index past the end reads the last key and is replaced
//   by the sentinel); the whole warp takes part in every ballot and
//   shuffle (a group past the batch serves a copy of the last query and
//   stores nothing), so they need no divergence check; the next round's
//   level pointer is looked up a round ahead; positions are 32-bit.
// * main_match and p_hit compare keys the last rounds already read,
//   passed by a shuffle from the lane that read them.  One load is kept
//   for the cases where no lane read the key: storage[C-1] when the
//   descent ends past the storage's end (a sentinel query), and
//   storage[mpos] when the index has no level or a run-time F is wider
//   than the group.  The key at ppos is always one the bound's last round
//   probed when ppos < PC (pi_descend.cuh says why); the load beside it
//   is a guard that never runs.
// * Measured and not kept (scripts/probe_study.py, PERF.md): fewer pivots
//   a pending round than G, two levels a descent round, the top levels and
//   the first pivots in shared memory, and a grid of one block an SM were
//   each slower at the main path's shapes or changed nothing.
// Nothing is padded: an index past the end of an array reads as the
// sentinel, which is what the TPU version's padding held.
//
// What is left: the chain itself.  A round trip to L2 or HBM is ~0.4 us
// here, and a query makes ~11 of them, so one query's probe takes about
// as long as 8192; a shorter chain needs fewer rounds (a pending index
// kept beside the buffer, or the two-level rounds at a cheaper cost).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -shared -Xcompiler -fPIC (repro_torch/kernels/build.py).
// Each C entry point launches on the caller's stream, does not
// synchronise, and returns cudaGetLastError().

#include "pi_descend.cuh"

#define PI_PROBE_GROUP 8  // lanes a query: 8, 16 or 32

static_assert(PI_PROBE_GROUP == 8 || PI_PROBE_GROUP == 16 ||
                  PI_PROBE_GROUP == 32,
              "a query's group is 8, 16 or 32 lanes of one warp");

namespace {

constexpr int kG = PI_PROBE_GROUP;
constexpr int kQueries = PI_BLOCK / kG;  // queries a block serves

template <typename T, int FT>
__global__ void __launch_bounds__(PI_BLOCK)
pi_search_kernel(Levels<T> lv, const T* __restrict__ storage, int C,
                 const T* __restrict__ q, int B, int fanout,
                 int* __restrict__ out) {
  const int F = FT > 0 ? FT : fanout;
  const int lane = threadIdx.x % kG;
  // a group past the batch serves a copy of the last query, so that the
  // whole warp takes part in every ballot; it stores nothing
  const int i = blockIdx.x * kQueries + threadIdx.x / kG;
  const T qi = __ldg(q + (i < B ? i : B - 1));
  GroupDescent<T, FT, kG> d;
  d.top(lv, storage, C, qi, F, lane);
  while (d.active()) {
    d.issue(lv, storage, C, F, lane);
    d.consume(lv, storage, C, qi, F, lane);
  }
  if (lane == 0 && i < B) out[i] = d.under ? -1 : (int)d.pos;
}

template <typename T, int FT>
__global__ void __launch_bounds__(PI_BLOCK)
pi_probe_kernel(Levels<T> lv, const T* __restrict__ storage, int C,
                const T* __restrict__ pending, int PC, int P2,
                const T* __restrict__ q, int B, int fanout,
                int* __restrict__ mpos_out, int* __restrict__ ppos_out,
                int* __restrict__ flags_out) {
  const int F = FT > 0 ? FT : fanout;
  const int lane = threadIdx.x % kG;
  const int i = blockIdx.x * kQueries + threadIdx.x / kG;  // as pi_search
  const T qi = __ldg(q + (i < B ? i : B - 1));
  GroupDescent<T, FT, kG> d;
  GroupLowerBound<T, kG> b;
  b.start(P2);
  // round 0: the bound's first pivots in flight while the top is read
  T bk = b.issue(pending, PC, lane);
  d.top(lv, storage, C, qi, F, lane);
  b.consume(bk, qi);
  // then a round of each chain at a time: loads first, ballots after
  while (d.active() || b.active()) {
    const bool da = d.active(), ba = b.active();
    if (da) d.issue(lv, storage, C, F, lane);
    if (ba) bk = b.issue(pending, PC, lane);
    if (da) d.consume(lv, storage, C, qi, F, lane);
    if (ba) b.consume(bk, qi);
  }
  // the keys at mpos and ppos, from the lanes of the last rounds that read
  // them, else (see above) by a load
  bool have_m, have_p;
  const T mkey = d.storage_key(C, F, &have_m);
  const T pkey = b.key(bk, &have_p);
  if (lane != 0 || i >= B) return;
  const int mpos = d.under ? -1 : (int)d.pos;
  const int ppos = (int)b.count;
  const bool main_match =
      mpos >= 0 &&
      (have_m ? mkey : __ldg(storage + (mpos < C ? mpos : C - 1))) == qi;
  const bool p_hit =
      ppos < PC && (have_p ? pkey : __ldg(pending + ppos)) == qi;
  mpos_out[i] = mpos;
  ppos_out[i] = ppos;
  flags_out[i] = (main_match ? 1 : 0) | (p_hit ? 2 : 0);
}

unsigned grid_for(int B) { return (unsigned)((B + kQueries - 1) / kQueries); }

template <typename T, int FT>
int search_f(const Levels<T>& lv, const T* st, int C, const T* q, int B,
             int fanout, int* out, cudaStream_t s) {
  pi_search_kernel<T, FT><<<grid_for(B), PI_BLOCK, 0, s>>>(lv, st, C, q, B,
                                                           fanout, out);
  return (int)cudaGetLastError();
}

template <typename T, int FT>
int probe_f(const Levels<T>& lv, const T* st, int C, const T* pk, int PC,
            int P2, const T* q, int B, int fanout, int* a, int* b, int* c,
            cudaStream_t s) {
  pi_probe_kernel<T, FT><<<grid_for(B), PI_BLOCK, 0, s>>>(
      lv, st, C, pk, PC, P2, q, B, fanout, a, b, c);
  return (int)cudaGetLastError();
}

// The kernels' loads read an array's last key for an index past its end
// (key_at), so every level holds at least one key.
template <typename T>
bool make_read_levels(Levels<T>* lv, const void* const* ptrs, const int* lens,
                      int n) {
  if (!make_levels(lv, ptrs, lens, n)) return false;
  for (int l = 0; l < n; ++l)
    if (lens[l] < 1) return false;
  return true;
}

template <typename T>
int launch_search(const void* const* level_ptrs, const int* level_lens,
                  int n_levels, const void* storage, int C, const void* q,
                  int B, int fanout, void* out, void* stream) {
  Levels<T> lv;
  if (!make_read_levels(&lv, level_ptrs, level_lens, n_levels) ||
      fanout < 2 || C < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* st = static_cast<const T*>(storage);
  const T* qq = static_cast<const T*>(q);
  int* o = static_cast<int*>(out);
  switch (fanout) {
    case 2: return search_f<T, 2>(lv, st, C, qq, B, fanout, o, s);
    case 4: return search_f<T, 4>(lv, st, C, qq, B, fanout, o, s);
    case 8: return search_f<T, 8>(lv, st, C, qq, B, fanout, o, s);
    case 16: return search_f<T, 16>(lv, st, C, qq, B, fanout, o, s);
    default: return search_f<T, 0>(lv, st, C, qq, B, fanout, o, s);
  }
}

template <typename T>
int launch_probe(const void* const* level_ptrs, const int* level_lens,
                 int n_levels, const void* storage, int C,
                 const void* pending, int PC, const void* q, int B,
                 int fanout, void* mpos, void* ppos, void* flags,
                 void* stream) {
  Levels<T> lv;
  if (!make_read_levels(&lv, level_ptrs, level_lens, n_levels) ||
      fanout < 2 || PC < 1 || C < 1)
    return (int)cudaErrorInvalidValue;
  const int P2 = pow2_at_least(PC);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* st = static_cast<const T*>(storage);
  const T* pk = static_cast<const T*>(pending);
  const T* qq = static_cast<const T*>(q);
  int* a = static_cast<int*>(mpos);
  int* b = static_cast<int*>(ppos);
  int* c = static_cast<int*>(flags);
  switch (fanout) {
    case 2: return probe_f<T, 2>(lv, st, C, pk, PC, P2, qq, B, fanout, a, b, c, s);
    case 4: return probe_f<T, 4>(lv, st, C, pk, PC, P2, qq, B, fanout, a, b, c, s);
    case 8: return probe_f<T, 8>(lv, st, C, pk, PC, P2, qq, B, fanout, a, b, c, s);
    case 16: return probe_f<T, 16>(lv, st, C, pk, PC, P2, qq, B, fanout, a, b, c, s);
    default: return probe_f<T, 0>(lv, st, C, pk, PC, P2, qq, B, fanout, a, b, c, s);
  }
}

}  // namespace

// ---------------------------------------------------------------------------
// host entry points (plain C interface, loaded with ctypes)
// ---------------------------------------------------------------------------

extern "C" {

int pi_search_i32(const void* const* level_ptrs, const int* level_lens,
                  int n_levels, const void* storage, int C, const void* q,
                  int B, int fanout, void* out, void* stream) {
  return launch_search<int>(level_ptrs, level_lens, n_levels, storage, C, q,
                            B, fanout, out, stream);
}

int pi_search_f32(const void* const* level_ptrs, const int* level_lens,
                  int n_levels, const void* storage, int C, const void* q,
                  int B, int fanout, void* out, void* stream) {
  return launch_search<float>(level_ptrs, level_lens, n_levels, storage, C,
                              q, B, fanout, out, stream);
}

int pi_probe_i32(const void* const* level_ptrs, const int* level_lens,
                 int n_levels, const void* storage, int C,
                 const void* pending, int PC, const void* q, int B,
                 int fanout, void* mpos, void* ppos, void* flags,
                 void* stream) {
  return launch_probe<int>(level_ptrs, level_lens, n_levels, storage, C,
                           pending, PC, q, B, fanout, mpos, ppos, flags,
                           stream);
}

int pi_probe_f32(const void* const* level_ptrs, const int* level_lens,
                 int n_levels, const void* storage, int C,
                 const void* pending, int PC, const void* q, int B,
                 int fanout, void* mpos, void* ppos, void* flags,
                 void* stream) {
  return launch_probe<float>(level_ptrs, level_lens, n_levels, storage, C,
                             pending, PC, q, B, fanout, mpos, ppos, flags,
                             stream);
}

}  // extern "C"
