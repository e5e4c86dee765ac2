// Bitonic sort of (key, value) query batches on Hopper, sm_90a.
//
// What it replaces: the TPU kernel repro/kernels/bitonic_sort.py::
// bitonic_sort (body _bitonic_kernel -> _stage), an ascending sort of a
// power-of-two batch of (key, value) pairs in lexicographic (key, value)
// order, int32 or float32 keys and int32 values.  The output is unique for
// that order, so any correct run of the network gives the TPU kernel's
// bits.  NaN keys and the sign of a zero float key are out of scope, as in
// the JAX tests.  Entry points:
// * bitonic_sort: the function itself (kernels/bitonic_sort.py);
// * bitonic_argsort: the cuda engine's batch sort (core/engine.py::
//   SearchEngine.sort_queries) -- B real keys of any count, the arrival
//   index made in registers as the value, the int64 permutation of the
//   first B lanes written out.  Lanes past B are padding that sorts after
//   every real lane, so this is the stable argsort;
// * launch_floor: an empty kernel, whose device time is the floor any
//   launch of this card pays (the bound below is under it at 8192 pairs).
//
// What bounds it: not bytes (a window of 8192 pairs is 64 KB in and 64 KB
// out, ~0.04 us of HBM bandwidth) but the network's dependent depth,
// log2(B)(log2(B)+1)/2 compare-exchange steps (91 at B = 8192), run by
// the one SM that holds the batch, and what each step costs there: a
// block-wide barrier and a shared-memory round trip per step in a simple
// design; here the instructions of the exchanges themselves.
//
// What this design does:
// * A pair packs into one order-preserving 64-bit word: the key's bits
//   made unsigned-monotone (int32: sign bit flipped; float32: all bits
//   flipped when negative, else the sign bit set) above the value with its
//   sign bit flipped.  A compare-exchange is one 64-bit compare and two
//   selects, branchless; the key's bits come back unchanged on the way out.
// * A block holds a tile of T = 2^LOG_T words, R = 2^LOG_R in each
//   thread's registers: element p = (thread << LOG_R) | r in layout A.
//   Strides below R are register compare-exchanges, strides inside a
//   warp's span (R .. 32R) __shfl_xor_sync with no barrier.  Strides above
//   the warp's span run in layout B, which swaps those W = LOG_T - LOG_R -
//   5 high bits of p with its low bits: one transpose through shared
//   memory puts all of a stage's large strides in registers (or lanes),
//   one more brings layout A back.  The two buffers alternate, so a
//   transpose is one __syncthreads().  Word L sits at L with its low
//   nibble XORed by the higher ones, so every half-warp access, coalesced
//   or in either layout, meets 16 distinct bank pairs.
// * The network is unrolled at compile time by template recursion over
//   stages and strides: register indices, layouts and every element's
//   direction are constants, and a stage costs no loop or index
//   arithmetic.
// * Two kernels.  bitonic_sort_kernel runs whole stages [s0, LOG_T) on
//   contiguous tiles: one block sorts a batch of up to 8192 pairs in one
//   launch, padded to the smallest tile (2^9, 2^11, 2^12, 2^13) that holds
//   it.  At B = 8192 (R = 16, 512 threads): one barrier to load, two for
//   each of the 4 stages above the warp's span, one to store -- 10
//   block-wide barriers, not 91.  bitonic_merge_kernel runs one stage's
//   strides from the tile's top bit down, the stage's direction bit above
//   the tile; its tile may gather runs of 2^j contiguous words across
//   LOG_T - j stride bits.
// * A larger batch is a list of passes over a packed scratch array of
//   2^log_n words: a first sort of tiles small enough to give each SM a
//   block, then for each later stage one multi-stride merge pass over its
//   strides at or above the tile and one merge pass over contiguous tiles
//   for the rest.  2^20 pairs take 16 launches (a launch per stride above
//   the tile would take 28).  The plan is made in one place,
//   kernels/bitonic_sort.py::pass_plan, and handed here as an int array:
//   one C call per sort.  Each pass reads and writes every word once,
//   which bounds the batches of many passes.
//
// Build and interface as pi_search.cu: plain C entry points that launch on
// the caller's stream, do not synchronise, and return cudaGetLastError()
// of the first launch that fails (cudaSuccess otherwise).

#include <cuda_runtime.h>

typedef unsigned long long u64;

namespace {

constexpr u64 PAD = ~0ull;   // above every real lane: sorts last
constexpr int PASS_FIELDS = 8;

enum { IN_PACKED = 0, IN_PAIRS = 1, IN_IOTA = 2 };
enum { OUT_PACKED = 0, OUT_PAIRS = 1, OUT_PERM = 2 };

// One pass (kernels/bitonic_sort.py::pass_plan): from stage s0 on, the
// strides down to global index bit `bottom`, on tiles whose local bits
// [0, j) are the global bits [0, j) and whose local bits [j, LOG_T) are
// the global bits [h, h + LOG_T - j); the block's index fills the other
// global bits.
struct PassArgs {
  const unsigned* kin;   // key bits (IN_PAIRS, IN_IOTA)
  const int* vin;        // values (IN_PAIRS)
  unsigned* kout;        // key bits (OUT_PAIRS)
  int* vout;             // values (OUT_PAIRS)
  long long* perm;       // OUT_PERM
  u64* scratch;          // packed words of every lane (IN/OUT_PACKED)
  unsigned n_real;       // lanes below it are read from the input
  int in_mode, out_mode, is_float;
  int s0, bottom, j, h;
};

__device__ __forceinline__ u64 pack(unsigned key, unsigned val,
                                    int is_float) {
  const unsigned k = is_float
      ? ((key & 0x80000000u) ? ~key : (key | 0x80000000u))
      : (key ^ 0x80000000u);
  return ((u64)k << 32) | (val ^ 0x80000000u);
}

__device__ __forceinline__ unsigned key_of(u64 w, int is_float) {
  const unsigned k = (unsigned)(w >> 32);
  return is_float ? ((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k)
                  : (k ^ 0x80000000u);
}

__device__ __forceinline__ int val_of(u64 w) {
  return (int)((unsigned)w ^ 0x80000000u);
}

template <int LOG_R, int LOG_T>
struct Shape {
  static constexpr int R = 1 << LOG_R;
  static constexpr int T = 1 << LOG_T;
  static constexpr int THREADS = T >> LOG_R;
  static constexpr int LANE_END = LOG_R + 5;   // p bits [LOG_R, LANE_END)
  static constexpr int W = LOG_T > LANE_END ? LOG_T - LANE_END : 0;
  static constexpr int SMEM = 2 * T * (int)sizeof(u64);   // two buffers
  static_assert(W <= LANE_END, "layout B swaps disjoint bit fields");
  static_assert(LOG_T <= 16, "the swizzle folds four nibbles");
  static_assert(THREADS >= 32, "a tile fills at least one warp");

  // Layout B: p's bits [0, W) and [LANE_END, LOG_T) swapped.
  __device__ static __forceinline__ unsigned sigma(unsigned p) {
    if (W == 0) return p;
    constexpr unsigned low = (1u << W) - 1;
    return (p & ~(low | (low << LANE_END))) | ((p & low) << LANE_END) |
           (p >> LANE_END);
  }
  // The bit of p that holds local bit q in layout B.
  __host__ __device__ static constexpr int sigma_bit(int q) {
    return q < W ? q + LANE_END : (q >= LANE_END ? q - LANE_END : q);
  }
  // Where word L lives in a buffer: its low nibble XORed with its higher
  // ones, so the bank pair of a word is the XOR of all its nibbles.  Any
  // four lanes bits that land on L bits of four residues mod 4 then give
  // a half-warp 16 distinct bank pairs: the coalesced rows (L bits 0-3),
  // layout A (LOG_R .. LOG_R + 3) and layout B (the same, or some moved up
  // by LANE_END into the residues they leave).
  __device__ static __forceinline__ unsigned swizzle(unsigned L) {
    return L ^ (((L >> 4) ^ (L >> 8) ^ (L >> 12)) & 15u);
  }
};

// Whether the element in register r ascends: PD is the bit of p that
// holds the stage's direction bit (PD < 0: above the tile, where the
// block-wide `desc` decides); `thread_up` is the thread's share of it.
template <int LOG_R, int PD>
__device__ __forceinline__ bool ascends(int r, bool thread_up) {
  if constexpr (PD >= 0 && PD < LOG_R)
    return ((r >> PD) & 1) == 0;
  else
    return thread_up;
}

template <int LOG_R, int PD>
__device__ __forceinline__ bool thread_ascends(unsigned tp, bool desc) {
  if constexpr (PD < 0)
    return !desc;
  else
    return ((tp >> PD) & 1) == 0;   // unused where PD < LOG_R
}

// Pairs (r, r | 2^Q) of every thread's registers.
template <int LOG_R, int Q, int PD>
__device__ __forceinline__ void ce_regs(u64 (&x)[1 << LOG_R], unsigned tp,
                                        bool desc) {
  const bool thread_up = thread_ascends<LOG_R, PD>(tp, desc);
#pragma unroll
  for (int r = 0; r < (1 << LOG_R); ++r) {
    if (r & (1 << Q)) continue;
    const int s = r | (1 << Q);
    const u64 a = x[r], b = x[s];
    const bool swap = (a > b) == ascends<LOG_R, PD>(r, thread_up);
    x[r] = swap ? b : a;
    x[s] = swap ? a : b;
  }
}

// Partners in lane ^ 2^QL, register r of both: the lower lane keeps the
// min where ascending.  Every shuffle is issued before the first select.
template <int LOG_R, int QL, int PD>
__device__ __forceinline__ void ce_lanes(u64 (&x)[1 << LOG_R], unsigned tp,
                                         unsigned lane, bool desc) {
  constexpr int R = 1 << LOG_R;
  const bool thread_up = thread_ascends<LOG_R, PD>(tp, desc);
  const bool lower = (lane & (1u << QL)) == 0;
  u64 o[R];
#pragma unroll
  for (int r = 0; r < R; ++r)
    o[r] = __shfl_xor_sync(0xffffffffu, x[r], 1u << QL);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const bool keep_min = lower == ascends<LOG_R, PD>(r, thread_up);
    x[r] = ((o[r] < x[r]) == keep_min) ? o[r] : x[r];
  }
}

// The stride at local bit Q in layout IN_B, direction bit D of the tile
// (D < 0: above it).
template <int LOG_R, int LOG_T, bool IN_B, int Q, int D>
__device__ __forceinline__ void stride(u64 (&x)[1 << LOG_R], unsigned tp,
                                       unsigned lane, bool desc) {
  using S = Shape<LOG_R, LOG_T>;
  constexpr int QP = IN_B ? S::sigma_bit(Q) : Q;
  constexpr int PD = D < 0 ? -1 : (IN_B ? S::sigma_bit(D) : D);
  if constexpr (QP < LOG_R)
    ce_regs<LOG_R, QP, PD>(x, tp, desc);
  else
    ce_lanes<LOG_R, QP - LOG_R, PD>(x, tp, lane, desc);
}

template <int LOG_R, int LOG_T>
__device__ __forceinline__ void read_regs(u64 (&x)[1 << LOG_R],
                                          const u64* buf, unsigned tp,
                                          bool in_b) {
  using S = Shape<LOG_R, LOG_T>;
#pragma unroll
  for (int r = 0; r < S::R; ++r)
    x[r] = buf[S::swizzle(in_b ? S::sigma(tp | r) : (tp | r))];
}

template <int LOG_R, int LOG_T>
__device__ __forceinline__ void write_regs(const u64 (&x)[1 << LOG_R],
                                           u64* buf, unsigned tp,
                                           bool in_b) {
  using S = Shape<LOG_R, LOG_T>;
#pragma unroll
  for (int r = 0; r < S::R; ++r)
    buf[S::swizzle(in_b ? S::sigma(tp | r) : (tp | r))] = x[r];
}

// From one layout to the other through `buf`: one barrier.  Buffer 0
// holds the loaded tile, buffer 1 the first change of layout; the two
// alternate from there, and the stored tile takes the one not read last:
// a buffer is written only after a barrier that follows its last read.
template <int LOG_R, int LOG_T, bool TO_B>
__device__ __forceinline__ void relayout(u64 (&x)[1 << LOG_R], u64* buf,
                                         unsigned tp) {
  write_regs<LOG_R, LOG_T>(x, buf, tp, !TO_B);
  __syncthreads();
  read_regs<LOG_R, LOG_T>(x, buf, tp, TO_B);
}

// The words of one tile, read coalesced into buffer 0 of shared memory.
template <int LOG_R, int LOG_T, typename Index>
__device__ __forceinline__ void load_tile(const PassArgs& a, u64* smem,
                                          Index index) {
  using S = Shape<LOG_R, LOG_T>;
#pragma unroll
  for (int k = 0; k < S::R; ++k) {
    const unsigned L = k * S::THREADS + threadIdx.x;
    const unsigned i = index(L);
    u64 w = PAD;
    if (a.in_mode == IN_PACKED)
      w = a.scratch[i];
    else if (i < a.n_real)
      w = pack(a.kin[i], a.in_mode == IN_PAIRS ? (unsigned)a.vin[i] : i,
               a.is_float);
    smem[S::swizzle(L)] = w;
  }
  __syncthreads();
}

// The registers through `buf` back to global memory, coalesced.
template <int LOG_R, int LOG_T, typename Index>
__device__ __forceinline__ void store_tile(const PassArgs& a,
                                           const u64 (&x)[1 << LOG_R],
                                           u64* buf, bool in_b, unsigned tp,
                                           Index index) {
  using S = Shape<LOG_R, LOG_T>;
  write_regs<LOG_R, LOG_T>(x, buf, tp, in_b);
  __syncthreads();
#pragma unroll
  for (int k = 0; k < S::R; ++k) {
    const unsigned L = k * S::THREADS + threadIdx.x;
    const unsigned i = index(L);
    const u64 w = buf[S::swizzle(L)];
    if (a.out_mode == OUT_PACKED) {
      a.scratch[i] = w;
    } else if (i < a.n_real) {
      if (a.out_mode == OUT_PAIRS) {
        a.kout[i] = key_of(w, a.is_float);
        a.vout[i] = val_of(w);
      } else {
        a.perm[i] = val_of(w);
      }
    }
  }
}

// Strides Q .. 0 of stage S of the sort kernel.  A stage above the warp's
// span changes to layout B before its first stride and back to A before
// stride W - 1; every stage starts and ends in layout A.
template <int LOG_R, int LOG_T, int S, int Q>
__device__ __forceinline__ void sort_strides(u64 (&x)[1 << LOG_R],
                                             u64* smem, unsigned tp,
                                             unsigned lane, bool desc) {
  using Sh = Shape<LOG_R, LOG_T>;
  constexpr bool HIGH = S >= Sh::LANE_END;
  if constexpr (HIGH && Q == S)
    relayout<LOG_R, LOG_T, true>(x, smem + Sh::T, tp);
  if constexpr (HIGH && Q == Sh::W - 1)
    relayout<LOG_R, LOG_T, false>(x, smem, tp);
  constexpr int D = S + 1 < LOG_T ? S + 1 : -1;   // the direction bit
  stride<LOG_R, LOG_T, (HIGH && Q >= Sh::W), Q, D>(x, tp, lane, desc);
  if constexpr (Q > 0)
    sort_strides<LOG_R, LOG_T, S, Q - 1>(x, smem, tp, lane, desc);
}

template <int LOG_R, int LOG_T, int S>
__device__ __forceinline__ void sort_stages(u64 (&x)[1 << LOG_R], u64* smem,
                                            unsigned tp, unsigned lane,
                                            bool desc, int s0) {
  if (S >= s0) sort_strides<LOG_R, LOG_T, S, S>(x, smem, tp, lane, desc);
  if constexpr (S + 1 < LOG_T)
    sort_stages<LOG_R, LOG_T, S + 1>(x, smem, tp, lane, desc, s0);
}

// Strides at local bits Q .. lo of a merge pass, from layout B (layout A
// where the tile has no bit above the warp's span).
template <int LOG_R, int LOG_T, int Q>
__device__ __forceinline__ void merge_strides(u64 (&x)[1 << LOG_R],
                                              u64* smem, unsigned tp,
                                              unsigned lane, bool desc,
                                              int lo) {
  using Sh = Shape<LOG_R, LOG_T>;
  if (Q < lo) return;
  if constexpr (Sh::W > 0 && Q == Sh::W - 1)
    relayout<LOG_R, LOG_T, false>(x, smem + Sh::T, tp);
  stride<LOG_R, LOG_T, (Sh::W > 0 && Q >= Sh::W), Q, -1>(x, tp, lane,
                                                         desc);
  if constexpr (Q > 0)
    merge_strides<LOG_R, LOG_T, Q - 1>(x, smem, tp, lane, desc, lo);
}

// Stages [a.s0, LOG_T) of the network, every stride, on contiguous tiles
// (block b holds lanes [b T, (b + 1) T)): the one-block sort, and the
// first passes of a larger batch.
template <int LOG_R, int LOG_T>
__global__ void __launch_bounds__(Shape<LOG_R, LOG_T>::THREADS)
bitonic_sort_kernel(PassArgs a) {
  using S = Shape<LOG_R, LOG_T>;
  extern __shared__ u64 smem[];
  const unsigned tp = threadIdx.x << LOG_R, lane = threadIdx.x & 31;
  const unsigned base = blockIdx.x << LOG_T;
  auto index = [&](unsigned L) { return base | L; };
  load_tile<LOG_R, LOG_T>(a, smem, index);
  u64 x[S::R];
  read_regs<LOG_R, LOG_T>(x, smem, tp, false);
  const bool desc = (base >> LOG_T) & 1;   // of the last stage
  sort_stages<LOG_R, LOG_T, 0>(x, smem, tp, lane, desc, a.s0);
  store_tile<LOG_R, LOG_T>(a, x, smem + S::T, false, tp, index);
}

// One stage s = a.s0 whose direction bit lies above the tile: its strides
// at the tile's local bits LOG_T - 1 down to local_bit(a.bottom), on tiles
// of global bits [0, j) and [h, h + LOG_T - j).  The multi-stride passes
// (j < LOG_T) and the rest of each stage (contiguous tiles, down to bit 0).
template <int LOG_R, int LOG_T>
__global__ void __launch_bounds__(Shape<LOG_R, LOG_T>::THREADS)
bitonic_merge_kernel(PassArgs a) {
  using S = Shape<LOG_R, LOG_T>;
  extern __shared__ u64 smem[];
  const unsigned tp = threadIdx.x << LOG_R, lane = threadIdx.x & 31;
  const int j = a.j, h = a.h, mid = h - j;
  const unsigned blk = blockIdx.x;
  const unsigned base = ((blk & ((1u << mid) - 1)) << j) |
                        ((blk >> mid) << (h + LOG_T - j));
  const unsigned low = (1u << j) - 1;
  auto index = [&](unsigned L) { return base | (L & low) | ((L >> j) << h); };
  load_tile<LOG_R, LOG_T>(a, smem, index);
  const int lo = a.bottom < j ? a.bottom : a.bottom - h + j;
  const bool desc = (base >> (a.s0 + 1)) & 1;
  u64 x[S::R];
  read_regs<LOG_R, LOG_T>(x, smem, tp, S::W > 0);
  merge_strides<LOG_R, LOG_T, LOG_T - 1>(x, smem, tp, lane, desc, lo);
  const bool to_a = S::W > 0 && lo < S::W;   // merge_strides changed
  store_tile<LOG_R, LOG_T>(a, x, smem + (to_a ? 0 : S::T),
                           S::W > 0 && !to_a, tp, index);
}

// A launch of `kernel`, its shared-memory limit raised once per device
// (`ready` holds a bit for each device it was raised on).
template <typename Kernel>
cudaError_t launch(Kernel kernel, unsigned& ready, int threads, int smem,
                   const PassArgs& a, unsigned blocks, cudaStream_t s) {
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return e;
  const unsigned bit = 1u << (device & 31);
  if (!(ready & bit)) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e != cudaSuccess) return e;
    ready |= bit;
  }
  kernel<<<blocks, threads, smem, s>>>(a);
  return cudaGetLastError();
}

template <int LOG_R, int LOG_T>
cudaError_t launch_tile(const PassArgs& a, bool sort, int log_n,
                        cudaStream_t s) {
  using S = Shape<LOG_R, LOG_T>;
  static unsigned ready[2];
  const unsigned blocks = 1u << (log_n - LOG_T);
  return sort ? launch(bitonic_sort_kernel<LOG_R, LOG_T>, ready[0],
                       S::THREADS, S::SMEM, a, blocks, s)
              : launch(bitonic_merge_kernel<LOG_R, LOG_T>, ready[1],
                       S::THREADS, S::SMEM, a, blocks, s);
}

// The tiles the plan may name, (LOG_R, LOG_T).
#define BITONIC_TILES(X) X(2, 9) X(3, 11) X(4, 12) X(4, 13)

cudaError_t launch_pass(const PassArgs& a, int log_r, int log_t, bool sort,
                        int log_n, cudaStream_t s) {
#define BITONIC_CASE(R, T) \
  if (log_r == R && log_t == T) return launch_tile<R, T>(a, sort, log_n, s);
  BITONIC_TILES(BITONIC_CASE)
#undef BITONIC_CASE
  return cudaErrorInvalidValue;
}

// Every pass of `plan` (PASS_FIELDS ints each: log_r, log_t, s0, s1, top,
// bottom, j, h; kernels/bitonic_sort.py::pass_plan): the first reads the
// input, the last writes the output, the others work in place on the
// packed scratch of 2^log_n words.  A pass is one of the two kernels'.
int run_plan(PassArgs a, int n, int log_n, const int* plan, int n_passes,
             int in_mode, int out_mode, void* stream) {
  if (n < 1 || log_n < 1 || log_n > 30 || n > (1 << log_n) || n_passes < 1 ||
      (n_passes > 1 && a.scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  a.n_real = (unsigned)n;
  for (int p = 0; p < n_passes; ++p) {
    const int* f = plan + p * PASS_FIELDS;
    const int log_t = f[1], s0 = f[2], s1 = f[3], top = f[4], bottom = f[5],
              j = f[6], h = f[7], high = h + log_t - j;
    const bool sort = j == log_t && h == log_t && 0 <= s0 && s0 < s1 &&
                      s1 == log_t && bottom == 0 && top >= s1 - 1;
    const bool merge = s1 == s0 + 1 && top == high - 1 && s0 + 1 >= high &&
                       0 <= bottom && bottom <= top &&
                       (bottom < j || bottom >= h);
    if (log_t > log_n || high > log_n || j > h || !(sort || merge))
      return (int)cudaErrorInvalidValue;
    a.in_mode = p == 0 ? in_mode : IN_PACKED;
    a.out_mode = p == n_passes - 1 ? out_mode : OUT_PACKED;
    a.s0 = s0;
    a.bottom = bottom;
    a.j = j;
    a.h = h;
    const cudaError_t e = launch_pass(a, f[0], log_t, sort, log_n, s);
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaSuccess;
}

__global__ void launch_floor_kernel() {}

}  // namespace

extern "C" {

int bitonic_sort(const void* keys, const void* vals, void* keys_out,
                 void* vals_out, void* scratch, int n, int log_n,
                 int is_float, const int* plan, int n_passes, void* stream) {
  PassArgs a{};
  a.kin = static_cast<const unsigned*>(keys);
  a.vin = static_cast<const int*>(vals);
  a.kout = static_cast<unsigned*>(keys_out);
  a.vout = static_cast<int*>(vals_out);
  a.scratch = static_cast<u64*>(scratch);
  a.is_float = is_float;
  return run_plan(a, n, log_n, plan, n_passes, IN_PAIRS, OUT_PAIRS, stream);
}

int bitonic_argsort(const void* keys, void* perm, void* scratch, int n,
                    int log_n, int is_float, const int* plan, int n_passes,
                    void* stream) {
  PassArgs a{};
  a.kin = static_cast<const unsigned*>(keys);
  a.perm = static_cast<long long*>(perm);
  a.scratch = static_cast<u64*>(scratch);
  a.is_float = is_float;
  return run_plan(a, n, log_n, plan, n_passes, IN_IOTA, OUT_PERM, stream);
}

int launch_floor(void* stream) {
  launch_floor_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}

}  // extern "C"
