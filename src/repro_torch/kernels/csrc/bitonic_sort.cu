// Bitonic sort of (key, value) query batches on Hopper, sm_90a.
//
// bitonic_sort_i32 / bitonic_sort_f32 replace the TPU kernel
// repro/kernels/bitonic_sort.py::bitonic_sort (body _bitonic_kernel ->
// _stage): an ascending sort of a power-of-two batch of (key, value) pairs,
// key ties broken by value -- the lexicographic order.  The port's batch
// sort packs the arrival index into the value lane, so the network gives
// the stable order of the paper's Def. 3; on the cuda backend every
// execute runs it once (core/engine.py::SearchEngine.sort_queries).
//
// The network is the TPU kernel's: for stage = 0 .. log2(B)-1 the
// direction block is 2^(stage+1), and for each stride 2^stage .. 1 every
// pair (i, i ^ stride) is compare-exchanged, ascending where
// (i & direction block) == 0.  _stage computes each lane's min or max from
// its partner; here one thread owns the pair and swaps both lanes when
// the pair is out of lexicographic order, which gives the same lanes.
// Keys compare as values of their type; NaN keys are out of scope, as in
// the JAX tests, and so is the sign of a zero float key.
//
// What bounds it on this card: not bytes (a window of 8192 pairs is 64 KB
// in and 64 KB out, ~0.04 us of HBM bandwidth) but the network's depth:
// log2(B)(log2(B)+1)/2 dependent stages (91 at B = 8192), each a round of
// shared-memory compare-exchanges behind a barrier.
//
// What this simple design does:
// * A batch of up to BS_TILE pairs sorts in one block, in one launch: the
//   pairs sit in dynamic shared memory (8 B a pair, 128 KB at BS_TILE =
//   16384, under the 227 KB a block may have after cudaFuncSetAttribute),
//   1024 threads each take B/2/1024 pairs a stage, __syncthreads() between
//   stages.
// * A larger batch first sorts each BS_TILE tile in shared memory in the
//   direction the network gives it; then, for each later stage, every
//   stride of at least BS_TILE is one launch over global memory (one
//   thread per pair), and the strides below it run in shared memory, tile
//   by tile, in one more launch.  B = 2^20 takes 28 launches.
// * Warp shuffles for strides below 32, register-resident sub-sorts and
//   merge-path designs are left for later work.
//
// Build and interface as pi_search.cu: plain C entry points that launch on
// the caller's stream, do not synchronise, and return cudaGetLastError()
// of the first launch that fails (cudaSuccess otherwise).  The first
// launch reads the inputs; every later one works in place on the outputs.

#include <cuda_runtime.h>

constexpr int BS_THREADS = 1024;         // threads of a shared-memory block
constexpr int BS_TILE = 16384;           // pairs a block holds (128 KB)
constexpr int BS_GLOBAL_THREADS = 256;   // threads of a global-stride block

// The pair (i, j), i < j, in ascending order when `up`, else descending.
template <typename K>
__device__ __forceinline__ void compare_exchange(K* k, int* v, long long i,
                                                 long long j, bool up) {
  const K ki = k[i], kj = k[j];
  const int vi = v[i], vj = v[j];
  const bool greater = ki > kj || (ki == kj && vi > vj);
  if (greater == up) {
    k[i] = kj;
    k[j] = ki;
    v[i] = vj;
    v[j] = vi;
  }
}

// Lower lane of the p-th pair at distance `stride` (a power of two).
__device__ __forceinline__ long long pair_lane(long long p, long long stride) {
  return 2 * p - (p & (stride - 1));
}

// One tile of `tile` pairs in shared memory: stages [stage_begin,
// stage_end) of the network, each with the strides min(2^stage,
// stride_cap) .. 1.  Directions follow the global lane index.  The tile is
// read whole before anything is written, so `kin` may be `kout`.
template <typename K>
__global__ void __launch_bounds__(BS_THREADS)
bitonic_tile_kernel(const K* kin, const int* vin, K* kout, int* vout,
                    int tile, int stage_begin, int stage_end,
                    int stride_cap) {
  extern __shared__ unsigned char smem[];
  K* sk = reinterpret_cast<K*>(smem);
  int* sv = reinterpret_cast<int*>(sk + tile);
  const long long base = (long long)blockIdx.x * tile;
  for (int t = threadIdx.x; t < tile; t += blockDim.x) {
    sk[t] = kin[base + t];
    sv[t] = vin[base + t];
  }
  __syncthreads();
  const int half = tile >> 1;
  for (int stage = stage_begin; stage < stage_end; ++stage) {
    const long long dir = 2LL << stage;
    int stride = 1 << stage;
    if (stride > stride_cap) stride = stride_cap;
    for (; stride > 0; stride >>= 1) {
      for (int p = threadIdx.x; p < half; p += blockDim.x) {
        const long long i = pair_lane(p, stride);
        compare_exchange(sk, sv, i, i + stride, ((base + i) & dir) == 0);
      }
      __syncthreads();
    }
  }
  for (int t = threadIdx.x; t < tile; t += blockDim.x) {
    kout[base + t] = sk[t];
    vout[base + t] = sv[t];
  }
}

// One stride of one stage over the whole batch in global memory.
template <typename K>
__global__ void __launch_bounds__(BS_GLOBAL_THREADS)
bitonic_global_kernel(K* k, int* v, long long n_pairs, long long stride,
                      long long dir) {
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n_pairs) return;
  const long long i = pair_lane(p, stride);
  compare_exchange(k, v, i, i + stride, (i & dir) == 0);
}

template <typename K>
static int bitonic_sort(const void* keys, const void* vals, void* keys_out,
                        void* vals_out, int B, void* stream) {
  if (B < 2 || (B & (B - 1)) != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  K* ko = static_cast<K*>(keys_out);
  int* vo = static_cast<int*>(vals_out);
  const int tile = B < BS_TILE ? B : BS_TILE;
  int log_b = 0, log_t = 0;
  while ((1LL << log_b) < B) ++log_b;
  while ((1 << log_t) < tile) ++log_t;
  const int smem = tile * (int)(sizeof(K) + sizeof(int));
  cudaError_t e = cudaFuncSetAttribute(
      bitonic_tile_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return (int)e;
  const int threads = tile / 2 < BS_THREADS ? tile / 2 : BS_THREADS;
  const int tiles = B / tile;
  // every stage whose direction blocks lie inside one tile, all strides
  bitonic_tile_kernel<K><<<tiles, threads, smem, s>>>(
      static_cast<const K*>(keys), static_cast<const int*>(vals), ko, vo,
      tile, 0, log_t, tile);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  const long long n_pairs = B / 2;
  const int grid = (int)((n_pairs + BS_GLOBAL_THREADS - 1) /
                         BS_GLOBAL_THREADS);
  for (int stage = log_t; stage < log_b; ++stage) {
    const long long dir = 2LL << stage;
    for (long long stride = 1LL << stage; stride >= tile; stride >>= 1) {
      bitonic_global_kernel<K><<<grid, BS_GLOBAL_THREADS, 0, s>>>(
          ko, vo, n_pairs, stride, dir);
      if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    }
    bitonic_tile_kernel<K><<<tiles, threads, smem, s>>>(
        ko, vo, ko, vo, tile, stage, stage + 1, tile / 2);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  }
  return (int)cudaSuccess;
}

extern "C" {

int bitonic_sort_i32(const void* keys, const void* vals, void* keys_out,
                     void* vals_out, int B, void* stream) {
  return bitonic_sort<int>(keys, vals, keys_out, vals_out, B, stream);
}

int bitonic_sort_f32(const void* keys, const void* vals, void* keys_out,
                     void* vals_out, int B, void* stream) {
  return bitonic_sort<float>(keys, vals, keys_out, vals_out, B, stream);
}

}  // extern "C"
