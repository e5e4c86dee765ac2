// PI index-layer descent (the paper's Alg. 2) on Hopper, sm_90a.
//
// pi_search_kernel replaces the TPU kernel repro/kernels/pi_search.py::
// pi_search (body _descend_kernel -> _descend): the floor slot of each
// query over the gapped storage layer, -1 on underflow.
//
// pi_probe_kernel replaces repro/kernels/pi_search.py::pi_probe (body
// _probe_kernel -> _descend + _lower_bound): the same descent fused with
// a lower bound over the sorted pending buffer, giving (mpos, ppos, flags)
// in one launch.  It is the main-path kernel: every execute and lookup.
//
// What bounds it on this card: nothing but dependent gathers.  A query
// reads the top level (<= F keys), then one F-key group per lower level
// and per storage (H+1 levels of F x 4 B), then about log2(PC) single
// keys of the pending buffer, each load depending on the one before.  At
// the main path's shapes (C = 2^25, F = 8, H = 8, PC = 2^22, B = 8192)
// that is ~3 MB of distinct bytes per launch -- about a microsecond of
// HBM bandwidth -- so the kernel is bound by load latency and L2 hit
// rate, not by bandwidth or arithmetic (there is no tensor-core math).
//
// What this simple design does: one thread per query, keys read through
// the read-only path (__ldg), the F-wide compare unrolled for F in
// {2, 4, 8, 16} (a runtime loop otherwise), the ragged last block masked.
// Nothing is padded: an index past the end of an array reads as the
// sentinel, which is what the TPU version's padding held.  Keeping the
// top levels in shared memory, a warp per query, vector loads of the
// F-key groups and interleaving several queries per thread to hide
// latency are left for later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -shared -Xcompiler -fPIC (repro_torch/kernels/build.py).
// Each C entry point launches on the caller's stream, does not
// synchronise, and returns cudaGetLastError().

#include "pi_descend.cuh"

template <typename T, int FT>
__global__ void __launch_bounds__(PI_BLOCK)
pi_search_kernel(Levels<T> lv, const T* __restrict__ storage, int C,
                 const T* __restrict__ q, int B, int fanout,
                 int* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;
  bool under;
  const long long pos = descend<T, FT>(lv, storage, C, __ldg(q + i), fanout,
                                       &under);
  out[i] = under ? -1 : (int)pos;
}

template <typename T, int FT>
__global__ void __launch_bounds__(PI_BLOCK)
pi_probe_kernel(Levels<T> lv, const T* __restrict__ storage, int C,
                const T* __restrict__ pending, int PC, int P2,
                const T* __restrict__ q, int B, int fanout,
                int* __restrict__ mpos_out, int* __restrict__ ppos_out,
                int* __restrict__ flags_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;
  const T qi = __ldg(q + i);
  bool under;
  const long long pos = descend<T, FT>(lv, storage, C, qi, fanout, &under);
  const int mpos = under ? -1 : (int)pos;
  const long long mc = mpos < 0 ? 0 : (mpos > C - 1 ? C - 1 : mpos);
  const bool main_match = mpos >= 0 && __ldg(storage + mc) == qi;

  // branchless lower bound over the pending buffer seen as P2 wide
  const int ppos = bound<T, false>(pending, PC, P2, qi);
  const int pc = ppos < PC - 1 ? ppos : PC - 1;
  const bool p_hit = __ldg(pending + pc) == qi && ppos < PC;

  mpos_out[i] = mpos;
  ppos_out[i] = ppos;
  flags_out[i] = (main_match ? 1 : 0) | (p_hit ? 2 : 0);
}

// ---------------------------------------------------------------------------
// host entry points (plain C interface, loaded with ctypes)
// ---------------------------------------------------------------------------

template <typename T>
static int launch_search(const void* const* level_ptrs, const int* level_lens,
                         int n_levels, const void* storage, int C,
                         const void* q, int B, int fanout, void* out,
                         void* stream) {
  Levels<T> lv;
  if (!make_levels(&lv, level_ptrs, level_lens, n_levels) || fanout < 2)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((B + PI_BLOCK - 1) / PI_BLOCK), block(PI_BLOCK);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* st = static_cast<const T*>(storage);
  const T* qq = static_cast<const T*>(q);
  int* o = static_cast<int*>(out);
  switch (fanout) {
    case 2: pi_search_kernel<T, 2><<<grid, block, 0, s>>>(lv, st, C, qq, B, fanout, o); break;
    case 4: pi_search_kernel<T, 4><<<grid, block, 0, s>>>(lv, st, C, qq, B, fanout, o); break;
    case 8: pi_search_kernel<T, 8><<<grid, block, 0, s>>>(lv, st, C, qq, B, fanout, o); break;
    case 16: pi_search_kernel<T, 16><<<grid, block, 0, s>>>(lv, st, C, qq, B, fanout, o); break;
    default: pi_search_kernel<T, 0><<<grid, block, 0, s>>>(lv, st, C, qq, B, fanout, o); break;
  }
  return (int)cudaGetLastError();
}

template <typename T>
static int launch_probe(const void* const* level_ptrs, const int* level_lens,
                        int n_levels, const void* storage, int C,
                        const void* pending, int PC, const void* q, int B,
                        int fanout, void* mpos, void* ppos, void* flags,
                        void* stream) {
  Levels<T> lv;
  if (!make_levels(&lv, level_ptrs, level_lens, n_levels) || fanout < 2 ||
      PC < 1 || C < 1)
    return (int)cudaErrorInvalidValue;
  const int P2 = pow2_at_least(PC);
  const dim3 grid((B + PI_BLOCK - 1) / PI_BLOCK), block(PI_BLOCK);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* st = static_cast<const T*>(storage);
  const T* pk = static_cast<const T*>(pending);
  const T* qq = static_cast<const T*>(q);
  int* a = static_cast<int*>(mpos);
  int* b = static_cast<int*>(ppos);
  int* c = static_cast<int*>(flags);
  switch (fanout) {
    case 2: pi_probe_kernel<T, 2><<<grid, block, 0, s>>>(lv, st, C, pk, PC, P2, qq, B, fanout, a, b, c); break;
    case 4: pi_probe_kernel<T, 4><<<grid, block, 0, s>>>(lv, st, C, pk, PC, P2, qq, B, fanout, a, b, c); break;
    case 8: pi_probe_kernel<T, 8><<<grid, block, 0, s>>>(lv, st, C, pk, PC, P2, qq, B, fanout, a, b, c); break;
    case 16: pi_probe_kernel<T, 16><<<grid, block, 0, s>>>(lv, st, C, pk, PC, P2, qq, B, fanout, a, b, c); break;
    default: pi_probe_kernel<T, 0><<<grid, block, 0, s>>>(lv, st, C, pk, PC, P2, qq, B, fanout, a, b, c); break;
  }
  return (int)cudaGetLastError();
}

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

}  // extern "C"
