// Causal GQA flash attention (forward) on Hopper, sm_90a.
//
// flash_fwd_bf16 / flash_fwd_f32 replace the TPU kernel
// repro/kernels/flash_attention.py::flash_attention_fwd (body
// _flash_kernel): out[b, s, h] = softmax(q[b, s, h] . k[b, :, h / rep]^T
// + mask) . v[b, :, h / rep], rep = H / KV, by an online softmax over key
// tiles with a float32 running max m, sum l and accumulator per query row.
// The mask keeps kpos < Sk, kpos <= qpos when causal and kpos > qpos -
// window when a window is given; masked scores get -1e30 added (not -inf:
// a fully masked tile adds exp(0) terms that the next tile's
// corr = exp(m - m_new) wipes out, as in the model function).  An optional
// softcap replaces each score s by tanh(s / softcap) * softcap before the
// mask.  On the prefill path every layer of the dense model runs it once
// (models/transformer.py::attn_apply with no cache).
//
// The rounding follows models/transformer.flash_attention, the function
// this replaces on that path: q is multiplied by the scale (already
// rounded to T by the caller) and rounded to T; scores are float32 sums of
// products; the probabilities are rounded to T before the P.V product, and
// l sums them unrounded; the output is acc / max(l, 1e-30) rounded to T.
//
// What bounds it on this card: operations.  At a prefill of 8 x 2048
// tokens with 32 heads of 96 (phi3-mini) the causal half of QK^T and PV is
// 4 B H D S (S + 1) / 2 = 2.06e11 operations against 402 MB of q, k, v and
// out: 0.209 ms at the tensor cores' 989 TFLOP/s against 0.120 ms of HBM
// traffic.  This kernel does them as float32 FMAs outside the tensor cores
// (67 TFLOP/s at most), so it cannot come near that bound.
//
// What this simple design does (tensor cores, wgmma and TMA are left for
// later work):
// * One block of 256 threads per (64 query rows, head, batch row).  The
//   blocks of the last query tiles, which see the most keys under the
//   causal mask, start first.
// * Key/value tiles of BK = 64 rows (32 at D = 256) are staged in shared
//   memory as float32, q once per block; q and k are stored transposed
//   ([d][row], rows padded by 4) so that a thread reads four rows of q and
//   four keys of k as two float4 loads.  Tiles wholly above the diagonal
//   or wholly outside the window are skipped.
// * Thread t owns rows 4 (t / 16) .. + 3 and, of the scores, columns
//   (t % 16) * BK/16 .. + BK/16 - 1: a register tile of scalar FMAs.  The
//   16 threads of a row group are one half-warp, so the row max and row
//   sum of a tile are xor shuffles over 8, 4, 2, 1.
// * The probabilities go through shared memory ([row][key]); for P.V the
//   same thread owns its four rows' outputs at columns (t % 16) + 16 c,
//   c < D / 16, in float32 registers (64 at D = 256).
// * Any length: rows past Sq compute on zeros and are not stored, keys
//   past Sk load as zeros and are masked.  Head dims 16, 32, 64, 96, 128,
//   256 are template instantiations; shared memory is dynamic (148 KB at
//   D = 256, 94 KB at D = 96), set with cudaFuncSetAttribute.
//
// Interface: plain C entry points that launch on the caller's stream, do
// not synchronise, and return cudaGetLastError() of the launch.  q, out
// are contiguous (B, Sq, H, D), k and v contiguous (B, Sk, KV, D).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

constexpr int FA_THREADS = 256;
constexpr int FA_BQ = 64;               // query rows of a block
constexpr int FA_QS = FA_BQ + 4;        // row stride of the transposed q tile
constexpr float FA_MASK = -1e30f;

template <typename T>
__device__ __forceinline__ float to_float(T x);
template <>
__device__ __forceinline__ float to_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_float<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// x rounded to T's precision, as a float.
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_float<T>(from_float<T>(x));
}

__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <int D, int BK>
constexpr int smem_floats() {
  // q^T [D][FA_QS], k^T [D][BK + 4], v [BK][D], p [FA_BQ][BK + 4]
  return D * FA_QS + D * (BK + 4) + BK * D + FA_BQ * (BK + 4);
}

template <typename T, int D, int BK>
__global__ void __launch_bounds__(FA_THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out, int Sq,
                 int Sk, int H, int KV, int causal, int window,
                 float softcap, float scale) {
  constexpr int KS = BK + 4;   // row stride of k^T and of p
  constexpr int CK = BK / 16;  // score columns a thread owns
  constexpr int NC = D / 16;   // output columns a thread owns
  extern __shared__ __align__(16) float smem[];
  float* sq = smem;              // [D][FA_QS]
  float* sk = sq + D * FA_QS;    // [D][KS]
  float* sv = sk + D * KS;       // [BK][D]
  float* sp = sv + BK * D;       // [FA_BQ][KS]

  const int tid = threadIdx.x;
  const int qt = gridDim.x - 1 - blockIdx.x;  // heavy causal tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int q0 = qt * FA_BQ;
  const int r0 = (tid / 16) * 4;  // this thread's first row in the tile
  const int cg = tid % 16;        // its lane within the row group

  for (int i = tid; i < FA_BQ * D; i += FA_THREADS) {
    const int r = i / D, d = i % D;
    const int s = q0 + r;
    float x = 0.f;
    if (s < Sq)
      x = round_to<T>(
          to_float<T>(q[((long long)(b * (long long)Sq + s) * H + h) * D + d]) *
          scale);
    sq[d * FA_QS + r] = x;
  }

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = FA_MASK;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  // the key tiles any row of this query tile can see
  const int q_last = min(q0 + FA_BQ, Sq) - 1;
  const int k_end = causal ? min(Sk, q_last + 1) : Sk;
  const int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  const int t_begin = k_begin / BK;
  const int t_end = (k_end + BK - 1) / BK;

  for (int t = t_begin; t < t_end; ++t) {
    const int kb = t * BK;
    __syncthreads();  // the previous tile's k, v and p are consumed
    for (int i = tid; i < BK * D; i += FA_THREADS) {
      const int c = i / D, d = i % D;
      const int s = kb + c;
      float kx = 0.f, vx = 0.f;
      if (s < Sk) {
        const long long off = ((long long)(b * (long long)Sk + s) * KV + kvh) * D + d;
        kx = to_float<T>(k[off]);
        vx = to_float<T>(v[off]);
      }
      sk[d * KS + c] = kx;
      sv[c * D + d] = vx;
    }
    __syncthreads();

    float sc[4][CK];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < CK; ++j) sc[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float4 qa = *reinterpret_cast<const float4*>(&sq[d * FA_QS + r0]);
      const float qv[4] = {qa.x, qa.y, qa.z, qa.w};
      float kv[CK];
      if constexpr (CK == 4) {
        const float4 ka = *reinterpret_cast<const float4*>(&sk[d * KS + cg * 4]);
        kv[0] = ka.x; kv[1] = ka.y; kv[2] = ka.z; kv[3] = ka.w;
      } else {
        const float2 ka = *reinterpret_cast<const float2*>(&sk[d * KS + cg * 2]);
        kv[0] = ka.x; kv[1] = ka.y;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < CK; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + r0 + i;
      float mx = FA_MASK;
#pragma unroll
      for (int j = 0; j < CK; ++j) {
        const int kpos = kb + cg * CK + j;
        float x = sc[i][j];
        if (softcap > 0.f) x = tanhf(x / softcap) * softcap;
        bool keep = kpos < Sk;
        if (causal) keep = keep && kpos <= qpos;
        if (window > 0) keep = keep && kpos > qpos - window;
        x += keep ? 0.f : FA_MASK;
        sc[i][j] = x;
        mx = fmaxf(mx, x);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      const float corr = __expf(m[i] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < CK; ++j) {
        const float p = __expf(sc[i][j] - m_new);
        psum += p;
        sp[(r0 + i) * KS + cg * CK + j] = round_to<T>(p);
      }
      l[i] = l[i] * corr + half_warp_sum(psum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= corr;
    }
    __syncthreads();  // p complete

#pragma unroll 2
    for (int kk = 0; kk < BK; kk += 4) {
      float pr[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 pa = *reinterpret_cast<const float4*>(&sp[(r0 + i) * KS + kk]);
        pr[i][0] = pa.x; pr[i][1] = pa.y; pr[i][2] = pa.z; pr[i][3] = pa.w;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const float vv = sv[(kk + u) * D + cg + 16 * c];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(pr[i][u], vv, acc[i][c]);
        }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = q0 + r0 + i;
    if (s >= Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    T* row = out + ((long long)(b * (long long)Sq + s) * H + h) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) row[cg + 16 * c] = from_float<T>(acc[i][c] / denom);
  }
}

template <typename T, int D>
static int launch(const void* q, const void* k, const void* v, void* out,
                  int B, int Sq, int Sk, int H, int KV, int causal, int window,
                  float softcap, float scale, cudaStream_t stream) {
  constexpr int BK = D >= 256 ? 32 : 64;
  constexpr int bytes = smem_floats<D, BK>() * (int)sizeof(float);
  auto kernel = flash_fwd_kernel<T, D, BK>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Sq + FA_BQ - 1) / FA_BQ, H, B);
  kernel<<<grid, FA_THREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), Sq, Sk, H, KV, causal,
      window, softcap, scale);
  return (int)cudaGetLastError();
}

template <typename T>
static int dispatch(const void* q, const void* k, const void* v, void* out,
                    int B, int Sq, int Sk, int H, int KV, int D, int causal,
                    int window, float softcap, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, out, B, Sq, Sk, H, KV, causal, window, softcap, scale, s);
    case 32: return launch<T, 32>(q, k, v, out, B, Sq, Sk, H, KV, causal, window, softcap, scale, s);
    case 64: return launch<T, 64>(q, k, v, out, B, Sq, Sk, H, KV, causal, window, softcap, scale, s);
    case 96: return launch<T, 96>(q, k, v, out, B, Sq, Sk, H, KV, causal, window, softcap, scale, s);
    case 128: return launch<T, 128>(q, k, v, out, B, Sq, Sk, H, KV, causal, window, softcap, scale, s);
    case 256: return launch<T, 256>(q, k, v, out, B, Sq, Sk, H, KV, causal, window, softcap, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int flash_fwd_bf16(const void* q, const void* k, const void* v,
                              void* out, int B, int Sq, int Sk, int H, int KV,
                              int D, int causal, int window, float softcap,
                              float scale, void* stream) {
  return dispatch<__nv_bfloat16>(q, k, v, out, B, Sq, Sk, H, KV, D, causal,
                                 window, softcap, scale, stream);
}

extern "C" int flash_fwd_f32(const void* q, const void* k, const void* v,
                             void* out, int B, int Sq, int Sk, int H, int KV,
                             int D, int causal, int window, float softcap,
                             float scale, void* stream) {
  return dispatch<float>(q, k, v, out, B, Sq, Sk, H, KV, D, causal, window,
                         softcap, scale, stream);
}
