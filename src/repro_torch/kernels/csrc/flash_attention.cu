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
// traffic.  So the bfloat16 kernel does both products on the tensor cores.
//
// bfloat16: flash_fwd_kernel<D>, wgmma fed by TMA.
// * One block of 384 threads per (128 query rows, head, batch row); the
//   blocks of the last query tiles, which see the most keys under the
//   causal mask, start first, and the query tiles of one head run side by
//   side so that its k and v come from L2.  Warpgroups 0 and 1 consume, 64
//   query rows each (wgmma's M); warpgroup 2 produces: it gives back
//   registers (setmaxnreg 24, the consumers take 240) and one of its
//   threads issues every TMA load.
// * q (128 x D) is loaded once by TMA; each consumer warpgroup scales its
//   64 rows in place (bf16 x bf16 rounded to bf16, an elementwise pass
//   that does not care about the swizzle), then fence.proxy.async makes
//   the writes visible to wgmma.  k and v tiles of BK keys (128 up to
//   D = 96, 64 above: kv_tile(D) for bfloat16) go into a ring of 3 stages
//   (2 at D = 256), each with a full mbarrier (the TMA's bytes) and an
//   empty one (one arrival from each of the 8 consumer warps once its P.V
//   is done).  Tiles wholly above the diagonal or outside the window are
//   not loaded; keys past Sk and query rows past Sq arrive as TMA's zero
//   fill, keys are masked and rows are not stored.
// * Shared memory holds a tile as D / CW column blocks of [rows][CW] bf16,
//   each row one swizzle span: CW = 64 with the 128-byte swizzle at
//   D = 64, 128, 256; CW = 32 with the 64-byte swizzle at D = 96 (three
//   blocks) and D = 32; CW = 16 with the 32-byte swizzle at D = 16.  TMA
//   writes the swizzle (one box of CW x rows per block) and the wgmma
//   descriptors name it; blocks sit on 1024-byte boundaries.  Q 24 KB and
//   a stage 48 KB at D = 96 (168 KB in all); 192 KB at D = 256.
// * S = Q K^T: D / 16 wgmma m64nBKk16 with both operands in shared memory,
//   K-major (k stored [key][d] is the B operand as it stands), summed in
//   two float32 accumulators (the first and second half of D) that are
//   added after: the tensor cores' float32 sums round further from the
//   exact scores the plain version takes, and every score that lands on
//   the other side of a bf16 rounding of its probability moves a short
//   row's output by up to 2^-9 |v| / l.  The softcap, the mask (only on
//   tiles that need it) and the online softmax (expf, not the cruder
//   __expf, for the same reason) run on the accumulator fragment: a thread
//   holds two rows, and the row max is a shuffle over the 4 lanes that
//   share a row; l is summed per thread and over those lanes at the end.
// * O += P V: p rounded to bf16 in registers is wgmma's A operand (the
//   accumulator of a 16-key slice is laid out as the m64k16 A fragment);
//   v is the B operand from shared memory in its [key][d] layout with the
//   transpose bit (MN-major), N = D.  O stays in float32 registers and is
//   written with guarded stores.
// * Overlap: P_{t-1} V_{t-1} is issued right after Q K_t^T and runs under
//   the softmax of tile t; the two consumer warpgroups take turns to issue
//   (named barriers), so that one's products run under the other's
//   softmax.  No product is issued under a branch (the first tile is
//   peeled), which would make ptxas serialize the wgmmas.
//
// float32: flash_f32_scalar_kernel, scalar FMAs.  Its bar against the
// plain version, 1e-5, admits neither TF32 nor bf16 operands, so it keeps
// the first port's design: one block of 256 threads per (64 query rows,
// head, batch row), key tiles of 64 (32 at D = 256) staged as float32 in
// shared memory, a register tile of scores and outputs per thread, the row
// statistics shuffled over a half-warp.  Only the float32 model takes it.
//
// Interface: plain C entry points that launch on the caller's stream, do
// not synchronise, and return cudaGetLastError() of the launch (or the
// error of the TMA descriptors' encoding).  q, out are contiguous
// (B, Sq, H, D), k and v contiguous (B, Sk, KV, D), every base 16-byte
// aligned (TMA's rule; the wrapper copies a tensor that is not).
// Head dims 16, 32, 64, 96, 128 and 256.

#include <cuda.h>  // CUtensorMap and the encoder's types; no driver call is linked
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "wgmma_bf16.cuh"

constexpr float FA_MASK = -1e30f;

// ---------------------------------------------------------------------------
// bfloat16: wgmma and TMA
// ---------------------------------------------------------------------------

constexpr int TC_BQ = 128;                            // query rows of a block
constexpr int TC_CONSUMERS = 2;                       // warpgroups of 64 rows
constexpr int TC_THREADS = 128 * (TC_CONSUMERS + 1);  // + the producer's
constexpr int TC_MAX_STAGES = 3;

template <int D>
struct TcShape {
  static constexpr int BK = D <= 96 ? 128 : 64;  // keys of a tile
  static constexpr int STAGES = D >= 256 ? 2 : 3;  // of the k/v ring
  static constexpr int CW = D % 64 == 0 ? 64 : D == 96 ? 32 : D;
  static constexpr int SW = 2 * CW;  // bytes of a swizzle span: 32, 64, 128
  static constexpr int NK = D / 16;  // k16 steps of QK^T
  static constexpr int NH = (NK + 1) / 2;  // of them into the first sum
  static constexpr int Q_BYTES = TC_BQ * D * 2;
  static constexpr int KV_BYTES = BK * D * 2;  // one of k, v
  static constexpr int SMEM = Q_BYTES + STAGES * 2 * KV_BYTES + 1024;
};

// Named barriers: 1 + w, warpgroup w alone; TURN + w, warpgroup w may
// issue its products (the other warpgroup arrives on it).
constexpr int TC_TURN = 1 + TC_CONSUMERS;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

// Arrive where ``pred`` holds (a predicate inside the asm, no branch).
__device__ __forceinline__ void mbar_arrive_if(uint32_t bar, bool pred) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %1, 0;\n"
      "@p mbarrier.arrive.shared::cta.b64 _, [%0];\n}\n" ::"r"(bar),
      "r"((int)pred)
      : "memory");
}

// Wait until the phase of parity ``parity`` of the barrier has completed
// (the loop inside the asm: the compiler sees no divergent branch).
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// One box of the 4-D map (d, head, s, b) into shared memory at dst.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int d, int h, int s,
                                         int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(d), "r"(h), "r"(s),
      "r"(b)
      : "memory");
}

// wgmma's shared-memory descriptor of a swizzled operand at addr: the
// swizzle of SW bytes, lbo the bytes between column blocks of an MN-major
// operand (K-major: unused, 16), 8 rows of SW bytes between row groups.
template <int SW>
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo) {
  constexpr uint64_t layout = SW == 128 ? 1 : SW == 64 ? 2 : 3;
  return static_cast<uint64_t>((addr >> 4) & 0x3FFF) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((8 * SW) >> 4) << 32) | (layout << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

// Pins registers that an asynchronous wgmma reads or writes on this side
// of the surrounding fence or wait, so the compiler neither moves their
// uses across it nor hands them to other values in between.
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void pin(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&x);
}

// bar.arrive on named barrier ``id`` (256 threads) where ``pred`` holds.
__device__ __forceinline__ void turn_arrive_if(int id, bool pred) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %1, 0;\n@p bar.arrive %0, 256;\n}\n" ::"r"(
          id),
      "r"((int)pred)
      : "memory");
}

// Issues S = Q K^T of one warpgroup (64 rows) and one key tile at sk:
// k16 steps [0, NH) summed into sc, [NH, NK) into sc2.
template <int D>
__device__ __forceinline__ void issue_qk(float (&sc)[TcShape<D>::BK / 2],
                                         float (&sc2)[TcShape<D>::BK / 2],
                                         uint32_t qa, uint32_t sk) {
  using Sh = TcShape<D>;
  constexpr int BK = Sh::BK, CW = Sh::CW, SW = Sh::SW;
#pragma unroll
  for (int kk = 0; kk < Sh::NK; ++kk) {
    const int c = kk * 16 / CW;               // column block
    const uint32_t off = (kk * 16 % CW) * 2;  // bytes into its span
    const uint64_t da = smem_desc<SW>(qa + c * TC_BQ * SW + off, 16);
    const uint64_t db = smem_desc<SW>(sk + c * BK * SW + off, 16);
    if (kk < Sh::NH)
      wgmma_ss<BK>(sc, da, db, kk > 0);
    else
      wgmma_ss<BK>(sc2, da, db, kk > Sh::NH);
  }
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Issues O += P V for the key tile whose v is at sv.
template <int D>
__device__ __forceinline__ void issue_pv(float (&o)[D / 2],
                                         uint32_t (&pa)[TcShape<D>::BK / 16][4],
                                         uint32_t sv) {
  using Sh = TcShape<D>;
#pragma unroll
  for (int kk = 0; kk < Sh::BK / 16; ++kk)
    wgmma_rs<D>(o, pa[kk], smem_desc<Sh::SW>(sv + kk * 16 * Sh::SW,
                                             Sh::BK * Sh::SW),
                1);
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// The softmax of one key tile on the accumulator fragment: adds the two
// halves of S, applies the softcap and the mask, updates the row maxima m
// and the sums l, leaves p = exp(s - m_new) in sc and the rows' factors
// exp(m_old - m_new) in corr.  sc[4 j + 2 r + e] is row ra + 8 r, key
// kb + 8 j + cq + e.  ``whole``: no key of the tile is masked for any row
// of the warpgroup.
template <int D>
__device__ __forceinline__ void softmax_tile(
    float (&sc)[TcShape<D>::BK / 2], float (&sc2)[TcShape<D>::BK / 2],
    float (&m)[2], float (&l)[2], float (&corr)[2], int kb, bool whole,
    int Sk, int causal, int window, float softcap, int ra, int cq) {
  constexpr int BK = TcShape<D>::BK;
  if constexpr (TcShape<D>::NK > TcShape<D>::NH) {
#pragma unroll
    for (int x = 0; x < BK / 2; ++x) sc[x] += sc2[x];
  }
  if (softcap > 0.f) {
#pragma unroll
    for (int x = 0; x < BK / 2; ++x) sc[x] = tanhf(sc[x] / softcap) * softcap;
  }
  if (!whole) {
#pragma unroll
    for (int x = 0; x < BK / 2; ++x) {
      const int qpos = ra + 8 * ((x >> 1) & 1);
      const int kpos = kb + 8 * (x >> 2) + cq + (x & 1);
      bool keep = kpos < Sk;
      if (causal) keep = keep && kpos <= qpos;
      if (window > 0) keep = keep && kpos > qpos - window;
      sc[x] += keep ? 0.f : FA_MASK;
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = FA_MASK;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
      mx = fmaxf(mx, fmaxf(sc[4 * j + 2 * r], sc[4 * j + 2 * r + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m[r], mx);
    corr[r] = expf(m[r] - m_new);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float p = expf(sc[4 * j + 2 * r + e] - m_new);
        psum += p;
        sc[4 * j + 2 * r + e] = p;
      }
    l[r] = l[r] * corr[r] + psum;
    m[r] = m_new;
  }
}

// o *= corr by row; p (in sc) rounded to bf16 pairs as the A fragments of
// the next P V.
template <int D>
__device__ __forceinline__ void rescale_and_pack(
    float (&o)[D / 2], uint32_t (&pa)[TcShape<D>::BK / 16][4],
    const float (&sc)[TcShape<D>::BK / 2], const float (&corr)[2]) {
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    o[4 * j] *= corr[0];
    o[4 * j + 1] *= corr[0];
    o[4 * j + 2] *= corr[1];
    o[4 * j + 3] *= corr[1];
  }
#pragma unroll
  for (int kk = 0; kk < TcShape<D>::BK / 16; ++kk)
#pragma unroll
    for (int x = 0; x < 4; ++x)
      pa[kk][x] = pack_bf16(sc[8 * kk + 2 * x], sc[8 * kk + 2 * x + 1]);
}

template <int D>
__global__ void __launch_bounds__(TC_THREADS, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tq,
                 const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv,
                 __nv_bfloat16* __restrict__ out, int Sq, int Sk, int H,
                 int KV, int causal, int window, float softcap, float scale) {
  using Sh = TcShape<D>;
  constexpr int BK = Sh::BK, CW = Sh::CW, SW = Sh::SW, STAGES = Sh::STAGES;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + 2 * TC_MAX_STAGES];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sq = (raw + 1023) & ~1023u;  // q: D / CW blocks of 128 rows
  const uint32_t skv = sq + Sh::Q_BYTES;      // stage s: k, then v
  const uint32_t q_full = smem_u32(&bars[0]);
  const uint32_t kv_full = smem_u32(&bars[1]);                // + 8 s
  const uint32_t kv_empty = smem_u32(&bars[1 + STAGES]);  // + 8 s

  const int qt = gridDim.x - 1 - blockIdx.x;  // heavy causal tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int q0 = qt * TC_BQ;
  // the key tiles any row of this query tile can see
  const int q_last = min(q0 + TC_BQ, Sq) - 1;
  const int k_end = causal ? min(Sk, q_last + 1) : Sk;
  const int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  const int t_begin = k_begin / BK;
  const int t_end = (k_end + BK - 1) / BK;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(kv_full + 8 * s, 1);
      mbar_init(kv_empty + 8 * s, 4 * TC_CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // warpgroup index, broadcast so that the compiler knows it is uniform
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == TC_CONSUMERS) {
    // the producer: q once, then k and v tile by tile into the ring
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 128 * TC_CONSUMERS) {
      mbar_expect_tx(q_full, Sh::Q_BYTES);
      for (int c = 0; c < D / CW; ++c)
        tma_load(sq + c * TC_BQ * SW, &tq, q_full, c * CW, h, q0, b);
      for (int t = t_begin; t < t_end; ++t) {
        const int i = t - t_begin, s = i % STAGES;
        mbar_wait(kv_empty + 8 * s, ((i / STAGES) & 1) ^ 1);
        const uint32_t sk = skv + s * 2 * Sh::KV_BYTES;
        const uint32_t sv = sk + Sh::KV_BYTES;
        mbar_expect_tx(kv_full + 8 * s, 2 * Sh::KV_BYTES);
        for (int c = 0; c < D / CW; ++c) {
          tma_load(sk + c * BK * SW, &tk, kv_full + 8 * s, c * CW, kvh,
                   t * BK, b);
          tma_load(sv + c * BK * SW, &tv, kv_full + 8 * s, c * CW, kvh,
                   t * BK, b);
        }
      }
    }
  } else {
    // a consumer: 64 query rows
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int tw = threadIdx.x % 128;
    const int lane = tw % 32;
    const int r_lo = q0 + 64 * wg;                        // its first row
    const int ra = r_lo + 16 * (tw / 32) + lane / 4;      // rows ra, ra + 8
    const int cq = 2 * (lane % 4);  // columns cq, cq + 1 of every 8
    const uint32_t qa = sq + 64 * wg * SW;  // its rows in q's first block

    mbar_wait(q_full, 0);
    // q * scale rounded to bf16, in place, over this warpgroup's rows
    for (int c = 0; c < D / CW; ++c) {
      uint4* rows = reinterpret_cast<uint4*>(smem_raw + (qa - raw) +
                                             c * TC_BQ * SW);
      for (int i = tw; i < 64 * SW / 16; i += 128) {
        uint4 x = rows[i];
        __nv_bfloat162* e = reinterpret_cast<__nv_bfloat162*>(&x);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2 f = __bfloat1622float2(e[j]);
          e[j] = __floats2bfloat162_rn(f.x * scale, f.y * scale);
        }
        rows[i] = x;
      }
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");

    // Per key tile t, with the products of one warpgroup issued while
    // the other runs its softmax (TURN barriers), and P_{t-1} V_{t-1}
    // issued beside Q K_t^T so that it runs under this tile's softmax.
    // QK^T is summed in two halves over D that are added in float32: one
    // float32 sum on the tensor cores over all of D rounds further from
    // the exact scores.  The first tile is peeled so that no product is
    // issued under a branch.
    float o[D / 2], sc[BK / 2], sc2[BK / 2], m[2], l[2], corr[2];
    uint32_t pa[BK / 16][4];
#pragma unroll
    for (int x = 0; x < D / 2; ++x) o[x] = 0.f;
#pragma unroll
    for (int x = 0; x < BK / 2; ++x) sc[x] = sc2[x] = 0.f;
#pragma unroll
    for (int r = 0; r < 2; ++r) m[r] = FA_MASK, l[r] = 0.f;
    const int n = t_end - t_begin;
    auto whole = [&](int kb) {
      return kb + BK <= Sk && (!causal || kb + BK - 1 <= r_lo) &&
             (window <= 0 || kb > r_lo + 63 - window);
    };
    if (n > 0) {
      turn_arrive_if(TC_TURN, wg == 1);  // warpgroup 0 issues first
      const int kb = t_begin * BK;
      mbar_wait(kv_full, 0);
      asm volatile("bar.sync %0, 256;\n" ::"r"(TC_TURN + wg) : "memory");
      wgmma_fence();
      issue_qk<D>(sc, sc2, qa, skv);
      turn_arrive_if(TC_TURN + 1 - wg, wg == 0 || n > 1);
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      pin(sc);
      pin(sc2);
      softmax_tile<D>(sc, sc2, m, l, corr, kb, whole(kb), Sk, causal, window,
                      softcap, ra, cq);
      rescale_and_pack<D>(o, pa, sc, corr);
    }
    for (int i = 1; i < n; ++i) {
      const int s = i % STAGES, sp = (i - 1) % STAGES;
      const int kb = (t_begin + i) * BK;
      mbar_wait(kv_full + 8 * s, (i / STAGES) & 1);
      asm volatile("bar.sync %0, 256;\n" ::"r"(TC_TURN + wg) : "memory");
      pin(o);
      pin(pa);
      wgmma_fence();
      issue_qk<D>(sc, sc2, qa, skv + s * 2 * Sh::KV_BYTES);
      issue_pv<D>(o, pa, skv + sp * 2 * Sh::KV_BYTES + Sh::KV_BYTES);
      turn_arrive_if(TC_TURN + 1 - wg, wg == 0 || i + 1 < n);
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
      pin(sc);
      pin(sc2);
      softmax_tile<D>(sc, sc2, m, l, corr, kb, whole(kb), Sk, causal, window,
                      softcap, ra, cq);
      pin(sc);  // the softmax stays ahead of the wait, under P_{t-1} V_{t-1}
      pin(l);
      pin(corr);
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      pin(o);
      pin(pa);
      mbar_arrive_if(kv_empty + 8 * sp, lane == 0);  // its stage is free
      rescale_and_pack<D>(o, pa, sc, corr);
    }
    if (n > 0) {  // the last tile's P V
      const int sp = (n - 1) % STAGES;
      pin(o);
      pin(pa);
      wgmma_fence();
      issue_pv<D>(o, pa, skv + sp * 2 * Sh::KV_BYTES + Sh::KV_BYTES);
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      pin(o);
      mbar_arrive_if(kv_empty + 8 * sp, lane == 0);
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      const int row = ra + 8 * r;
      if (row >= Sq) continue;
      const float denom = fmaxf(l[r], 1e-30f);
      __nv_bfloat16* dst =
          out + ((static_cast<long long>(b) * Sq + row) * H + h) * D + cq;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) =
            __floats2bfloat162_rn(o[4 * j + 2 * r] / denom,
                                  o[4 * j + 2 * r + 1] / denom);
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime already loaded.
static EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The 4-D map (d, head, s, b) of a contiguous (B, S, heads, D) bf16 tensor,
// cut in boxes of CW x rows with the swizzle of 2 CW bytes.
template <int D>
static bool tensor_map(CUtensorMap* map, const void* ptr, int B, int S,
                       int heads, int rows) {
  using Sh = TcShape<D>;
  EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)heads * D * 2,
                                 (cuuint64_t)S * heads * D * 2};
  const cuuint32_t box[4] = {(cuuint32_t)Sh::CW, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swizzle =
      Sh::SW == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
      : Sh::SW == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                     : CU_TENSOR_MAP_SWIZZLE_32B;
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
static int launch_tc(const void* q, const void* k, const void* v, void* out,
                     int B, int Sq, int Sk, int H, int KV, int causal,
                     int window, float softcap, float scale,
                     cudaStream_t stream) {
  using Sh = TcShape<D>;
  CUtensorMap mq, mk, mv;
  if (!tensor_map<D>(&mq, q, B, Sq, H, TC_BQ) ||
      !tensor_map<D>(&mk, k, B, Sk, KV, Sh::BK) ||
      !tensor_map<D>(&mv, v, B, Sk, KV, Sh::BK))
    return (int)cudaErrorInvalidValue;
  auto kernel = flash_fwd_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Sh::SMEM);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Sq + TC_BQ - 1) / TC_BQ, H, B);
  kernel<<<grid, TC_THREADS, Sh::SMEM, stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(out), Sq, Sk, H, KV, causal,
      window, softcap, scale);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// float32: scalar FMAs
// ---------------------------------------------------------------------------

constexpr int FA_THREADS = 256;
constexpr int FA_BQ = 64;               // query rows of a block
constexpr int FA_QS = FA_BQ + 4;        // row stride of the transposed q tile

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

template <int D, int BK>
__global__ void __launch_bounds__(FA_THREADS)
flash_f32_scalar_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v, float* __restrict__ out,
                        int Sq, int Sk, int H, int KV, int causal, int window,
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
    if (s < Sq) x = q[((long long)(b * (long long)Sq + s) * H + h) * D + d] * scale;
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
        kx = k[off];
        vx = v[off];
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
        sp[(r0 + i) * KS + cg * CK + j] = p;
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
    float* row = out + ((long long)(b * (long long)Sq + s) * H + h) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) row[cg + 16 * c] = acc[i][c] / denom;
  }
}

template <int D>
static int launch_f32(const void* q, const void* k, const void* v, void* out,
                      int B, int Sq, int Sk, int H, int KV, int causal,
                      int window, float softcap, float scale,
                      cudaStream_t stream) {
  constexpr int BK = D >= 256 ? 32 : 64;
  constexpr int bytes = smem_floats<D, BK>() * (int)sizeof(float);
  auto kernel = flash_f32_scalar_kernel<D, BK>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Sq + FA_BQ - 1) / FA_BQ, H, B);
  kernel<<<grid, FA_THREADS, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), Sq, Sk, H, KV,
      causal, window, softcap, scale);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// entry points
// ---------------------------------------------------------------------------

#define FA_ARGS q, k, v, out, B, Sq, Sk, H, KV, causal, window, softcap, scale, s

extern "C" int flash_fwd_bf16(const void* q, const void* k, const void* v,
                              void* out, int B, int Sq, int Sk, int H, int KV,
                              int D, int causal, int window, float softcap,
                              float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Sk == 0)  // no key: every output row is 0 / max(0, 1e-30)
    return (int)cudaMemsetAsync(out, 0, (size_t)B * Sq * H * D * 2, s);
  switch (D) {
    case 16: return launch_tc<16>(FA_ARGS);
    case 32: return launch_tc<32>(FA_ARGS);
    case 64: return launch_tc<64>(FA_ARGS);
    case 96: return launch_tc<96>(FA_ARGS);
    case 128: return launch_tc<128>(FA_ARGS);
    case 256: return launch_tc<256>(FA_ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int flash_fwd_f32(const void* q, const void* k, const void* v,
                             void* out, int B, int Sq, int Sk, int H, int KV,
                             int D, int causal, int window, float softcap,
                             float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch_f32<16>(FA_ARGS);
    case 32: return launch_f32<32>(FA_ARGS);
    case 64: return launch_f32<64>(FA_ARGS);
    case 96: return launch_f32<96>(FA_ARGS);
    case 128: return launch_f32<128>(FA_ARGS);
    case 256: return launch_f32<256>(FA_ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
}
