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
// bfloat16: flash_fwd_kernel<D, EXACT>, wgmma fed by TMA.
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
// * The causal rows 0..63 (the first warpgroup of the first query tile)
//   see at most 64 keys, so one probability that rounds to bf16 the other
//   way than the plain version's moves such a row's output by up to 2^-8
//   p |v| / l with l small, past CARD_TOL (seen at D = 256 and near it at
//   D = 96).  Their scores are taken from shared memory exactly instead
//   (exact_scores: bf16 q and k in float64 on the float64 tensor cores,
//   whose sums of these products are exact, rounded once to float32: the
//   plain version's scores), the bf16 tensor cores' S discarded there;
//   every other row keeps it.  That path is its own instantiation,
//   flash_fwd_kernel<D, true>, over the first query tile alone, launched
//   after flash_fwd_kernel<D, false> has taken the others and overlapping
//   its tail (a programmatic dependent launch): the same branch inside
//   the pipelined loop of one kernel slowed every tile (phi3's prefill
//   shape 0.66 -> 1.02 ms on the H100), the separate launch costs ~1 %.
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
// float32: flash_f32_kernel<D>, FFMAs on the CUDA cores.  Its bar against
// the plain version, 1e-5, admits neither TF32 nor bf16 operands, so the
// products stay scalar.  What bounds them is shared memory: a 16-byte read
// costs a quarter warp's wavefront whatever it broadcasts, so a warp pays
// one wavefront for each float a lane reads, and the SM's 128 FMAs a clock
// need 4 FMAs for each float read (the first port's kernel did 2.67 in S:
// a 4 x 4 tile, synchronous tile loads between two barriers).  Here:
// * One block of 256 threads per (128 query rows, head, batch row); 64 rows
//   at D = 128 and 256, to fit shared memory.  A lane owns 8 rows (4) and
//   8 keys of a 64-key tile (4 of 32 at D = 256) for S, over one half of
//   d: a d reads 8 + 8 floats for 64 FMAs; each half then takes half of
//   the keys, the other half's partial sums of them coming by a shuffle.  For O += PV it owns the same rows and D / 8 columns over
//   one half of the keys: a key reads 8 + 12 floats for 96 FMAs (D = 96);
//   the halves' O are added once, at the end.
// * q is scaled once (q * scale rounded to float32, as before) into shared
//   memory, transposed; k and v tiles (kv_tile(D, float32): 64 keys, 32 at
//   D = 256) go by cp.async into two stages, so tile t + 1 loads while
//   tile t computes and a tile costs one block barrier.  Keys past Sk
//   arrive as zeros.
// * p goes through shared memory, transposed, but only within its row
//   group's warp: a __syncwarp, not a barrier, stands between the softmax
//   and P.V.
// * The -1e30 mask (only on tiles that need it), __expf and the running
//   max are the first port's; l is summed per thread and over the row
//   group at the end.  A warp skips a causal tile that lies wholly after
//   its rows (it would change nothing).  The query tile is the grid's
//   slowest dimension, counted down, so that every head's heaviest causal
//   tiles start first.  Only the float32 model takes it.
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

// The scores of this warpgroup's rows 0..63 against keys 0..63 of the
// first key tile, taken exactly: bf16 q and k converted to float64 and
// multiplied on the float64 tensor cores (mma m8n8k4), whose products of
// bf16 values are exact and whose float64 sums over D are exact here,
// rounded once to float32 -- the plain version's scores.  A warp's 16
// rows are two m8 row blocks and 8 keys an n8 column block; mma's
// accumulator fragment (row lane / 4, columns 2 (lane % 4) + e) is this
// thread's sc[4 j + 2 r + e] of the wgmma fragment (rows ra + 8 r, keys
// 8 j + cq + e), so every score lands in the thread that holds it.  Keys
// from 64 on lie above all of these rows and are left 0 (the softmax
// masks them), as is sc2.  Element (row, col) of a column block of
// SW-byte rows sits at byte row * SW + 2 (col % CW), its 16-byte chunk
// bits [4, 7) XORed with bits [7, 10) (TMA's swizzle; every block starts
// on a 1024-byte boundary).
template <int D>
__device__ __forceinline__ void exact_scores(float (&sc)[TcShape<D>::BK / 2],
                                          float (&sc2)[TcShape<D>::BK / 2],
                                          const uint8_t* q, const uint8_t* k,
                                          int warp, int lane) {
  using Sh = TcShape<D>;
  constexpr int BK = Sh::BK, CW = Sh::CW, SW = Sh::SW;
  constexpr uint32_t M = SW / 16 - 1;
  auto at = [&](const uint8_t* base, int block_rows, int row, int col) {
    uint32_t l = row * SW + 2 * (col % CW);
    l ^= ((l >> 7) & M) << 4;
    return static_cast<double>(__bfloat162float(
        *reinterpret_cast<const __nv_bfloat16*>(
            base + (col / CW) * block_rows * SW + l)));
  };
#pragma unroll
  for (int x = 0; x < BK / 2; ++x) sc[x] = sc2[x] = 0.f;
  const int d4 = lane % 4, r4 = lane / 4;
#pragma unroll
  for (int j0 = 0; j0 < 8; j0 += 2) {  // two column blocks at a time
    double acc[2][2][2] = {};          // [row block][column block][e]
#pragma unroll 4
    for (int d = d4; d < D; d += 4) {
      double a[2], b[2];
#pragma unroll
      for (int r = 0; r < 2; ++r)
        a[r] = at(q, TC_BQ, 16 * warp + 8 * r + r4, d);
#pragma unroll
      for (int j = 0; j < 2; ++j) b[j] = at(k, BK, 8 * (j0 + j) + r4, d);
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          asm volatile(
              "mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 "
              "{%0, %1}, {%2}, {%3}, {%0, %1};\n"
              : "+d"(acc[r][j][0]), "+d"(acc[r][j][1])
              : "d"(a[r]), "d"(b[j]));
    }
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          sc[4 * (j0 + j) + 2 * r + e] = __double2float_rn(acc[r][j][e]);
  }
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

// Query tiles qt0 .. qt0 + gridDim.x - 1; EXACT: the causal first tile
// (qt0 = 0, one tile), its rows 0..63 on exact scores.
template <int D, bool EXACT>
__global__ void __launch_bounds__(TC_THREADS, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tq,
                 const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv,
                 __nv_bfloat16* __restrict__ out, int Sq, int Sk, int H,
                 int KV, int causal, int window, float softcap, float scale,
                 int qt0) {
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

  // heavy causal tiles first
  const int qt = qt0 + gridDim.x - 1 - blockIdx.x;
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

  // the EXACT launch over the first tile may start as this grid's last
  // blocks start (it writes other rows; see launch_tc)
  if constexpr (!EXACT)
    asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
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
    // the causal rows 0..63 see at most 64 keys, so a probability there
    // weighs up to 1/l >= 1/64 of the output, and one that rounds to bf16
    // the other way than the plain version's (the tensor cores' float32
    // sums round apart from the exact scores) moves it past CARD_TOL:
    // their scores are taken exactly instead
    const bool exact = EXACT && wg == 0;
    const uint8_t* qs = smem_raw + (qa - raw);

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
      if (exact)  // the first tile: keys 0..BK-1, all that rows 0..63 see
        exact_scores<D>(sc, sc2, qs, smem_raw + (skv - raw), tw / 32, lane);
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
  // the EXACT launch ends after the grid it overlapped (a no-op without
  // one), so that the stream's next work sees both
  if constexpr (EXACT) asm volatile("griddepcontrol.wait;\n" ::: "memory");
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
  // causal: the first query tile apart, by the instantiation that takes
  // its first 64 rows' scores exactly, launched second as a programmatic
  // dependent of the first launch so that its blocks run in that one's
  // tail (it reads only q, k, v, which the first launch does not write)
  const int tiles = (Sq + TC_BQ - 1) / TC_BQ, first = causal ? 1 : 0;
  for (int exact = 0; exact < 2; ++exact) {
    const int qt0 = exact ? 0 : first, n = exact ? first : tiles - first;
    if (n == 0) continue;
    auto kernel =
        exact ? flash_fwd_kernel<D, true> : flash_fwd_kernel<D, false>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Sh::SMEM);
    if (err != cudaSuccess) return (int)err;
    cudaLaunchAttribute overlap[1];
    overlap[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    // only behind this call's own first launch: behind another kernel the
    // attribute would let it read q, k, v before they are written
    overlap[0].val.programmaticStreamSerializationAllowed =
        exact && tiles > first;
    cudaLaunchConfig_t lc = {};
    lc.gridDim = dim3(n, H, B);
    lc.blockDim = dim3(TC_THREADS);
    lc.dynamicSmemBytes = Sh::SMEM;
    lc.stream = stream;
    lc.attrs = overlap;
    lc.numAttrs = 1;
    err = cudaLaunchKernelEx(&lc, kernel, mq, mk, mv,
                             static_cast<__nv_bfloat16*>(out), Sq, Sk, H, KV,
                             causal, window, softcap, scale, qt0);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

// ---------------------------------------------------------------------------
// float32: scalar FMAs, double-buffered by cp.async
// ---------------------------------------------------------------------------

// The shape of the float32 kernel at head dim D.  A block of NT = 256
// threads takes BQ = 16 TM query rows; a thread is (h, rg, cg): half h of
// the head dim for S and of the key tile for O, row group rg (rows
// rg TM .. rg TM + TM - 1), lane cg of 8 in the group (keys cg + 8 j of a
// tile, TN of them; output columns VW cg + 8 VW c + e, DC of them).  Lane
// bits: cg the lowest three, then the low bit of rg, then h, so that a
// row group's 16 threads sit in one warp.  q and p are kept transposed in
// shared memory ([d][row], [key][row]: a thread's TM rows are one or two
// float4), k and v as they come ([key][d]); rows QTS = BQ + 4 and QS =
// D + 4 floats apart keep the lanes of a read on different banks.
template <int D>
struct F32Shape {
  static constexpr int NT = 256;                 // threads of a block
  static constexpr int BK = D >= 256 ? 32 : 64;  // keys of a tile: kv_tile
  static constexpr int TM = D >= 128 ? 4 : 8;    // query rows a thread
  static constexpr int BQ = 16 * TM;
  static constexpr int TN = BK / 8;
  static constexpr int DC = D / 8;
  static constexpr int VW = DC % 4 == 0 ? 4 : 2;
  static constexpr int QTS = BQ + 4;
  static constexpr int QS = D + 4;
  // q^T [D][QTS], k and v [2][BK][QS] each, p^T [BK][QTS]
  static constexpr int SMEM = 4 * (D * QTS + 4 * BK * QS + BK * QTS);
  static_assert(BQ * QS <= 4 * BK * QS, "the O exchange reuses k and v");
};

// 16 bytes from global to shared memory, asynchronously; zeros when !ok.
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// VW consecutive floats of shared memory into x[0..VW), and back.
template <int VW>
__device__ __forceinline__ void lds(float* x, const float* p) {
  if constexpr (VW == 4) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  } else {
    static_assert(VW == 2, "VW: 2 or 4");
    const float2 a = *reinterpret_cast<const float2*>(p);
    x[0] = a.x; x[1] = a.y;
  }
}

template <int VW>
__device__ __forceinline__ void sts(float* p, const float* x) {
  if constexpr (VW == 4)
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  else
    *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
}

// max and sum over the 8 lanes of a row group's half (lane bits 0-2)
__device__ __forceinline__ float group8_max(float x) {
#pragma unroll
  for (int off = 4; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float group8_sum(float x) {
#pragma unroll
  for (int off = 4; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <int D>
__global__ void __launch_bounds__(F32Shape<D>::NT, 1)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out,
                 int Sq, int Sk, int H, int KV, int causal, int window,
                 float softcap, float scale) {
  using Sh = F32Shape<D>;
  constexpr int BK = Sh::BK, BQ = Sh::BQ, TM = Sh::TM, TN = Sh::TN;
  constexpr int DC = Sh::DC, VW = Sh::VW, QTS = Sh::QTS, QS = Sh::QS;
  constexpr int CH = D / 4;  // 16-byte chunks of a row of k or v
  extern __shared__ __align__(16) float smem[];
  float* sqt = smem;               // [D][QTS]
  float* sk = sqt + D * QTS;       // [2][BK][QS]
  float* sv = sk + 2 * BK * QS;    // [2][BK][QS]
  float* spt = sv + 2 * BK * QS;   // [BK][QTS]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int cg = lane & 7;
  const int half = (lane >> 4) & 1;
  const int rg = 2 * (tid >> 5) + ((lane >> 3) & 1);
  const int r0 = rg * TM;  // this thread's first row in the block
  // every head's heaviest causal tiles first: the query tile is the grid's
  // slowest dimension, counted down
  const int qt = gridDim.z - 1 - blockIdx.z;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int kvh = h / (H / KV);
  const int q0 = qt * BQ;

  // the key tiles any row of this query tile can see
  const int q_last = min(q0 + BQ, Sq) - 1;
  const int k_end = causal ? min(Sk, q_last + 1) : Sk;
  const int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  const int t_begin = k_begin / BK;
  const int t_end = (k_end + BK - 1) / BK;

  auto load_kv = [&](int t, int stage) {
    float* dk = sk + stage * BK * QS;
    float* dv = sv + stage * BK * QS;
    for (int c = tid; c < BK * CH; c += Sh::NT) {
      const int key = c / CH, d = 4 * (c % CH);
      const int s = t * BK + key;
      const bool ok = s < Sk;
      const long long off =
          ok ? ((long long)(b * (long long)Sk + s) * KV + kvh) * D + d : 0;
      cp_async16(dk + key * QS + d, k + off, ok);
      cp_async16(dv + key * QS + d, v + off, ok);
    }
  };
  if (t_begin < t_end) load_kv(t_begin, 0);
  cp_async_commit();

  // q, scaled and rounded to float32, transposed, while the first tile
  // loads; every load is in flight before the first store
  constexpr int QN = BQ * CH / Sh::NT;
  static_assert(QN * Sh::NT == BQ * CH, "q tile in whole rounds");
  float4 qx[QN];
#pragma unroll
  for (int n = 0; n < QN; ++n) {
    const int c = tid + n * Sh::NT;
    const int s = q0 + c % BQ, d = 4 * (c / BQ);
    qx[n] = s < Sq ? __ldg(reinterpret_cast<const float4*>(
                         q + ((long long)(b * (long long)Sq + s) * H + h) *
                                 D + d))
                   : make_float4(0.f, 0.f, 0.f, 0.f);
  }
#pragma unroll
  for (int n = 0; n < QN; ++n) {
    const int c = tid + n * Sh::NT;
    const int r = c % BQ, d = 4 * (c / BQ);
    sqt[(d + 0) * QTS + r] = qx[n].x * scale;
    sqt[(d + 1) * QTS + r] = qx[n].y * scale;
    sqt[(d + 2) * QTS + r] = qx[n].z * scale;
    sqt[(d + 3) * QTS + r] = qx[n].w * scale;
  }

  float m[TM], l[TM], acc[TM][DC];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    m[i] = FA_MASK;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }
  const int warp_rows = 2 * TM * (tid >> 5) + 2 * TM - 1;  // its last row
  const int d0 = half * (D / 2);        // this thread's half of d in S
  const int kh = half * (BK / 2);       // and of the keys in P.V
  const int jh = half * (TN / 2);       // and of its keys in the softmax

  for (int t = t_begin; t < t_end; ++t) {
    const int stage = (t - t_begin) & 1;
    // tile t has landed for every thread, and every thread is done with
    // tile t - 1, whose stage the next load takes: one barrier a tile
    cp_async_wait_all();
    __syncthreads();
    if (t + 1 < t_end) load_kv(t + 1, stage ^ 1);
    cp_async_commit();
    const float* kt = sk + stage * BK * QS + cg * QS;
    const float* vt = sv + stage * BK * QS + VW * cg;
    const int kb = t * BK;
    // a tile whose every key comes after every row of this warp changes
    // nothing there (p = 0, corr = 1: the rows have seen their diagonal)
    if (causal && kb > q0 + warp_rows) continue;

    // S = Q K^T over this thread's half of d: an outer product of TM rows
    // and TN keys for each d (float4 of q^T, float2 of k a step of two);
    // then the two halves' sums are added across lanes 16 apart
    float sc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) sc[i][j] = 0.f;
#pragma unroll 1
    for (int d = d0; d < d0 + D / 2; d += 2) {
      float qa[2][TM], ka[TN][2];
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int i = 0; i < TM; i += 4)
          lds<4>(qa[e] + i, sqt + (d + e) * QTS + r0 + i);
#pragma unroll
      for (int j = 0; j < TN; ++j) lds<2>(ka[j], kt + j * 8 * QS + d);
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j)
            sc[i][j] = fmaf(qa[e][i], ka[j][e], sc[i][j]);
    }
    // each half keeps the keys cg + 8 (jh + j), j < TN / 2, and adds the
    // other half's sum of them: one shuffle for two partial scores
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN / 2; ++j) {
        const float mine = half ? sc[i][TN / 2 + j] : sc[i][j];
        const float theirs = half ? sc[i][j] : sc[i][TN / 2 + j];
        sc[i][j] = mine + __shfl_xor_sync(0xffffffffu, theirs, 16);
      }

    // the online softmax over the row group's 16 threads, each holding
    // TN / 2 keys of a row: the max over all of them, p of its own; l is
    // summed per thread here and over the 16 at the end
    const bool masked = kb + BK > Sk || (causal && kb + BK - 1 > q0) ||
                        window > 0;
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int qpos = q0 + r0 + i;
      float mx = FA_MASK;
#pragma unroll
      for (int j = 0; j < TN / 2; ++j) {
        float x = sc[i][j];
        if (softcap > 0.f) x = tanhf(x / softcap) * softcap;
        if (masked) {
          const int kpos = kb + cg + 8 * (jh + j);
          bool keep = kpos < Sk;
          if (causal) keep = keep && kpos <= qpos;
          if (window > 0) keep = keep && kpos > qpos - window;
          x += keep ? 0.f : FA_MASK;
        }
        sc[i][j] = x;
        mx = fmaxf(mx, x);
      }
      mx = group8_max(mx);
      const float m_new =
          fmaxf(m[i], fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 16)));
      const float corr = __expf(m[i] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < TN / 2; ++j) {
        const float p = __expf(sc[i][j] - m_new);
        psum += p;
        sc[i][j] = p;
      }
      l[i] = l[i] * corr + psum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= corr;
    }
#pragma unroll
    for (int j = 0; j < TN / 2; ++j)
#pragma unroll
      for (int i = 0; i < TM; i += 4) {
        const float p4[4] = {sc[i][j], sc[i + 1][j], sc[i + 2][j],
                             sc[i + 3][j]};
        sts<4>(spt + (cg + 8 * (jh + j)) * QTS + r0 + i, p4);
      }
    // a row's p comes from the 16 threads of its row group, in this warp
    __syncwarp();

    // O += P V over this thread's half of the keys: an outer product of TM
    // rows and DC columns a key
#pragma unroll 4
    for (int kk = kh; kk < kh + BK / 2; ++kk) {
      float pa[TM], vv[DC];
#pragma unroll
      for (int i = 0; i < TM; i += 4) lds<4>(pa + i, spt + kk * QTS + r0 + i);
#pragma unroll
      for (int c = 0; c < DC / VW; ++c)
        lds<VW>(vv + c * VW, vt + kk * QS + 8 * VW * c);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[i][c] = fmaf(pa[i], vv[c], acc[i][c]);
    }
  }

  // O = the two halves' sums over the keys: half 1 hands its partial sums
  // to half 0 through the k/v stages, which no tile needs any more
  cp_async_wait_all();
  __syncthreads();
  float* so = sk;  // [BQ][QS]
  if (half) {
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int c = 0; c < DC / VW; ++c)
        sts<VW>(so + (r0 + i) * QS + VW * cg + 8 * VW * c, acc[i] + c * VW);
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < TM; ++i)
    l[i] = group8_sum(l[i] + __shfl_xor_sync(0xffffffffu, l[i], 16));
  if (half) return;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int s = q0 + r0 + i;
    if (s >= Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    float* row = out + ((long long)(b * (long long)Sq + s) * H + h) * D +
                 VW * cg;
#pragma unroll
    for (int c = 0; c < DC / VW; ++c) {
      float o[VW];
      lds<VW>(o, so + (r0 + i) * QS + VW * cg + 8 * VW * c);
#pragma unroll
      for (int e = 0; e < VW; ++e) o[e] = (acc[i][c * VW + e] + o[e]) / denom;
      sts<VW>(row + 8 * VW * c, o);
    }
  }
}

template <int D>
static int launch_f32(const void* q, const void* k, const void* v, void* out,
                      int B, int Sq, int Sk, int H, int KV, int causal,
                      int window, float softcap, float scale,
                      cudaStream_t stream) {
  using Sh = F32Shape<D>;
  auto kernel = flash_f32_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Sh::SMEM);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(H, B, (Sq + Sh::BQ - 1) / Sh::BQ);
  kernel<<<grid, Sh::NT, Sh::SMEM, stream>>>(
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
