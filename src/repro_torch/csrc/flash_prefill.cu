// Causal flash attention over one dense sequence (monolithic prefill, and
// the training forward) for GQA / MHA / MQA on Hopper.
//
// Replaces the Pallas TPU kernel `flash_prefill`
// (src/repro/kernels/flash_prefill.py), which computes
// `models/attention.causal_attention` with no query offset: query i of a
// sequence of S tokens attends keys j <= i, and query head h reads KV
// head h / (Hq / Hkv).
//
// Bound on the H100: at a few hundred tokens the bytes, past S ~ 740 at
// Hq 32 / Hkv 8 the operations: a sequence does 4 * S(S+1)/2 * Hq * hd
// flops over (2 * S * Hq + 2 * S * Hkv) * hd elements moved, about 0.4 * S
// flops a bf16 byte against the card's ~295.  At hd 64 the exponentials
// weigh as much as the products: a [128 x 128] tile's 16384 exp2 take the
// special-function units' 16 a clock as long as its products take the
// tensor cores.
//
// Three bodies, chosen by type and width in `flash_prefill` below (never
// a retry after a failure); `flash_prefill_tensor_core` names the one a
// call takes (2, 1, 0):
//
//   bf16 (64, 64)     `flash_prefill_wg<64, 64, 3>` (192-row tiles) when
//                     ceil(S / 192) * Hq * B >= 264 blocks, else
//                     `flash_prefill_wg<64, 64, 2>` (128-row tiles)
//   bf16 (128, 128)   `flash_prefill_wg<128, 128, 2>`
//   bf16 (192, 128)   `flash_prefill_wg<192, 128, 2>` (MLA's training
//                     widths, the non-absorbed form the JAX package trains:
//                     K = [c_kv W_uk ; k_rope], V = c_kv W_uv per head)
//   bf16 hd 16, 32    `flash_prefill_tc<hd, hd>` (`mma.sync`)
//   float32; bf16 256 `flash_prefill_kernel` (CUDA cores)
//
// * `flash_prefill_wg<DK, DV, NC>` -- the warp-specialised body.  One
//   block per (64 NC-query tile, q head, sequence), longest tiles first:
//   within each head, or across all heads where the grid is more than a
//   wave and K and V fit in 40 MB of L2 (`hop::longest_first`); 128 (NC
//   + 1) threads: warpgroup 0 is the producer, which gives its
//   registers up (`setmaxnreg.dec` to 24) and in which one thread issues
//   every TMA load: Q once, then K and V tiles of 128 keys from 0 to the
//   tile's diagonal into a ring of two stages in shared memory, each stage
//   guarded by a full barrier for K, one for V and an empty barrier
//   (`mbarrier`s); the consumer warpgroups 1 .. NC (`setmaxnreg.inc`, 240
//   registers a thread at NC 2, 160 at NC 3) own 64 query rows each.  A
//   consumer forms S = Q K^T with `wgmma.mma_async` m64n128k16 from
//   shared memory (Q and K K-major), runs the online softmax on its
//   float32 accumulators (row max over each lane quad; the scale in
//   log2 units folded into the exponent's FMA, `ex2.approx`), rounds P to
//   bf16 in registers and uses it as the A operand of O += P V
//   (m64n{DV}k16, V read MN-major through the descriptor's transpose
//   flag), the [64 x DV] float32 output in registers; lane 0 of each
//   consumer warp then frees the stage.  Only tiles that reach above a
//   consumer's diagonal are masked; tiles wholly above its rows are
//   skipped (still waited for and freed).  Tiles are TMA boxes of [rows]
//   [64 columns] in 128-byte swizzle from rank-4 maps over [B, S, H, d]
//   (hopper_common.cuh), so rows past S are zero-filled and no tile
//   crosses a sequence: any S is legal.  Shared memory: Q and two stages
//   of K and V, 80 / 88 KB at hd 64 (NC 2 / 3), 160 KB at 128, 208 KB at
//   (192, 128).  Registers at NC 2: output 32 / 64 / 64, scores 64 and
//   their bf16 copy 32.
// * `flash_prefill_tc<DK, DV>` -- FlashAttention-2's layout on
//   `mma.sync.m16n8k16`: one block per (64-query tile, q head,
//   sequence), 4 warps of 16 query rows, K and V in two `cp.async` stages
//   of 64 keys (mma_common.cuh); kept for the reduced configurations'
//   hd 16 and for hd 32.
// * float32 at any (hd, dv), and bf16 at hd 256 -- the CUDA-core body:
//   float32 FMAs out of shared memory with the paged kernels' block code
//   (paged_common.cuh), 64 x 64 tiles up to hd 128, 32 x 32 above.
//
// Widths: Q/K hd, V and the output dv.  dv == hd, or the pair (192, 128);
// the C entry refuses any other.  The softmax scale is the caller's
// (1/sqrt(hd)).  Layouts: q [B,S,Hq,hd]; k [B,S,Hkv,hd]; v [B,S,Hkv,dv];
// out [B,S,Hq,dv]; one type for all four (float32 or bfloat16; the `wgmma`
// body needs 16-byte aligned bases, which the wrapper ensures); float32
// softmax and accumulation.  An optional `lse` [B,Hq,S] float32 receives
// each row's log-sum-exp of its scaled scores in natural-log units, which
// the backward kernels (flash_prefill_bwd.cu) use to recompute the
// probabilities; serving calls pass NULL and write nothing there.
#include "hopper_common.cuh"
#include "mma_common.cuh"
#include "paged_common.cuh"

// ---------------------------------------------------------------------------
// tensor-core body (bf16)
// ---------------------------------------------------------------------------
namespace flash_tc {
constexpr int QT = 64, KT = 64, NT = 128;
template <int W>
__host__ __device__ constexpr int ld() { return W + 8; }
template <int DK, int DV>
constexpr size_t smem_bytes() {  // Q and two stages of K and V
  return ((size_t)(QT + 2 * KT) * ld<DK>() + (size_t)2 * KT * ld<DV>()) *
         sizeof(__nv_bfloat16);
}
}  // namespace flash_tc

template <int DK, int DV>
__global__ void __launch_bounds__(flash_tc::NT)
    flash_prefill_tc(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     __nv_bfloat16* __restrict__ out,
                     float* __restrict__ lse, int S, int Hq, int Hkv,
                     float scale_log2) {
  using namespace flash_tc;
  constexpr int LD = ld<DK>(), LDV = ld<DV>(), KS = DK / 16, NS = KT / 8,
                NV = DV / 8;
  extern __shared__ float4 flash_smem[];
  __nv_bfloat16* sq = reinterpret_cast<__nv_bfloat16*>(flash_smem);
  __nv_bfloat16* sk = sq + QT * LD;      // [2][KT][LD]
  __nv_bfloat16* sv = sk + 2 * KT * LD;  // [2][KT][LDV]
  const int tile = gridDim.x - 1 - blockIdx.x;  // longest tiles first
  const int i0 = tile * QT, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t q_stride = (size_t)Hq * DK, k_stride = (size_t)Hkv * DK,
               v_stride = (size_t)Hkv * DV;
  const __nv_bfloat16* qb = q + ((size_t)b * S * Hq + h) * DK;
  const __nv_bfloat16* kb = k + ((size_t)b * S * Hkv + hk) * DK;
  const __nv_bfloat16* vb = v + ((size_t)b * S * Hkv + hk) * DV;

  mma::stage_rows<DK, NT>(sq, qb, q_stride, i0, S);
  mma::stage_rows<DK, NT>(sk, kb, k_stride, 0, S);
  mma::stage_rows<DV, NT>(sv, vb, v_stride, 0, S);
  mma::cp_async_commit();

  uint32_t qf[KS][4];
  float o[NV][4], m[2], l[2];
#pragma unroll
  for (int n = 0; n < NV; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  m[0] = m[1] = mma::neg_inf();
  l[0] = l[1] = 0.f;
  const int row0 = i0 + warp * 16 + (lane >> 2);  // rows row0, row0 + 8

  // key tiles 0 .. tile; the last one holds the diagonal
  for (int t = 0; t <= tile; ++t) {
    mma::cp_async_wait<0>();
    __syncthreads();  // tile t staged; stage (t+1)&1 no longer read
    if (t < tile) {
      const int st = (t + 1) & 1;
      mma::stage_rows<DK, NT>(sk + st * KT * LD, kb, k_stride,
                              (t + 1) * KT, S);
      mma::stage_rows<DV, NT>(sv + st * KT * LDV, vb, v_stride,
                              (t + 1) * KT, S);
      mma::cp_async_commit();
    }
    if (t == 0) {
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
        mma::ldsm_x4(qf[kk], mma::a_frag_addr(sq, LD, warp * 16, kk * 16,
                                              lane));
    }
    const __nv_bfloat16* kt = sk + (t & 1) * KT * LD;
    const __nv_bfloat16* vt = sv + (t & 1) * KT * LDV;

    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
#pragma unroll
      for (int np = 0; np < NS / 2; ++np) {
        uint32_t bk[4];
        mma::ldsm_x4(bk, mma::bk_frag_addr(kt, LD, np * 16, kk * 16, lane));
        mma::mma_bf16(s[2 * np], qf[kk], bk[0], bk[1]);
        mma::mma_bf16(s[2 * np + 1], qf[kk], bk[2], bk[3]);
      }
    const bool diag = t == tile;
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = t * KT + n * 8 + 2 * (lane & 3) + (e & 1);
        const int row = row0 + (e >> 1) * 8;
        s[n][e] = diag && key > row ? mma::neg_inf() : s[n][e] * scale_log2;
      }
    float alpha[2];
    mma::softmax_update<NS>(s, m, l, alpha);
#pragma unroll
    for (int n = 0; n < NV; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] *= alpha[e >> 1];
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk) {
      uint32_t pa[4];
      mma::probs_to_a<NS>(s, kk, pa);
#pragma unroll
      for (int np = 0; np < NV / 2; ++np) {
        uint32_t bv[4];
        mma::ldsm_x4_trans(bv, mma::bv_frag_addr(vt, LDV, kk * 16, np * 16,
                                                 lane));
        mma::mma_bf16(o[2 * np], pa, bv[0], bv[1]);
        mma::mma_bf16(o[2 * np + 1], pa, bv[2], bv[3]);
      }
    }
  }

#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int row = row0 + u * 8;
    const float den = fmaxf(mma::quad_sum(l[u]), 1e-30f);
    if (row >= S) continue;
    // m is in log2 units (the scale carries log2 e); the lane of the
    // row's quad with t = 0 writes it
    if (lse != nullptr && (lane & 3) == 0)
      lse[((size_t)b * Hq + h) * S + row] =
          (m[u] + log2f(den)) * 0.6931471805599453f;
    __nv_bfloat16* orow = out + (((size_t)b * S + row) * Hq + h) * DV;
#pragma unroll
    for (int n = 0; n < NV; ++n)
      *reinterpret_cast<uint32_t*>(orow + n * 8 + 2 * (lane & 3)) =
          mma::pack_bf16(o[n][2 * u] / den, o[n][2 * u + 1] / den);
  }
}

template <int DK, int DV = DK>
static int launch_tc(const void* q, const void* k, const void* v, void* out,
                     float* lse, int B, int S, int Hq, int Hkv, float scale,
                     cudaStream_t stream) {
  const size_t smem = flash_tc::smem_bytes<DK, DV>();
  auto kernel = flash_prefill_tc<DK, DV>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((S + flash_tc::QT - 1) / flash_tc::QT, Hq, B);
  kernel<<<grid, flash_tc::NT, smem, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (__nv_bfloat16*)out, lse, S, Hq, Hkv,
      scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// warp-specialised body (bf16 at (64, 64), (128, 128), (192, 128))
// ---------------------------------------------------------------------------
namespace flash_wg {
constexpr int KT = 128, STAGES = 2;
// Consumer warpgroups of 64 query rows, NC: two (a 128-row tile, 240
// registers a thread), or at hd 64 three (a 192-row tile; 160 registers
// hold the [64 x 64] output, the [64 x 128] scores and their bf16 copy)
// when that still gives the 132 SMs two blocks each (`launch_wg`).
// Byte offsets in the block's shared memory (from a 1024-byte boundary):
// Q [DK/64][QT][64], K [STAGES][DK/64][KT][64], V [STAGES][DV/64][KT][64],
// then the barriers (Q full; K full, V full, empty a stage).
template <int DK, int DV, int NC>
struct Smem {
  static constexpr int QT = 64 * NC;
  static constexpr size_t k = (size_t)QT * DK * 2;
  static constexpr size_t v = k + (size_t)STAGES * KT * DK * 2;
  static constexpr size_t bars = v + (size_t)STAGES * KT * DV * 2;
  static constexpr size_t bytes = bars + 8 * (1 + 3 * STAGES) + 1024;
};
}  // namespace flash_wg

// Block (query tile of 64 NC rows, longest first; q head; sequence), 128
// (NC + 1) threads: warpgroup 0 the producer (thread 0 issues the TMA
// loads of Q once and of K and V tiles 0 .. the tile's last diagonal into
// the ring), warpgroups 1 .. NC the consumers of 64 query rows each.  A
// consumer skips (but waits for and releases) key tiles wholly above its
// rows.
template <int DK, int DV, int NC>
__global__ void __launch_bounds__(128 * (NC + 1), 1)
    flash_prefill_wg(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     __nv_bfloat16* __restrict__ out,
                     float* __restrict__ lse, int S, int Hq, int Hkv,
                     float scale_log2, int lpt) {
  using namespace flash_wg;
  using L = Smem<DK, DV, NC>;
  using bf16 = __nv_bfloat16;
  constexpr int QT = L::QT;
  extern __shared__ unsigned char flash_wg_smem[];
  unsigned char* base = hop::align1024(flash_wg_smem);
  bf16* sq = reinterpret_cast<bf16*>(base);
  bf16* sk = reinterpret_cast<bf16*>(base + L::k);
  bf16* sv = reinterpret_cast<bf16*>(base + L::v);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(base + L::bars);
  uint64_t* full_k = q_full + 1;
  uint64_t* full_v = full_k + STAGES;
  uint64_t* empty = full_v + STAGES;
  const hop::BlockIdx at = hop::block_idx(lpt);
  const int tile = at.tiles - 1 - at.tile;  // longest tiles first
  const int q0 = tile * QT, h = at.head, b = at.b;
  const int hk = h / (Hq / Hkv);
  const int n_kt = (min(q0 + QT, S) - 1) / KT + 1;  // key tiles 0 .. diagonal
  if (threadIdx.x == 0) {
    hop::mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      hop::mbar_init(full_k + s, 1);
      hop::mbar_init(full_v + s, 1);
      hop::mbar_init(empty + s, 4 * NC);  // lane 0 of each consumer warp
    }
    hop::fence_barrier_init();
  }
  __syncthreads();
  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    hop::producer_regs();
    if (threadIdx.x == 0) {
      hop::mbar_expect_tx(q_full, hop::tile_bytes<DK, QT>());
      hop::tma_tile<DK, QT>(sq, &tq, q_full, h, q0, b);
      for (int t = 0; t < n_kt; ++t) {
        const int s = t % STAGES;
        if (t >= STAGES) hop::mbar_wait(empty + s, (t / STAGES - 1) & 1);
        hop::mbar_expect_tx(full_k + s, hop::tile_bytes<DK, KT>());
        hop::tma_tile<DK, KT>(sk + s * KT * DK, &tk, full_k + s, hk, t * KT,
                              b);
        hop::mbar_expect_tx(full_v + s, hop::tile_bytes<DV, KT>());
        hop::tma_tile<DV, KT>(sv + s * KT * DV, &tv, full_v + s, hk, t * KT,
                              b);
      }
    }
    return;
  }
  hop::consumer_regs<NC == 3 ? 160 : 240>();
  const int cw = wg - 1, tid = threadIdx.x - 128 * wg;
  const int warp = tid >> 5, lane = tid & 31;
  const int r_lo = q0 + 64 * cw;                    // this warpgroup's rows
  const int row0 = r_lo + 16 * warp + (lane >> 2);  // and row0 + 8
  float o[DV / 2], m[2], l[2];
#pragma unroll
  for (int i = 0; i < DV / 2; ++i) o[i] = 0.f;
  m[0] = m[1] = mma::neg_inf();
  l[0] = l[1] = 0.f;
  hop::mbar_wait(q_full, 0);

  for (int t = 0; t < n_kt; ++t) {
    const int s = t % STAGES;
    const uint32_t ph = (t / STAGES) & 1;
    const bf16* kt = sk + s * KT * DK;
    const bf16* vt = sv + s * KT * DV;
    hop::mbar_wait(full_k + s, ph);
    if (t * KT > r_lo + 63) {  // above every row of this warpgroup
      if (lane == 0) hop::mbar_arrive(empty + s);
      continue;
    }
    float sc[KT / 2];
    hop::wg_fence();
#pragma unroll
    for (int kk = 0; kk < DK / 16; ++kk)
      hop::mma_ss<KT>(sc, hop::desc_k<QT>(sq, 64 * cw, kk),
                      hop::desc_k<KT>(kt, 0, kk), kk > 0);
    hop::wg_commit();
    hop::wg_wait<0>();
    hop::fence_regs(sc);

    // only tiles that reach above the diagonal are masked; the scale (log2
    // units) is folded into the exponent's FMA: p = 2^(s scale_log2 - m)
    if (t * KT + KT - 1 > r_lo) {
#pragma unroll
      for (int j = 0; j < KT / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (t * KT + 8 * j + 2 * (lane & 3) + (e & 1) > row0 + 8 * (e >> 1))
            sc[4 * j + e] = mma::neg_inf();
    }
    float nbase[2], alpha[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      float mx = mma::neg_inf();
#pragma unroll
      for (int j = 0; j < KT / 8; ++j)
        mx = fmaxf(mx, fmaxf(sc[4 * j + 2 * u], sc[4 * j + 2 * u + 1]));
      mx = fmaxf(m[u], mma::quad_max(mx) * scale_log2);
      const float base_ = mx == mma::neg_inf() ? 0.f : mx;
      alpha[u] = hop::ex2(m[u] - base_);
      m[u] = mx;
      nbase[u] = -base_;
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < KT / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sc[4 * j + e] = hop::ex2(fmaf(sc[4 * j + e], scale_log2,
                                      nbase[e >> 1]));
        sum[e >> 1] += sc[4 * j + e];
      }
#pragma unroll
    for (int u = 0; u < 2; ++u) l[u] = l[u] * alpha[u] + sum[u];
#pragma unroll
    for (int j = 0; j < DV / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[4 * j + e] *= alpha[e >> 1];
    uint32_t pa[KT / 16][4];
    hop::acc_to_a<KT>(sc, pa);

    hop::mbar_wait(full_v + s, ph);
    hop::fence_regs(o);
    hop::fence_regs(pa);
    hop::wg_fence();
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk)
      hop::mma_rs<DV>(o, pa[kk], hop::desc_mn<KT>(vt, kk));
    hop::wg_commit();
    hop::wg_wait<0>();
    hop::fence_regs(o);
    if (lane == 0) hop::mbar_arrive(empty + s);
  }

#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int row = row0 + u * 8;
    const float den = fmaxf(mma::quad_sum(l[u]), 1e-30f);
    if (row >= S) continue;
    if (lse != nullptr && (lane & 3) == 0)
      lse[((size_t)b * Hq + h) * S + row] =
          (m[u] + log2f(den)) * 0.6931471805599453f;
    bf16* orow = out + (((size_t)b * S + row) * Hq + h) * DV;
#pragma unroll
    for (int j = 0; j < DV / 8; ++j)
      *reinterpret_cast<uint32_t*>(orow + j * 8 + 2 * (lane & 3)) =
          hop::pack_bf16(o[4 * j + 2 * u] / den, o[4 * j + 2 * u + 1] / den);
  }
}

template <int DK, int DV, int NC = 2>
static int launch_wg(const void* q, const void* k, const void* v, void* out,
                     float* lse, int B, int S, int Hq, int Hkv, float scale,
                     cudaStream_t stream) {
  using namespace flash_wg;
  constexpr int QT = Smem<DK, DV, NC>::QT;
  CUtensorMap tq, tk, tv;
  int rc = make_map(&tq, q, B, S, Hq, DK, QT);
  if (rc == 0) rc = make_map(&tk, k, B, S, Hkv, DK, KT);
  if (rc == 0) rc = make_map(&tv, v, B, S, Hkv, DV, KT);
  if (rc != 0) return rc;
  const size_t smem = Smem<DK, DV, NC>::bytes;
  auto kernel = flash_prefill_wg<DK, DV, NC>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  // longest tiles first across heads where K and V fit in 40 MB of L2
  // (on an H100 at 4 x 4096, 32 / 8, hd 64: 33.5 MB, 6 % faster than
  // head-major)
  const int tiles = (S + QT - 1) / QT;
  const int lpt = hop::longest_first((size_t)tiles * Hq * B,
                                     (size_t)B * S * Hkv * (DK + DV) * 2,
                                     (size_t)40 << 20);
  kernel<<<hop::grid_of(lpt, tiles, Hq, B), 128 * (NC + 1), smem, stream>>>(
      tq, tk, tv, (__nv_bfloat16*)out, lse, S, Hq, Hkv,
      scale * 1.4426950408889634f, lpt);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// CUDA-core body (float32, and bf16 at hd 256)
// ---------------------------------------------------------------------------
template <typename T>
__global__ void flash_prefill_kernel(const T* __restrict__ q,
                                     const T* __restrict__ k,
                                     const T* __restrict__ v,
                                     T* __restrict__ out,
                                     float* __restrict__ lse, int S, int Hq,
                                     int Hkv, int hd, int dv, int QT, int KT,
                                     float scale) {
  extern __shared__ float smem[];
  const int i0 = blockIdx.x * QT, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int nq = min(QT, S - i0);
  Tile t = carve_tile(smem, QT, KT, hd, dv);

  for (int i = threadIdx.x; i < QT * hd; i += blockDim.x) {
    const int r = i / hd, d = i - (i / hd) * hd;
    t.q[i] = r < nq ? to_f(q[(((size_t)b * S + i0 + r) * Hq + h) * hd + d])
                    : 0.f;
  }
  tile_init(t, QT, dv);
  __syncthreads();

  // key tiles up to the one holding the last row's diagonal
  const int last = i0 + nq - 1;
  for (int j0 = 0; j0 <= last; j0 += KT) {
    const int rows = min(KT, S - j0);
    // K rows hd wide (padded to hd + 1), V rows dv <= hd wide
    for (int i = threadIdx.x; i < KT * hd; i += blockDim.x) {
      const int j = i / hd, d = i - j * hd;
      const size_t row = ((size_t)b * S + j0 + j) * Hkv + hk;
      t.k[j * (hd + 1) + d] = j < rows ? to_f(k[row * hd + d]) : 0.f;
      if (d < dv) t.v[j * dv + d] = j < rows ? to_f(v[row * dv + d]) : 0.f;
    }
    __syncthreads();
    tile_scores(t, QT, KT, hd, scale, [&](int r, int j) {
      return r < nq && j0 + j <= i0 + r;
    });
    tile_update(t, QT, KT, dv);
  }

  for (int i = threadIdx.x; i < nq * dv; i += blockDim.x) {
    const int r = i / dv, d = i - (i / dv) * dv;
    out[(((size_t)b * S + i0 + r) * Hq + h) * dv + d] =
        from_f<T>(t.acc[i] / fmaxf(t.l[r], 1e-30f));
  }
  // m is in natural-log units here (tile_update runs expf)
  if (lse != nullptr)
    for (int r = threadIdx.x; r < nq; r += blockDim.x)
      lse[((size_t)b * Hq + h) * S + i0 + r] =
          t.m[r] + logf(fmaxf(t.l[r], 1e-30f));
}

template <typename T>
static int launch(const void* q, const void* k, const void* v, void* out,
                  float* lse, int B, int S, int Hq, int Hkv, int hd, int dv,
                  float scale, cudaStream_t stream) {
  // 64 x 64 tiles up to hd 128 (148 KB of shared memory), 32 x 32 above
  const int QT = hd <= 128 ? 64 : 32, KT = QT;
  const size_t smem = tile_floats(QT, KT, hd, dv) * sizeof(float);
  auto kernel = flash_prefill_kernel<T>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((S + QT - 1) / QT, Hq, B);
  kernel<<<grid, 256, smem, stream>>>((const T*)q, (const T*)k, (const T*)v,
                                      (T*)out, lse, S, Hq, Hkv, hd, dv, QT,
                                      KT, scale);
  return (int)cudaGetLastError();
}

// The widths the kernel takes: dv == hd, or MLA's (192, 128).
static bool widths_ok(int hd, int dv) {
  return dv == hd || (hd == 192 && dv == 128);
}

// The body `flash_prefill` runs: 2, the warp-specialised `wgmma` body
// (bf16 at (64, 64), (128, 128), (192, 128)); 1, the `mma.sync` body (bf16
// at hd 16 and 32); 0, the CUDA-core body (float32, bf16 at hd 256).
static int body(int hd, int dv, int dtype) {
  if (dtype != 1) return 0;
  if ((hd == 192 && dv == 128) || (dv == hd && (hd == 64 || hd == 128)))
    return 2;
  return dv == hd && (hd == 16 || hd == 32) ? 1 : 0;
}

// dtype codes: 0 = float32, 1 = bfloat16.  hd: the width of q and k; dv:
// the width of v and the output.  `lse` is NULL or [B,Hq,S] float32.
extern "C" int flash_prefill(const void* q, const void* k, const void* v,
                             void* out, void* lse_out, int B, int S, int Hq,
                             int Hkv, int hd, int dv, float scale, int dtype,
                             void* stream) {
  if (!widths_ok(hd, dv)) return (int)cudaErrorInvalidValue;
  if (B == 0 || S == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  float* lse = (float*)lse_out;
  switch (body(hd, dv, dtype)) {
    case 2:
      if (hd == 192)
        return launch_wg<192, 128>(q, k, v, out, lse, B, S, Hq, Hkv, scale,
                                   st);
      // hd 64: three consumers where 192-row tiles still give the 132
      // SMs two blocks each
      if (hd == 64 && (long long)(S + 191) / 192 * Hq * B >= 2 * 132)
        return launch_wg<64, 64, 3>(q, k, v, out, lse, B, S, Hq, Hkv, scale,
                                    st);
      if (hd == 64)
        return launch_wg<64, 64>(q, k, v, out, lse, B, S, Hq, Hkv, scale, st);
      return launch_wg<128, 128>(q, k, v, out, lse, B, S, Hq, Hkv, scale, st);
    case 1:
      if (hd == 16)
        return launch_tc<16>(q, k, v, out, lse, B, S, Hq, Hkv, scale, st);
      return launch_tc<32>(q, k, v, out, lse, B, S, Hq, Hkv, scale, st);
  }
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, out, lse, B, S, Hq, Hkv, hd, dv,
                                 scale, st);
  if (dtype == 0)
    return launch<float>(q, k, v, out, lse, B, S, Hq, Hkv, hd, dv, scale, st);
  return (int)cudaErrorInvalidValue;
}

// The body `flash_prefill` runs for this type and these widths: 2 the
// `wgmma` body, 1 the `mma.sync` body, 0 the CUDA-core body.
extern "C" int flash_prefill_tensor_core(int hd, int dv, int dtype) {
  return widths_ok(hd, dv) ? body(hd, dv, dtype) : 0;
}
