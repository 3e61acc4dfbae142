// Causal flash attention over one dense sequence (monolithic prefill) for
// GQA / MHA / MQA on Hopper.
//
// Replaces the Pallas TPU kernel `flash_prefill`
// (src/repro/kernels/flash_prefill.py), which computes
// `models/attention.causal_attention` with no query offset: query i of a
// sequence of S tokens attends keys j <= i, and query head h reads KV
// head h / (Hq / Hkv).
//
// Bound on the H100: at the serving path's prompt lengths (a few hundred
// tokens) the bytes.  A sequence does 4 * S(S+1)/2 * Hq * hd flops over
// (2 * S * Hq + 2 * S * Hkv) * hd elements moved: about 0.4 * S flops per
// bf16 byte at Hq = 32, Hkv = 8, so the card's ~295 is crossed only near
// S = 740.  In practice a kernel at these sizes is held by latency: a
// 64-query tile walks at most S / 64 key tiles in order.
//
// Two bodies, chosen by type and width in `flash_prefill` below (never a
// retry after a failure):
//
// * bf16 at hd 16, 32, 64, 128 -- the tensor-core body, FlashAttention-2's
//   layout.  One block per (64-query tile, q head, sequence), 4 warps of
//   16 query rows; each warp keeps its Q fragment in registers, computes
//   S = Q K^T into float32 fragments with `mma.sync.m16n8k16` bf16, runs
//   the online softmax on the fragment rows (quad shuffles), rounds P to
//   bf16 in registers and uses it as the A operand of P V (V through
//   `ldmatrix.trans`); the accumulator [16 x hd] float32 stays in
//   registers.  K and V tiles of 64 keys are staged as bf16 by 16-byte
//   `cp.async` into two stages, so tile j+1 loads while tile j computes
//   (padded rows: conflict-free `ldmatrix`, mma_common.cuh).  Only the
//   diagonal tile is masked; rows and keys >= S of a ragged last tile
//   are zero-filled and never written, so any S is legal.  Blocks start
//   with the longest query tiles.  The same body takes MLA's training
//   widths, Q/K 192 over V 128 (`flash_prefill_tc<192, 128>`: the
//   non-absorbed form the JAX package trains, K = [c_kv W_uk ; k_rope]
//   and V = c_kv W_uv per head): Q fragments 48 registers, the [16 x 128]
//   accumulator 64; Q and two stages of K (192) and V (128) take 109 KB
//   of shared memory.
// * float32 at any (hd, dv), and bf16 at hd 256 -- the CUDA-core body:
//   float32 FMAs out of shared memory with the paged kernels' block code
//   (paged_common.cuh), 64 x 64 tiles up to hd 128, 32 x 32 above.
//
// Widths: Q/K hd, V and the output dv.  dv == hd, or the pair (192, 128);
// the C entry refuses any other.  The softmax scale is the caller's
// (1/sqrt(hd)).  Layouts: q [B,S,Hq,hd]; k [B,S,Hkv,hd]; v [B,S,Hkv,dv];
// out [B,S,Hq,dv]; one type for all four (float32 or bfloat16); float32
// softmax and accumulation.
// An optional `lse` [B,Hq,S] float32 receives each row's log-sum-exp of
// its scaled scores in natural-log units, which the backward kernels
// (flash_prefill_bwd.cu) use to recompute the probabilities; serving
// calls pass NULL and write nothing there.
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

// The tensor-core body takes bf16 at hd 16, 32, 64 and 128 (dv == hd),
// and at (192, 128).
static bool tensor_core(int hd, int dv, int dtype) {
  if (dtype != 1) return false;
  if (hd == 192 && dv == 128) return true;
  return dv == hd && (hd == 16 || hd == 32 || hd == 64 || hd == 128);
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
  if (tensor_core(hd, dv, dtype)) {
    if (hd == 192)
      return launch_tc<192, 128>(q, k, v, out, lse, B, S, Hq, Hkv, scale, st);
    if (hd == 16)
      return launch_tc<16>(q, k, v, out, lse, B, S, Hq, Hkv, scale, st);
    if (hd == 32)
      return launch_tc<32>(q, k, v, out, lse, B, S, Hq, Hkv, scale, st);
    if (hd == 64)
      return launch_tc<64>(q, k, v, out, lse, B, S, Hq, Hkv, scale, st);
    return launch_tc<128>(q, k, v, out, lse, B, S, Hq, Hkv, scale, st);
  }
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, out, lse, B, S, Hq, Hkv, hd, dv,
                                 scale, st);
  if (dtype == 0)
    return launch<float>(q, k, v, out, lse, B, S, Hq, Hkv, hd, dv, scale, st);
  return (int)cudaErrorInvalidValue;
}

// 1 when `flash_prefill` runs the tensor-core body for this type and these
// widths.
extern "C" int flash_prefill_tensor_core(int hd, int dv, int dtype) {
  return widths_ok(hd, dv) && tensor_core(hd, dv, dtype);
}
