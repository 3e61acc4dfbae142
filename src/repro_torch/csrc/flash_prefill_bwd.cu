// Backward of causal GQA attention over one dense sequence on Hopper: the
// gradients dQ, dK, dV of `flash_prefill.cu`'s output given dO.
//
// Replaces what `jax.grad` derives from `models/attention.causal_attention`
// in the JAX package, which differentiates its attention in `jnp`: there
// is no Pallas backward to translate.  Query i of a sequence of S tokens
// attends keys j <= i, query head h reads KV head h / G (G = Hq / Hkv).
// With the forward's per-row log-sum-exp `lse` (natural-log units, from
// flash_prefill.cu) the probabilities are recomputed tile by tile,
//
//   P   = exp(scale * Q K^T - lse)          (0 where j > i)
//   D   = rowsum(dO o O)
//   dS  = P o (dO V^T - D)
//   dV  = P^T dO,   dK = scale * dS^T Q,   dQ = scale * dS K,
//
// so no S x S matrix is ever stored.  `bwd_delta` computes D [B,Hq,S]
// float32, 16 bytes of o and dO a lane; then a dK/dV kernel and a dQ
// kernel, each recomputing P and dS for its tiles (FlashAttention-2's
// backward layout).  No atomics anywhere: the GQA sum and any split of a
// walk are summed in a fixed order, so two runs give the same bits (a
// training run that resumes from a checkpoint relies on that).
//
// Bound on the H100: the operations.  A sequence does 10 * S(S+1)/2 * Hq
// * hd flops of products (the QK^T recompute, dO V^T, dV, dK, dQ; the dQ
// kernel recomputes QK^T and dO V^T, 14 in all) over (4 * S * Hq + 4 * S
// * Hkv) * hd elements moved, ~1.2 * S flops a bf16 byte at Hq 32 / Hkv
// 8: past the card's ~295 from S ~250.  Three bodies, chosen by type and
// width in the C entry below (never a retry after a failure);
// `flash_prefill_bwd_tensor_core` names the one a call takes (2, 1, 0):
//
//   bf16 (64, 64)     `bwd_dkdv_wg<64>` (128-key blocks), `bwd_dq_wg<64,
//                     64>` (128-key tiles)
//   bf16 (128, 128)   `bwd_dkdv_pair_wg<128, 128>`, `bwd_dq_wg<128, 128>`
//                     (64-key tiles)
//   bf16 (192, 128)   `bwd_dkdv_pair_wg<192, 128>`, `bwd_dq_wg<192, 128>`
//                     (32-key tiles; MLA's training widths)
//   bf16 (16, 16)     `bwd_dkdv_tc<16>`, `bwd_dq_tc<16, 16>` (`mma.sync`)
//   float32           `bwd_dkdv`, `bwd_dq` (CUDA cores)
//
// and `bwd_dkdv_combine` after any dK/dV kernel whose walk was split.
//
// * The warp-specialised bodies (hopper_common.cuh): 384 threads a
//   block, warpgroup 0 the producer (`setmaxnreg.dec` to 24; TMA loads
//   into `mbarrier` rings of two stages, tiles of [rows][64 columns] in
//   128-byte swizzle from rank-4 maps over [B, S, H, d], so rows past S
//   are zero-filled), warpgroups 1 and 2 the consumers (240 registers a
//   thread), every product a `wgmma.mma_async` with float32 accumulators:
//   - `bwd_dkdv_wg<64>`: one block per (128-key tile, KV head, sequence),
//     each consumer owning 64 of the keys; the key tiles with the longest
//     walks start first across all heads where the grid is more than a
//     wave and Q and dO fit in 40 MB of L2 (`hop::longest_first`; the
//     pair kernel too).  K and V are loaded once; the
//     producer warp then streams, for each query head of the group and
//     each 64-query tile from the diagonal down, Q and dO (TMA, lane 0)
//     and lse log2e and D (its 32 lanes) through the ring; the `full`
//     barrier counts the 32 lanes and the TMA bytes.  A consumer forms
//     S^T = K Q^T and dP^T = V dO^T (m64n64k16 from shared memory, K-major),
//     recomputes P^T = 2^(S^T scale log2e - lse log2e) (`ex2.approx`) and
//     dS^T = P^T o (dP^T - D), rounds both to bf16 A fragments in registers
//     and accumulates dV += P^T dO and dK += dS^T Q (m64n64k16, dO and Q
//     MN-major through the transpose flag) in float32 registers: dK and dV
//     [64 x 64] 64 registers, S^T and dP^T 64, their bf16 copies 32.  A
//     query tile wholly above a consumer's keys is skipped (still waited
//     for and freed).
//   - `bwd_dkdv_pair_wg<DK, DV>` (hd 128 and MLA's 192 / 128): one
//     warpgroup owning dK [64 x DK] and dV [64 x DV] of 64 keys would hold
//     128 (hd 128) or 160 (192 / 128) float32 accumulators a thread before
//     any score, so the two consumers split them over the same 64 keys
//     (the `mma.sync` body split them over warp pairs; 64-key tiles
//     with 32-row halves would halve every product's depth instead):
//     warpgroup 1 forms S^T and P^T, hands P^T (float32, in fragment
//     order, double-buffered, 32 KB) to warpgroup 2 through shared memory
//     under named barriers and accumulates dV += P^T dO; warpgroup 2 forms
//     dP^T meanwhile, reads P^T, forms dS^T and accumulates dK += dS^T Q.
//     The two do the same products' work: 64 x 64 x (DK + DV) each.
//   - `bwd_dq_wg<DK, DV>`: one block per (128-query tile, q head,
//     sequence), longest first, each consumer owning 64 rows; Q and dO
//     loaded once, K and V tiles of 128 (hd 64), 64 (hd 128) or 32 keys
//     (192 / 128: dQ [64 x 192] takes 96 registers) from 0 to the diagonal
//     through the ring; S = Q K^T and dP = dO V^T from shared memory, dS
//     in registers, dQ += dS K (K MN-major) in float32 registers, scaled
//     at the end.  Key tiles wholly above a consumer's rows are skipped.
//   Small batches: when one dK/dV block a key tile would leave SMs idle
//   (fewer than 132 blocks: one of these blocks an SM; the wrapper's
//   `bwd_kv_chunk`), the walk of each key tile is cut into chunks of
//   `chunk` query tiles, about 2 x 132 blocks in all, that write float32
//   partials; `bwd_dkdv_combine` sums them in chunk order.
// * `bwd_dkdv_tc<16>` / `bwd_dq_tc<16, 16>` -- the `mma.sync.m16n8k16`
//   body (mma_common.cuh), 4 warps a block, 64-key and 64-query tiles
//   staged by `cp.async` into two stages, the same walk and split (two
//   blocks an SM: unsplit from 264 blocks); kept
//   for the reduced configurations' hd 16, which the examples train.
// * float32 -- the CUDA-core body: float32 FMAs out of shared memory
//   (each thread a 4 x 4 register tile of scores and a 4 x hd/16 tile of
//   its outputs, rows padded by one float so the 16 keys or rows a
//   half-warp reads sit in 16 banks), `bwd_dkdv` and `bwd_dq` on the same
//   grids as above without a split.  The tensor cores take bf16, so
//   float32 (the CPU-parity checks) stays on the CUDA cores' 67 TFLOP/s.
//
// Widths: Q/K hd, V, O and dO hdv; (hd, hdv) is (64, 64), (128, 128) (the
// trainable GQA families), (16, 16) (their reduced configurations) or
// (192, 128) (MLA).  Layouts: q/dq [B,S,Hq,hd]; o/dO [B,S,Hq,hdv]; k/dk
// [B,S,Hkv,hd]; v/dv [B,S,Hkv,hdv]; lse and the D scratch [B,Hq,S]
// float32.  One type (float32 or bfloat16) for q, k, v, o, dO and the
// gradients; float32 everywhere inside.  The scale is the caller's
// (1/sqrt(hd)).
#include "hopper_common.cuh"
#include "mma_common.cuh"
#include "paged_common.cuh"

// ---------------------------------------------------------------------------
// CUDA-core body (float32) and D
// ---------------------------------------------------------------------------
namespace flash_bwd {
constexpr int T64 = 64;   // keys and queries a tile
constexpr int NT = 256;   // threads: 16 x 16
constexpr int LDP = T64 + 1;
template <int W>
__host__ __device__ constexpr int ldh() { return W + 1; }
template <int DK, int DV>
constexpr size_t smem_bytes() {  // K, V, Q, dO tiles; P, dS; lse, D
  return (size_t)(2 * T64 * (ldh<DK>() + ldh<DV>()) + 2 * T64 * LDP +
                  2 * T64) *
         sizeof(float);
}

template <int DK, int DV>
struct Smem {
  float *k, *v, *q, *dout, *p, *ds, *lse, *delta;
  __device__ explicit Smem(float* base) {
    constexpr int LK = ldh<DK>(), LV = ldh<DV>();
    k = base;
    v = k + T64 * LK;
    q = v + T64 * LV;
    dout = q + T64 * LK;
    p = dout + T64 * LV;
    ds = p + T64 * LDP;
    lse = ds + T64 * LDP;
    delta = lse + T64;
  }
};

// Rows r0 .. r0+63 of one head (W elements a row, row stride `stride`)
// into a [64][W + 1] float tile; rows >= S are zero.
template <int W, typename T>
__device__ __forceinline__ void load_rows(float* dst, const T* src,
                                          size_t stride, int r0, int S) {
  constexpr int L = ldh<W>();
  for (int i = threadIdx.x; i < T64 * W; i += NT) {
    const int r = i / W, d = i - r * W;
    dst[r * L + d] =
        r0 + r < S ? to_f(src[(size_t)(r0 + r) * stride + d]) : 0.f;
  }
}

// lse and D of rows i0 .. i0+63 of head h ([B,Hq,S] rows); 0 past S.
__device__ __forceinline__ void load_row_stats(float* lse_s, float* d_s,
                                               const float* lse,
                                               const float* delta,
                                               size_t row0, int i0, int S) {
  for (int r = threadIdx.x; r < T64; r += NT) {
    const bool ok = i0 + r < S;
    lse_s[r] = ok ? lse[row0 + i0 + r] : 0.f;
    d_s[r] = ok ? delta[row0 + i0 + r] : 0.f;
  }
}

// P and dS of one (64-query, 64-key) tile pair from the staged Q, dO, K,
// V, lse and D: thread (tx, ty) computes rows ty + 16a and keys tx + 16b.
// Entries past S or above the diagonal are 0.  `want_p`: also store P.
// The scores run over DK columns, dP over DV: one loop over the columns
// both have, then the wider one's alone (MLA: Q/K 192 over V 128).
template <int DK, int DV>
__device__ __forceinline__ void probs_tile(const Smem<DK, DV>& sm, int i0,
                                           int j0, int S, float scale,
                                           bool want_p) {
  constexpr int LK = ldh<DK>(), LV = ldh<DV>();
  constexpr int DN = DK < DV ? DK : DV;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float s[4][4], dp[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) s[a][b] = dp[a][b] = 0.f;
#pragma unroll 4
  for (int d = 0; d < DN; ++d) {
    float qa[4], oa[4], kb[4], vb[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      qa[a] = sm.q[(ty + 16 * a) * LK + d];
      oa[a] = sm.dout[(ty + 16 * a) * LV + d];
      kb[a] = sm.k[(tx + 16 * a) * LK + d];
      vb[a] = sm.v[(tx + 16 * a) * LV + d];
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        s[a][b] = fmaf(qa[a], kb[b], s[a][b]);
        dp[a][b] = fmaf(oa[a], vb[b], dp[a][b]);
      }
  }
#pragma unroll 4
  for (int d = DN; d < DK; ++d) {
    float qa[4], kb[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      qa[a] = sm.q[(ty + 16 * a) * LK + d];
      kb[a] = sm.k[(tx + 16 * a) * LK + d];
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) s[a][b] = fmaf(qa[a], kb[b], s[a][b]);
  }
#pragma unroll 4
  for (int d = DN; d < DV; ++d) {
    float oa[4], vb[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      oa[a] = sm.dout[(ty + 16 * a) * LV + d];
      vb[a] = sm.v[(tx + 16 * a) * LV + d];
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) dp[a][b] = fmaf(oa[a], vb[b], dp[a][b]);
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int r = ty + 16 * a, i = i0 + r;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int c = tx + 16 * b, j = j0 + c;
      const bool ok = i < S && j <= i;
      const float pv = ok ? expf(s[a][b] * scale - sm.lse[r]) : 0.f;
      if (want_p) sm.p[r * LDP + c] = pv;
      sm.ds[r * LDP + c] = pv * (dp[a][b] - sm.delta[r]);
    }
  }
}
}  // namespace flash_bwd

// D = rowsum(dO o O): L = hd * sizeof(T) / 16 neighbouring lanes a (b, i,
// h) row (hd / 8 in bf16, hd / 4 in float32), 16 bytes of o and of dO
// each.
template <typename T>
__global__ void bwd_delta(const T* __restrict__ o, const T* __restrict__ dout,
                          float* __restrict__ delta, int B, int S, int Hq,
                          int hd) {
  constexpr int E = 16 / sizeof(T);  // elements a 16-byte load
  const int L = hd / E;
  const size_t tid = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t row = tid / L;
  const int sub = (int)(tid % L);
  const bool ok = row < (size_t)B * S * Hq;
  float acc = 0.f;
  if (ok) {
    const uint4 a = *reinterpret_cast<const uint4*>(o + row * hd + sub * E);
    const uint4 g =
        *reinterpret_cast<const uint4*>(dout + row * hd + sub * E);
    const T* av = reinterpret_cast<const T*>(&a);
    const T* gv = reinterpret_cast<const T*>(&g);
#pragma unroll
    for (int e = 0; e < E; ++e) acc += to_f(av[e]) * to_f(gv[e]);
  }
  for (int m = L / 2; m > 0; m >>= 1)  // every lane takes part
    acc += __shfl_xor_sync(0xffffffffu, acc, m);
  if (ok && sub == 0) {
    const int h = (int)(row % Hq);
    const size_t bi = row / Hq;  // b * S + i
    const int i = (int)(bi % S), b = (int)(bi / S);
    delta[((size_t)b * Hq + h) * S + i] = acc;
  }
}

template <typename T, int DK, int DV>
__global__ void __launch_bounds__(flash_bwd::NT)
    bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const T* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ delta,
             T* __restrict__ dk, T* __restrict__ dv, int S, int Hq, int Hkv,
             float scale) {
  using namespace flash_bwd;
  constexpr int LK = ldh<DK>(), LV = ldh<DV>(), NCK = DK / 16,
                NCV = DV / 16, NCM = NCK > NCV ? NCK : NCV;
  extern __shared__ float bwd_smem[];
  const Smem<DK, DV> sm(bwd_smem);
  const int kt = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int j0 = kt * T64, G = Hq / Hkv, n_tiles = (S + T64 - 1) / T64;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const size_t q_stride = (size_t)Hq * DK, o_stride = (size_t)Hq * DV;
  const size_t k_stride = (size_t)Hkv * DK, v_stride = (size_t)Hkv * DV;
  const size_t k_base = ((size_t)b * S * Hkv + hk) * DK;
  const size_t v_base = ((size_t)b * S * Hkv + hk) * DV;
  load_rows<DK>(sm.k, k + k_base, k_stride, j0, S);
  load_rows<DV>(sm.v, v + v_base, v_stride, j0, S);

  float acc_k[4][NCK], acc_v[4][NCV];  // keys ty + 16a, columns tx + 16c
#pragma unroll
  for (int a = 0; a < 4; ++a) {
#pragma unroll
    for (int c = 0; c < NCK; ++c) acc_k[a][c] = 0.f;
#pragma unroll
    for (int c = 0; c < NCV; ++c) acc_v[a][c] = 0.f;
  }

  for (int g = 0; g < G; ++g) {
    const int h = hk * G + g;
    const size_t q_base = ((size_t)b * S * Hq + h) * DK;
    const size_t o_base = ((size_t)b * S * Hq + h) * DV;
    const size_t row0 = ((size_t)b * Hq + h) * S;
    for (int qt = kt; qt < n_tiles; ++qt) {
      const int i0 = qt * T64;
      __syncthreads();  // the previous tile's Q, dO, P, dS are consumed
      load_rows<DK>(sm.q, q + q_base, q_stride, i0, S);
      load_rows<DV>(sm.dout, dout + o_base, o_stride, i0, S);
      load_row_stats(sm.lse, sm.delta, lse, delta, row0, i0, S);
      __syncthreads();
      probs_tile<DK, DV>(sm, i0, j0, S, scale, true);
      __syncthreads();
      const int rows = min(T64, S - i0);
      for (int r = 0; r < rows; ++r) {
        float pa[4], da[4], ov[NCV], qv[NCK];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          pa[a] = sm.p[r * LDP + ty + 16 * a];
          da[a] = sm.ds[r * LDP + ty + 16 * a];
        }
#pragma unroll
        for (int c = 0; c < NCM; ++c) {
          if (c < NCV) ov[c] = sm.dout[r * LV + tx + 16 * c];
          if (c < NCK) qv[c] = sm.q[r * LK + tx + 16 * c];
        }
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int c = 0; c < NCM; ++c) {
            if (c < NCV) acc_v[a][c] = fmaf(pa[a], ov[c], acc_v[a][c]);
            if (c < NCK) acc_k[a][c] = fmaf(da[a], qv[c], acc_k[a][c]);
          }
      }
    }
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int j = j0 + ty + 16 * a;
    if (j >= S) continue;
#pragma unroll
    for (int c = 0; c < NCM; ++c) {
      if (c < NCK)
        dk[k_base + (size_t)j * k_stride + tx + 16 * c] =
            from_f<T>(acc_k[a][c] * scale);
      if (c < NCV)
        dv[v_base + (size_t)j * v_stride + tx + 16 * c] =
            from_f<T>(acc_v[a][c]);
    }
  }
}

template <typename T, int DK, int DV>
__global__ void __launch_bounds__(flash_bwd::NT)
    bwd_dq(const T* __restrict__ q, const T* __restrict__ k,
           const T* __restrict__ v, const T* __restrict__ dout,
           const float* __restrict__ lse, const float* __restrict__ delta,
           T* __restrict__ dq, int S, int Hq, int Hkv, float scale) {
  using namespace flash_bwd;
  constexpr int LK = ldh<DK>(), NC = DK / 16;
  extern __shared__ float bwd_smem[];
  const Smem<DK, DV> sm(bwd_smem);
  const int qt = gridDim.x - 1 - blockIdx.x;  // longest tiles first
  const int h = blockIdx.y, b = blockIdx.z, hk = h / (Hq / Hkv);
  const int i0 = qt * T64;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const size_t q_stride = (size_t)Hq * DK, o_stride = (size_t)Hq * DV;
  const size_t k_stride = (size_t)Hkv * DK, v_stride = (size_t)Hkv * DV;
  const size_t q_base = ((size_t)b * S * Hq + h) * DK;
  const size_t k_base = ((size_t)b * S * Hkv + hk) * DK;
  const size_t v_base = ((size_t)b * S * Hkv + hk) * DV;
  load_rows<DK>(sm.q, q + q_base, q_stride, i0, S);
  load_rows<DV>(sm.dout, dout + ((size_t)b * S * Hq + h) * DV, o_stride, i0,
                S);
  load_row_stats(sm.lse, sm.delta, lse, delta, ((size_t)b * Hq + h) * S, i0,
                 S);

  float acc[4][NC];  // rows ty + 16a, columns tx + 16c
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[a][c] = 0.f;

  for (int t = 0; t <= qt; ++t) {
    const int j0 = t * T64;
    __syncthreads();  // the previous key tile and its dS are consumed
    load_rows<DK>(sm.k, k + k_base, k_stride, j0, S);
    load_rows<DV>(sm.v, v + v_base, v_stride, j0, S);
    __syncthreads();
    probs_tile<DK, DV>(sm, i0, j0, S, scale, false);
    __syncthreads();
    const int keys = min(T64, S - j0);
    for (int j = 0; j < keys; ++j) {
      float da[4], kv[NC];
#pragma unroll
      for (int a = 0; a < 4; ++a) da[a] = sm.ds[(ty + 16 * a) * LDP + j];
#pragma unroll
      for (int c = 0; c < NC; ++c) kv[c] = sm.k[j * LK + tx + 16 * c];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[a][c] = fmaf(da[a], kv[c], acc[a][c]);
    }
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = i0 + ty + 16 * a;
    if (i >= S) continue;
    const size_t off = q_base + (size_t)i * q_stride;
#pragma unroll
    for (int c = 0; c < NC; ++c)
      dq[off + tx + 16 * c] = from_f<T>(acc[a][c] * scale);
  }
}

// ---------------------------------------------------------------------------
// tensor-core body (bf16)
// ---------------------------------------------------------------------------
namespace bwd_tc {
constexpr int T = 64;    // keys and queries a tile
constexpr int NT = 128;  // 4 warps of 16 keys (dK/dV) or query rows (dQ)
constexpr float LOG2E = 1.4426950408889634f;
template <int HD>
__host__ __device__ constexpr int ld() { return HD + 8; }
template <int HD>
constexpr size_t smem_bytes() {
  // six bf16 tiles (dK/dV: K, V, two stages of Q and dO; dQ: Q, dO, two
  // stages of K and V) and two stages of the 64 rows' lse and D (dK/dV)
  return (size_t)6 * T * ld<HD>() * sizeof(__nv_bfloat16) +
         (size_t)4 * T * sizeof(float);
}
// the dQ kernel: Q, dO and two stages of K and V
template <int DK, int DV>
constexpr size_t dq_smem_bytes() {
  return (size_t)3 * T * (ld<DK>() + ld<DV>()) * sizeof(__nv_bfloat16);
}
// lse and D of rows i0 .. i0+63 of one head ([B,Hq,S] rows from row0)
// into st[0..63] and st[64..127], 4 bytes a `cp.async`; rows >= S are 0.
__device__ __forceinline__ void stage_stats(float* st, const float* lse,
                                            const float* delta, size_t row0,
                                            int i0, int S) {
  static_assert(NT == 2 * T, "one thread a staged row statistic");
  const int r = threadIdx.x & (T - 1);
  const float* src = threadIdx.x < T ? lse : delta;
  const bool ok = i0 + r < S;
  mma::cp_async4(st + threadIdx.x, ok ? src + row0 + i0 + r : src, ok);
}
}  // namespace bwd_tc

// Block (key tile blockIdx.x / parts, chunk blockIdx.x % parts, KV head,
// sequence): iterations [chunk * c, chunk * (c + 1)) of the key tile's
// walk over (query head of the group, query tile from the diagonal
// down).  parts == 1: dK (scaled) and dV in bf16; else unscaled float32
// partials [2][parts][B,S,Hkv,HD] (dK, then dV) for `bwd_dkdv_combine`.
template <int HD>
__global__ void __launch_bounds__(bwd_tc::NT)
    bwd_dkdv_tc(const __nv_bfloat16* __restrict__ q,
                const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v,
                const __nv_bfloat16* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta,
                __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                float* __restrict__ part, int S, int Hq, int Hkv, int chunk,
                int parts, float scale_log2, float scale) {
  using namespace bwd_tc;
  constexpr int LD = ld<HD>(), KS = HD / 16, NV = HD / 8;
  // query columns a pass: 64 at hd 64, two passes of 32 at hd 128
  constexpr int QW = HD <= 64 ? 64 : 32, NS = QW / 8;
  extern __shared__ float4 bwd_tc_smem[];
  __nv_bfloat16* sk = reinterpret_cast<__nv_bfloat16*>(bwd_tc_smem);
  __nv_bfloat16* sv = sk + T * LD;
  __nv_bfloat16* sq = sv + T * LD;       // [2][T][LD]
  __nv_bfloat16* sdo = sq + 2 * T * LD;  // [2][T][LD]
  float* sst = reinterpret_cast<float*>(sdo + 2 * T * LD);  // [2][lse, D]
  const int n = (S + T - 1) / T, G = Hq / Hkv;
  const int kt = blockIdx.x / parts, c = blockIdx.x - kt * parts;
  const int hk = blockIdx.y, b = blockIdx.z, nq = n - kt;
  const int it0 = c * chunk, it1 = min(G * nq, it0 + chunk);
  if (it0 >= it1) return;  // a chunk past this key tile's walk
  const int j0 = kt * T;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t q_stride = (size_t)Hq * HD, kv_stride = (size_t)Hkv * HD;
  const size_t kv_base = ((size_t)b * S * Hkv + hk) * HD;

  // iteration it: query head hk * G + it / nq, query tile kt + it % nq
  auto stage = [&](int it, int st) {
    const int g = it / nq, i0 = (kt + it - g * nq) * T, h = hk * G + g;
    const size_t q_base = ((size_t)b * S * Hq + h) * HD;
    mma::stage_rows<HD, NT>(sq + st * T * LD, q + q_base, q_stride, i0, S);
    mma::stage_rows<HD, NT>(sdo + st * T * LD, dout + q_base, q_stride, i0,
                            S);
    stage_stats(sst + st * 2 * T, lse, delta, ((size_t)b * Hq + h) * S, i0,
                S);
  };
  mma::stage_rows<HD, NT>(sk, k + kv_base, kv_stride, j0, S);
  mma::stage_rows<HD, NT>(sv, v + kv_base, kv_stride, j0, S);
  stage(it0, 0);
  mma::cp_async_commit();

  float acc_k[NV][4], acc_v[NV][4];
#pragma unroll
  for (int x = 0; x < NV; ++x)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[x][e] = acc_v[x][e] = 0.f;
  const int key0 = j0 + warp * 16 + (lane >> 2);  // keys key0, key0 + 8

  for (int it = it0; it < it1; ++it) {
    mma::cp_async_wait<0>();
    __syncthreads();  // tile `it` staged; the other stage no longer read
    const int st = (it - it0) & 1;
    if (it + 1 < it1) {
      stage(it + 1, st ^ 1);
      mma::cp_async_commit();
    }
    const int qt = kt + it % nq, i0 = qt * T;
    const __nv_bfloat16* tq = sq + st * T * LD;
    const __nv_bfloat16* tdo = sdo + st * T * LD;
    const float* tl = sst + st * 2 * T;
    const float* td = tl + T;
    const bool edge = qt == kt || i0 + T > S;  // diagonal or ragged tile
#pragma unroll
    for (int c0 = 0; c0 < T; c0 += QW) {
      float s[NS][4], dp[NS][4];
#pragma unroll
      for (int x = 0; x < NS; ++x)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[x][e] = dp[x][e] = 0.f;
      // S^T = K Q^T, dP^T = V dO^T: K, V as A; Q, dO as B
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t ka[4], va[4];
        mma::ldsm_x4(ka, mma::a_frag_addr(sk, LD, warp * 16, kk * 16, lane));
        mma::ldsm_x4(va, mma::a_frag_addr(sv, LD, warp * 16, kk * 16, lane));
#pragma unroll
        for (int np = 0; np < NS / 2; ++np) {
          uint32_t bq[4], bo[4];
          mma::ldsm_x4(bq, mma::bk_frag_addr(tq, LD, c0 + np * 16, kk * 16,
                                             lane));
          mma::mma_bf16(s[2 * np], ka, bq[0], bq[1]);
          mma::mma_bf16(s[2 * np + 1], ka, bq[2], bq[3]);
          mma::ldsm_x4(bo, mma::bk_frag_addr(tdo, LD, c0 + np * 16, kk * 16,
                                             lane));
          mma::mma_bf16(dp[2 * np], va, bo[0], bo[1]);
          mma::mma_bf16(dp[2 * np + 1], va, bo[2], bo[3]);
        }
      }
      // P^T into s, dS^T into dp; entry e of 8-query tile x is key
      // key0 + 8 (e / 2), query i0 + c0 + 8x + 2t + e % 2
#pragma unroll
      for (int x = 0; x < NS; ++x) {
        const int col = c0 + x * 8 + 2 * (lane & 3);
        const float2 l2 = *reinterpret_cast<const float2*>(tl + col);
        const float2 d2 = *reinterpret_cast<const float2*>(td + col);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = i0 + col + (e & 1), j = key0 + (e >> 1) * 8;
          float p = exp2f(s[x][e] * scale_log2 -
                          (e & 1 ? l2.y : l2.x) * LOG2E);
          if (edge && (j > i || i >= S)) p = 0.f;
          s[x][e] = p;
          dp[x][e] = p * (dp[x][e] - (e & 1 ? d2.y : d2.x));
        }
      }
      // dV += P^T dO, dK += dS^T Q: dO, Q as B through ldmatrix.trans
#pragma unroll
      for (int kk = 0; kk < QW / 16; ++kk) {
        uint32_t pa[4], da[4];
        mma::probs_to_a<NS>(s, kk, pa);
        mma::probs_to_a<NS>(dp, kk, da);
#pragma unroll
        for (int np = 0; np < NV / 2; ++np) {
          uint32_t bo[4], bq[4];
          mma::ldsm_x4_trans(bo, mma::bv_frag_addr(tdo, LD, c0 + kk * 16,
                                                   np * 16, lane));
          mma::mma_bf16(acc_v[2 * np], pa, bo[0], bo[1]);
          mma::mma_bf16(acc_v[2 * np + 1], pa, bo[2], bo[3]);
          mma::ldsm_x4_trans(bq, mma::bv_frag_addr(tq, LD, c0 + kk * 16,
                                                   np * 16, lane));
          mma::mma_bf16(acc_k[2 * np], da, bq[0], bq[1]);
          mma::mma_bf16(acc_k[2 * np + 1], da, bq[2], bq[3]);
        }
      }
    }
  }

  const size_t per = (size_t)gridDim.z * S * Hkv * HD;  // one partial
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int j = key0 + u * 8;
    if (j >= S) continue;
    const size_t off = kv_base + (size_t)j * kv_stride + 2 * (lane & 3);
    if (parts == 1) {
#pragma unroll
      for (int x = 0; x < NV; ++x) {
        *reinterpret_cast<uint32_t*>(dk + off + x * 8) = mma::pack_bf16(
            acc_k[x][2 * u] * scale, acc_k[x][2 * u + 1] * scale);
        *reinterpret_cast<uint32_t*>(dv + off + x * 8) =
            mma::pack_bf16(acc_v[x][2 * u], acc_v[x][2 * u + 1]);
      }
    } else {
      float* pk = part + (size_t)c * per + off;
      float* pv = part + (size_t)(parts + c) * per + off;
#pragma unroll
      for (int x = 0; x < NV; ++x) {
        *reinterpret_cast<float2*>(pk + x * 8) =
            make_float2(acc_k[x][2 * u], acc_k[x][2 * u + 1]);
        *reinterpret_cast<float2*>(pv + x * 8) =
            make_float2(acc_v[x][2 * u], acc_v[x][2 * u + 1]);
      }
    }
  }
}

// dK (scaled) and dV in bf16 from the chunks' float32 partials, summed in
// chunk order; key j's tile (kv_tile keys) walks G (n - j / kv_tile *
// kv_tile / 64) query tiles of 64, in ceil(that / chunk) chunks.  The
// partials hold `parts` dK tensors [B,S,Hkv,hd], then `parts` dV tensors
// [B,S,Hkv,hdv].  A thread per column c of a token row r: dK's and dV's
// element (r, c), where each has one, summed in one loop.
__global__ void bwd_dkdv_combine(const float* __restrict__ part,
                                 __nv_bfloat16* __restrict__ dk,
                                 __nv_bfloat16* __restrict__ dv, int B, int S,
                                 int Hkv, int hd, int hdv, int G, int chunk,
                                 int parts, int kv_tile, float scale) {
  const int row_k = Hkv * hd, row_v = Hkv * hdv, row = max(row_k, row_v);
  const size_t per_k = (size_t)B * S * row_k, per_v = (size_t)B * S * row_v;
  const float* part_v = part + (size_t)parts * per_k;
  const size_t total = (size_t)B * S * row;
  const int n = (S + bwd_tc::T - 1) / bwd_tc::T;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    const size_t r = i / row;
    const int c = (int)(i - r * row), j = (int)(r % S);
    const int first = j / kv_tile * (kv_tile / bwd_tc::T);
    const int used = (G * (n - first) + chunk - 1) / chunk;
    const size_t ik = r * row_k + c, iv = r * row_v + c;
    float sk = 0.f, sv = 0.f;
    for (int p = 0; p < used; ++p) {
      if (c < row_k) sk += part[p * per_k + ik];
      if (c < row_v) sv += part_v[p * per_v + iv];
    }
    if (c < row_k) dk[ik] = __float2bfloat16(sk * scale);
    if (c < row_v) dv[iv] = __float2bfloat16(sv);
  }
}

// Block (query tile, q head, sequence), query tiles longest first.
template <int DK, int DV>
__global__ void __launch_bounds__(bwd_tc::NT)
    bwd_dq_tc(const __nv_bfloat16* __restrict__ q,
              const __nv_bfloat16* __restrict__ k,
              const __nv_bfloat16* __restrict__ v,
              const __nv_bfloat16* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              __nv_bfloat16* __restrict__ dq, int S, int Hq, int Hkv,
              float scale_log2, float scale) {
  using namespace bwd_tc;
  constexpr int LD = ld<DK>(), LDV = ld<DV>(), KS = DK / 16, KV = DV / 16,
                KM = KS > KV ? KS : KV, NV = DK / 8, NS = T / 8;
  extern __shared__ float4 bwd_tc_smem[];
  __nv_bfloat16* sq = reinterpret_cast<__nv_bfloat16*>(bwd_tc_smem);
  __nv_bfloat16* sdo = sq + T * LD;
  __nv_bfloat16* sk = sdo + T * LDV;    // [2][T][LD]
  __nv_bfloat16* sv = sk + 2 * T * LD;  // [2][T][LDV]
  const int qt = gridDim.x - 1 - blockIdx.x;  // longest tiles first
  const int i0 = qt * T, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t q_stride = (size_t)Hq * DK, o_stride = (size_t)Hq * DV;
  const size_t k_stride = (size_t)Hkv * DK, v_stride = (size_t)Hkv * DV;
  const size_t q_base = ((size_t)b * S * Hq + h) * DK;
  const __nv_bfloat16* kb = k + ((size_t)b * S * Hkv + hk) * DK;
  const __nv_bfloat16* vb = v + ((size_t)b * S * Hkv + hk) * DV;

  mma::stage_rows<DK, NT>(sq, q + q_base, q_stride, i0, S);
  mma::stage_rows<DV, NT>(sdo, dout + ((size_t)b * S * Hq + h) * DV,
                          o_stride, i0, S);
  mma::stage_rows<DK, NT>(sk, kb, k_stride, 0, S);
  mma::stage_rows<DV, NT>(sv, vb, v_stride, 0, S);
  mma::cp_async_commit();

  // rows row0, row0 + 8: -lse log2e and D; rows >= S -inf (P = 0) and 0
  const int row0 = i0 + warp * 16 + (lane >> 2);
  float nl[2], dd[2];
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int row = row0 + u * 8;
    const size_t r = ((size_t)b * Hq + h) * S + row;
    nl[u] = row < S ? -lse[r] * LOG2E : mma::neg_inf();
    dd[u] = row < S ? delta[r] : 0.f;
  }
  float acc[NV][4];
#pragma unroll
  for (int x = 0; x < NV; ++x)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[x][e] = 0.f;

  // key tiles 0 .. qt; the last one holds the diagonal
  for (int t = 0; t <= qt; ++t) {
    mma::cp_async_wait<0>();
    __syncthreads();  // tile t staged; stage (t+1)&1 no longer read
    if (t < qt) {
      const int st = (t + 1) & 1;
      mma::stage_rows<DK, NT>(sk + st * T * LD, kb, k_stride, (t + 1) * T,
                              S);
      mma::stage_rows<DV, NT>(sv + st * T * LDV, vb, v_stride, (t + 1) * T,
                              S);
      mma::cp_async_commit();
    }
    const __nv_bfloat16* tk = sk + (t & 1) * T * LD;
    const __nv_bfloat16* tv = sv + (t & 1) * T * LDV;
    float s[NS][4], dp[NS][4];
#pragma unroll
    for (int x = 0; x < NS; ++x)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[x][e] = dp[x][e] = 0.f;
    // S = Q K^T over DK, dP = dO V^T over DV: Q, dO as A; K, V as B
#pragma unroll
    for (int kk = 0; kk < KM; ++kk) {
      uint32_t qa[4], oa[4];
      if (kk < KS)
        mma::ldsm_x4(qa, mma::a_frag_addr(sq, LD, warp * 16, kk * 16, lane));
      if (kk < KV)
        mma::ldsm_x4(oa, mma::a_frag_addr(sdo, LDV, warp * 16, kk * 16,
                                          lane));
#pragma unroll
      for (int np = 0; np < NS / 2; ++np) {
        uint32_t bk[4], bv[4];
        if (kk < KS) {
          mma::ldsm_x4(bk, mma::bk_frag_addr(tk, LD, np * 16, kk * 16, lane));
          mma::mma_bf16(s[2 * np], qa, bk[0], bk[1]);
          mma::mma_bf16(s[2 * np + 1], qa, bk[2], bk[3]);
        }
        if (kk < KV) {
          mma::ldsm_x4(bv, mma::bk_frag_addr(tv, LDV, np * 16, kk * 16,
                                             lane));
          mma::mma_bf16(dp[2 * np], oa, bv[0], bv[1]);
          mma::mma_bf16(dp[2 * np + 1], oa, bv[2], bv[3]);
        }
      }
    }
    // dS into dp; entry e of 8-key tile x is row row0 + 8 (e / 2), key
    // 64t + 8x + 2t' + e % 2
    const bool diag = t == qt;
#pragma unroll
    for (int x = 0; x < NS; ++x)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = t * T + x * 8 + 2 * (lane & 3) + (e & 1);
        const int u = e >> 1;
        float p = exp2f(s[x][e] * scale_log2 + nl[u]);
        if (diag && key > row0 + u * 8) p = 0.f;
        dp[x][e] = p * (dp[x][e] - dd[u]);
      }
    // dQ += dS K: K as B through ldmatrix.trans
#pragma unroll
    for (int kk = 0; kk < T / 16; ++kk) {
      uint32_t da[4];
      mma::probs_to_a<NS>(dp, kk, da);
#pragma unroll
      for (int np = 0; np < NV / 2; ++np) {
        uint32_t bk[4];
        mma::ldsm_x4_trans(bk, mma::bv_frag_addr(tk, LD, kk * 16, np * 16,
                                                 lane));
        mma::mma_bf16(acc[2 * np], da, bk[0], bk[1]);
        mma::mma_bf16(acc[2 * np + 1], da, bk[2], bk[3]);
      }
    }
  }

#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int row = row0 + u * 8;
    if (row >= S) continue;
    __nv_bfloat16* drow = dq + q_base + (size_t)row * q_stride;
#pragma unroll
    for (int x = 0; x < NV; ++x)
      *reinterpret_cast<uint32_t*>(drow + x * 8 + 2 * (lane & 3)) =
          mma::pack_bf16(acc[x][2 * u] * scale, acc[x][2 * u + 1] * scale);
  }
}

// ---------------------------------------------------------------------------
// warp-specialised bodies (bf16 at (64, 64), (128, 128), (192, 128))
// ---------------------------------------------------------------------------
namespace bwd_wg {
constexpr int QT = 64;      // queries a dK/dV iteration
constexpr int STAGES = 2;   // ring depth (Q, dO, lse, D / K, V)
constexpr float LOG2E = 1.4426950408889634f;

// dK/dV at hd 64 (`bwd_dkdv_wg`): 128 keys a block, 64 a consumer
// warpgroup.  At hd 128 and (192, 128) the pair kernel
// (`bwd_dkdv_pair_wg`) takes 64, both warpgroups on the same keys.
template <int DK, int DV>
constexpr bool pair_kv() { return DK > 64; }
template <int DK, int DV>
constexpr int kv_tile() { return pair_kv<DK, DV>() ? 64 : 128; }

// dK/dV shared memory (bytes from a 1024-byte boundary): K [DK/64][KT][64],
// V [DV/64][KT][64], then a stage each of Q [DK/64][QT][64] and dO
// [DV/64][QT][64], lse log2e and D [STAGES][2][QT] float32, (the pair
// kernel) P^T [2][QT / 8][128] float4, barriers (K/V full; full, empty a
// stage).
template <int DK, int DV>
struct KvSmem {
  static constexpr int KT = kv_tile<DK, DV>();
  static constexpr size_t v = (size_t)KT * DK * 2;
  static constexpr size_t q = v + (size_t)KT * DV * 2;
  static constexpr size_t dout = q + (size_t)STAGES * QT * DK * 2;
  static constexpr size_t stats = dout + (size_t)STAGES * QT * DV * 2;
  static constexpr size_t pt = stats + (size_t)STAGES * 2 * QT * 4;
  static constexpr size_t bars =
      pt + (pair_kv<DK, DV>() ? (size_t)2 * (QT / 8) * 128 * 16 : 0);
  static constexpr size_t bytes = bars + 8 * (1 + 2 * STAGES) + 1024;
};

// dQ: key tile of the walk, 128 at dk 64, 64 at 128 and 32 at 192, so
// that the dQ accumulator [64 x dk], the scores and dP (float32) stay
// within the registers a thread has; shared memory Q [DK/64][128][64],
// dO [DV/64][128][64], then a stage each of K and V, barriers (Q/dO
// full; K full, V full, empty a stage).
template <int DK>
constexpr int dq_key_tile() { return DK <= 64 ? 128 : DK <= 128 ? 64 : 32; }
constexpr int DQ_QT = 128;
template <int DK, int DV>
struct DqSmem {
  static constexpr int KT = dq_key_tile<DK>();
  static constexpr size_t dout = (size_t)DQ_QT * DK * 2;
  static constexpr size_t k = dout + (size_t)DQ_QT * DV * 2;
  static constexpr size_t v = k + (size_t)STAGES * KT * DK * 2;
  static constexpr size_t bars = v + (size_t)STAGES * KT * DV * 2;
  static constexpr size_t bytes = bars + 8 * (1 + 3 * STAGES) + 1024;
};

// The producer warp's side of one dK/dV iteration: wait for the stage to
// be free, write lse log2e and D of query rows i0 .. i0 + QT - 1 of head h
// (0 past S) into it, and (lane 0) load Q and dO by TMA.  `full` counts
// the warp's 32 arrivals and the TMA bytes.
template <int DK, int DV>
__device__ __forceinline__ void produce_q_tile(
    int i, int h, int i0, int b, int S, int Hq, const float* lse,
    const float* delta, const CUtensorMap* tq, const CUtensorMap* tdo,
    __nv_bfloat16* sq, __nv_bfloat16* sdo, float* sst, uint64_t* full,
    uint64_t* empty, int lane) {
  const int s = i % STAGES;
  if (i >= STAGES) hop::mbar_wait(empty + s, (i / STAGES - 1) & 1);
  float* st = sst + s * 2 * QT;
  const size_t row = ((size_t)b * Hq + h) * S;
  for (int r = lane; r < QT; r += 32) {
    const bool ok = i0 + r < S;
    st[r] = ok ? lse[row + i0 + r] * LOG2E : 0.f;
    st[QT + r] = ok ? delta[row + i0 + r] : 0.f;
  }
  if (lane == 0) {
    hop::mbar_expect_tx(full + s, hop::tile_bytes<DK, QT>() +
                                      hop::tile_bytes<DV, QT>());
    hop::tma_tile<DK, QT>(sq + s * QT * DK, tq, full + s, h, i0, b);
    hop::tma_tile<DV, QT>(sdo + s * QT * DV, tdo, full + s, h, i0, b);
  } else {
    hop::mbar_arrive(full + s);
  }
}

// dK (scaled) and dV in bf16, or unscaled float32 partials [2][parts]
// [B,S,Hkv,W] (dK's, then dV's), of one consumer warpgroup's 64 keys
// from key_lo: thread (warp, lane) holds keys key_lo + 16 warp + lane / 4
// (+ 8).
template <int W>
__device__ __forceinline__ void store_kv_grad(
    const float (&acc)[W / 2], __nv_bfloat16* out, float* part, int key_lo,
    int warp, int lane, int b, int B, int S, int Hkv, int hk, int c,
    int parts, float scale) {
  const size_t per = (size_t)B * S * Hkv * W;  // one partial
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int j = key_lo + 16 * warp + (lane >> 2) + 8 * u;
    if (j >= S) continue;
    const size_t off =
        (((size_t)b * S + j) * Hkv + hk) * W + 2 * (lane & 3);
#pragma unroll
    for (int x = 0; x < W / 8; ++x) {
      if (parts == 1)
        *reinterpret_cast<uint32_t*>(out + off + x * 8) = hop::pack_bf16(
            acc[4 * x + 2 * u] * scale, acc[4 * x + 2 * u + 1] * scale);
      else
        *reinterpret_cast<float2*>(part + (size_t)c * per + off + x * 8) =
            make_float2(acc[4 * x + 2 * u], acc[4 * x + 2 * u + 1]);
    }
  }
}
}  // namespace bwd_wg

// dK/dV at hd 64.  Block (key tile blockIdx.x / parts, chunk
// blockIdx.x % parts, KV head, sequence), 384 threads: warp 0 of warpgroup
// 0 produces (K and V once, then Q, dO, lse and D of each iteration of
// the chunk through the ring); warpgroups 1 and 2 consume, each owning 64
// of the 128 keys with dK and dV [64 x HD] float32 in registers.  The
// walk, chunks and partials are `bwd_dkdv_tc`'s with 128-key tiles: key
// tile kt walks the query tiles 2 kt .. n - 1 of each head of the group.
template <int HD>
__global__ void __launch_bounds__(hop::WG_THREADS, 1)
    bwd_dkdv_wg(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv,
                const __grid_constant__ CUtensorMap tdo,
                const float* __restrict__ lse,
                const float* __restrict__ delta,
                __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                float* __restrict__ part, int S, int Hq, int Hkv, int chunk,
                int parts, float scale_log2, float scale, int lpt) {
  using namespace bwd_wg;
  using L = KvSmem<HD, HD>;
  using bf16 = __nv_bfloat16;
  constexpr int KT = L::KT;
  extern __shared__ unsigned char bwd_wg_smem[];
  unsigned char* base = hop::align1024(bwd_wg_smem);
  bf16* sk = reinterpret_cast<bf16*>(base);
  bf16* sv = reinterpret_cast<bf16*>(base + L::v);
  bf16* sq = reinterpret_cast<bf16*>(base + L::q);
  bf16* sdo = reinterpret_cast<bf16*>(base + L::dout);
  float* sst = reinterpret_cast<float*>(base + L::stats);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(base + L::bars);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + STAGES;
  const int n = (S + QT - 1) / QT, G = Hq / Hkv;
  const hop::BlockIdx at = hop::block_idx(lpt);  // tile: key tile, chunk
  const int kt = at.tile / parts, c = at.tile - kt * parts;
  const int hk = at.head, b = at.b, B = at.B;
  const int qt0 = kt * (KT / QT), nq = n - qt0;
  const int it0 = c * chunk, it1 = min(G * nq, it0 + chunk);
  if (it0 >= it1) return;  // a chunk past this key tile's walk
  const int j0 = kt * KT;
  if (threadIdx.x == 0) {
    hop::mbar_init(kv_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      hop::mbar_init(full + s, 32);  // the producer warp's lanes
      hop::mbar_init(empty + s, 8);  // lane 0 of each consumer warp
    }
    hop::fence_barrier_init();
  }
  __syncthreads();
  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    hop::producer_regs();
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      if (lane == 0) {
        hop::mbar_expect_tx(kv_full, 2 * hop::tile_bytes<HD, KT>());
        hop::tma_tile<HD, KT>(sk, &tk, kv_full, hk, j0, b);
        hop::tma_tile<HD, KT>(sv, &tv, kv_full, hk, j0, b);
      }
      for (int it = it0; it < it1; ++it) {
        const int g = it / nq;
        produce_q_tile<HD, HD>(it - it0, hk * G + g,
                               (qt0 + it - g * nq) * QT, b, S, Hq, lse,
                               delta, &tq, &tdo, sq, sdo, sst, full, empty,
                               lane);
      }
    }
    return;
  }
  hop::consumer_regs();
  const int cw = wg - 1, tid = threadIdx.x - 128 * wg;
  const int warp = tid >> 5, lane = tid & 31;
  const int key_lo = j0 + 64 * cw;  // this warpgroup's 64 keys
  const int key0 = key_lo + 16 * warp + (lane >> 2);  // and key0 + 8
  float acc_k[HD / 2], acc_v[HD / 2];
#pragma unroll
  for (int x = 0; x < HD / 2; ++x) acc_k[x] = acc_v[x] = 0.f;
  hop::mbar_wait(kv_full, 0);

  for (int it = it0; it < it1; ++it) {
    const int i = it - it0, s = i % STAGES;
    const int i0 = (qt0 + it % nq) * QT;
    const bf16* tq_s = sq + s * QT * HD;
    const bf16* tdo_s = sdo + s * QT * HD;
    const float* tl = sst + s * 2 * QT;
    hop::mbar_wait(full + s, (i / STAGES) & 1);
    if (i0 + QT - 1 >= key_lo) {  // else every (key, query) pair masked
      float st[QT / 2], dpt[QT / 2];
      // S^T = K Q^T, dP^T = V dO^T: K, V as A; Q, dO as B (K-major)
      hop::wg_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        hop::mma_ss<QT>(st, hop::desc_k<KT>(sk, 64 * cw, kk),
                        hop::desc_k<QT>(tq_s, 0, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        hop::mma_ss<QT>(dpt, hop::desc_k<KT>(sv, 64 * cw, kk),
                        hop::desc_k<QT>(tdo_s, 0, kk), kk > 0);
      hop::wg_commit();
      hop::wg_wait<0>();
      hop::fence_regs(st);
      hop::fence_regs(dpt);
      // P^T into st, dS^T into dpt; entry 4x + e: key key0 + 8 (e / 2),
      // query i0 + 8x + 2 (lane % 4) + e % 2
      const bool edge = i0 < key_lo + 63 || i0 + QT > S;
#pragma unroll
      for (int x = 0; x < QT / 8; ++x) {
        const int col = 8 * x + 2 * (lane & 3);
        const float2 l2 = *reinterpret_cast<const float2*>(tl + col);
        const float2 d2 = *reinterpret_cast<const float2*>(tl + QT + col);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = i0 + col + (e & 1), j = key0 + 8 * (e >> 1);
          float p = hop::ex2(fmaf(st[4 * x + e], scale_log2,
                                     -(e & 1 ? l2.y : l2.x)));
          if (edge && (j > qi || qi >= S)) p = 0.f;
          st[4 * x + e] = p;
          dpt[4 * x + e] = p * (dpt[4 * x + e] - (e & 1 ? d2.y : d2.x));
        }
      }
      uint32_t pa[QT / 16][4], da[QT / 16][4];
      hop::acc_to_a<QT>(st, pa);
      hop::acc_to_a<QT>(dpt, da);
      // dV += P^T dO, dK += dS^T Q: dO, Q as B (MN-major)
      hop::fence_regs(acc_v);
      hop::fence_regs(acc_k);
      hop::fence_regs(pa);
      hop::fence_regs(da);
      hop::wg_fence();
#pragma unroll
      for (int kk = 0; kk < QT / 16; ++kk)
        hop::mma_rs<HD>(acc_v, pa[kk], hop::desc_mn<QT>(tdo_s, kk));
#pragma unroll
      for (int kk = 0; kk < QT / 16; ++kk)
        hop::mma_rs<HD>(acc_k, da[kk], hop::desc_mn<QT>(tq_s, kk));
      hop::wg_commit();
      hop::wg_wait<0>();
      hop::fence_regs(acc_v);
      hop::fence_regs(acc_k);
    }
    if (lane == 0) hop::mbar_arrive(empty + s);
  }
  store_kv_grad<HD>(acc_k, dk, part, key_lo, warp, lane, b, B, S, Hkv, hk, c,
                    parts, scale);
  store_kv_grad<HD>(acc_v, dv, part + (size_t)parts * B * S * Hkv * HD,
                    key_lo, warp, lane, b, B, S, Hkv, hk, c, parts, 1.f);
}

// dK/dV at hd 128 and MLA's (192, 128), the two consumers splitting dK
// and dV over the same 64 keys (see the note at the top): warpgroup 1
// forms S^T = K Q^T and P^T, hands P^T to warpgroup 2 through shared
// memory under named barriers and accumulates dV += P^T dO; warpgroup 2
// forms dP^T = V dO^T, reads P^T, forms dS^T and accumulates dK += dS^T
// Q.  Block, walk, ring and split as `bwd_dkdv_wg` with 64-key tiles.
template <int DK, int DV>
__global__ void __launch_bounds__(hop::WG_THREADS, 1)
    bwd_dkdv_pair_wg(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     const __grid_constant__ CUtensorMap tdo,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     __nv_bfloat16* __restrict__ dk,
                     __nv_bfloat16* __restrict__ dv, float* __restrict__ part,
                     int S, int Hq, int Hkv, int chunk, int parts,
                     float scale_log2, float scale, int lpt) {
  using namespace bwd_wg;
  using L = KvSmem<DK, DV>;
  using bf16 = __nv_bfloat16;
  constexpr int KT = L::KT;
  static_assert(KT == QT, "query tile kt is the diagonal of key tile kt");
  extern __shared__ unsigned char bwd_wg_smem[];
  unsigned char* base = hop::align1024(bwd_wg_smem);
  bf16* sk = reinterpret_cast<bf16*>(base);
  bf16* sv = reinterpret_cast<bf16*>(base + L::v);
  bf16* sq = reinterpret_cast<bf16*>(base + L::q);
  bf16* sdo = reinterpret_cast<bf16*>(base + L::dout);
  float* sst = reinterpret_cast<float*>(base + L::stats);
  float4* spt = reinterpret_cast<float4*>(base + L::pt);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(base + L::bars);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + STAGES;
  const int n = (S + QT - 1) / QT, G = Hq / Hkv;
  const hop::BlockIdx at = hop::block_idx(lpt);  // tile: key tile, chunk
  const int kt = at.tile / parts, c = at.tile - kt * parts;
  const int hk = at.head, b = at.b, B = at.B, nq = n - kt;
  const int it0 = c * chunk, it1 = min(G * nq, it0 + chunk);
  if (it0 >= it1) return;
  const int j0 = kt * KT;
  if (threadIdx.x == 0) {
    hop::mbar_init(kv_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      hop::mbar_init(full + s, 32);
      hop::mbar_init(empty + s, 8);
    }
    hop::fence_barrier_init();
  }
  __syncthreads();
  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    hop::producer_regs();
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      if (lane == 0) {
        hop::mbar_expect_tx(kv_full, hop::tile_bytes<DK, KT>() +
                                         hop::tile_bytes<DV, KT>());
        hop::tma_tile<DK, KT>(sk, &tk, kv_full, hk, j0, b);
        hop::tma_tile<DV, KT>(sv, &tv, kv_full, hk, j0, b);
      }
      for (int it = it0; it < it1; ++it) {
        const int g = it / nq;
        produce_q_tile<DK, DV>(it - it0, hk * G + g, (kt + it - g * nq) * QT,
                               b, S, Hq, lse, delta, &tq, &tdo, sq, sdo, sst,
                               full, empty, lane);
      }
    }
    return;
  }
  hop::consumer_regs();
  const int cw = wg - 1, tid = threadIdx.x - 128 * wg;
  const int warp = tid >> 5, lane = tid & 31;
  const int key0 = j0 + 16 * warp + (lane >> 2);  // and key0 + 8
  constexpr int P_FULL = 1, P_EMPTY = 3;  // named barriers, + buffer
  const int n_it = it1 - it0;
  hop::mbar_wait(kv_full, 0);

  if (cw == 0) {  // P^T and dV
    float acc_v[DV / 2];
#pragma unroll
    for (int x = 0; x < DV / 2; ++x) acc_v[x] = 0.f;
    for (int it = it0; it < it1; ++it) {
      const int i = it - it0, s = i % STAGES, buf = i & 1;
      const int i0 = (kt + it % nq) * QT;
      const bf16* tq_s = sq + s * QT * DK;
      const bf16* tdo_s = sdo + s * QT * DV;
      const float* tl = sst + s * 2 * QT;
      hop::mbar_wait(full + s, (i / STAGES) & 1);
      float st[QT / 2];
      hop::wg_fence();
#pragma unroll
      for (int kk = 0; kk < DK / 16; ++kk)
        hop::mma_ss<QT>(st, hop::desc_k<KT>(sk, 0, kk),
                        hop::desc_k<QT>(tq_s, 0, kk), kk > 0);
      hop::wg_commit();
      hop::wg_wait<0>();
      hop::fence_regs(st);
      const bool edge = i0 < j0 + KT - 1 || i0 + QT > S;
#pragma unroll
      for (int x = 0; x < QT / 8; ++x) {
        const int col = 8 * x + 2 * (lane & 3);
        const float2 l2 = *reinterpret_cast<const float2*>(tl + col);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = i0 + col + (e & 1), j = key0 + 8 * (e >> 1);
          float p = hop::ex2(fmaf(st[4 * x + e], scale_log2,
                                     -(e & 1 ? l2.y : l2.x)));
          if (edge && (j > qi || qi >= S)) p = 0.f;
          st[4 * x + e] = p;
        }
      }
      if (i >= 2) hop::named_sync(P_EMPTY + buf, 256);
      float4* pb = spt + buf * (QT / 8) * 128;
#pragma unroll
      for (int x = 0; x < QT / 8; ++x)
        pb[x * 128 + tid] = make_float4(st[4 * x], st[4 * x + 1],
                                        st[4 * x + 2], st[4 * x + 3]);
      hop::named_arrive(P_FULL + buf, 256);
      uint32_t pa[QT / 16][4];
      hop::acc_to_a<QT>(st, pa);
      hop::fence_regs(acc_v);
      hop::fence_regs(pa);
      hop::wg_fence();
#pragma unroll
      for (int kk = 0; kk < QT / 16; ++kk)
        hop::mma_rs<DV>(acc_v, pa[kk], hop::desc_mn<QT>(tdo_s, kk));
      hop::wg_commit();
      hop::wg_wait<0>();
      hop::fence_regs(acc_v);
      if (lane == 0) hop::mbar_arrive(empty + s);
    }
    store_kv_grad<DV>(acc_v, dv, part + (size_t)parts * B * S * Hkv * DK, j0,
                      warp, lane, b, B, S, Hkv, hk, c, parts, 1.f);
  } else {  // dS^T and dK
    float acc_k[DK / 2];
#pragma unroll
    for (int x = 0; x < DK / 2; ++x) acc_k[x] = 0.f;
    for (int it = it0; it < it1; ++it) {
      const int i = it - it0, s = i % STAGES, buf = i & 1;
      const bf16* tq_s = sq + s * QT * DK;
      const bf16* tdo_s = sdo + s * QT * DV;
      const float* tl = sst + s * 2 * QT;
      hop::mbar_wait(full + s, (i / STAGES) & 1);
      float dpt[QT / 2];
      hop::wg_fence();
#pragma unroll
      for (int kk = 0; kk < DV / 16; ++kk)
        hop::mma_ss<QT>(dpt, hop::desc_k<KT>(sv, 0, kk),
                        hop::desc_k<QT>(tdo_s, 0, kk), kk > 0);
      hop::wg_commit();
      hop::wg_wait<0>();
      hop::fence_regs(dpt);
      hop::named_sync(P_FULL + buf, 256);
      const float4* pb = spt + buf * (QT / 8) * 128;
#pragma unroll
      for (int x = 0; x < QT / 8; ++x) {
        const float4 p = pb[x * 128 + tid];
        const float2 d2 =
            *reinterpret_cast<const float2*>(tl + QT + 8 * x + 2 * (lane & 3));
        dpt[4 * x] = p.x * (dpt[4 * x] - d2.x);
        dpt[4 * x + 1] = p.y * (dpt[4 * x + 1] - d2.y);
        dpt[4 * x + 2] = p.z * (dpt[4 * x + 2] - d2.x);
        dpt[4 * x + 3] = p.w * (dpt[4 * x + 3] - d2.y);
      }
      if (i + 2 < n_it) hop::named_arrive(P_EMPTY + buf, 256);
      uint32_t da[QT / 16][4];
      hop::acc_to_a<QT>(dpt, da);
      hop::fence_regs(acc_k);
      hop::fence_regs(da);
      hop::wg_fence();
#pragma unroll
      for (int kk = 0; kk < QT / 16; ++kk)
        hop::mma_rs<DK>(acc_k, da[kk], hop::desc_mn<QT>(tq_s, kk));
      hop::wg_commit();
      hop::wg_wait<0>();
      hop::fence_regs(acc_k);
      if (lane == 0) hop::mbar_arrive(empty + s);
    }
    store_kv_grad<DK>(acc_k, dk, part, j0, warp, lane, b, B, S, Hkv, hk, c,
                      parts, scale);
  }
}

// dQ.  Block (128-query tile, longest first; q head; sequence), 384
// threads: thread 0 loads Q and dO once and K and V tiles 0 .. diagonal
// through the ring; warpgroups 1 and 2 own query rows 0-63 and 64-127,
// recompute S = Q K^T and dP = dO V^T, form dS and accumulate dQ += dS K
// [64 x DK] float32 in registers (K as B, MN-major).  A key tile wholly
// above a warpgroup's rows is skipped.
template <int DK, int DV>
__global__ void __launch_bounds__(hop::WG_THREADS, 1)
    bwd_dq_wg(const __grid_constant__ CUtensorMap tq,
              const __grid_constant__ CUtensorMap tk,
              const __grid_constant__ CUtensorMap tv,
              const __grid_constant__ CUtensorMap tdo,
              const float* __restrict__ lse, const float* __restrict__ delta,
              __nv_bfloat16* __restrict__ dq, int S, int Hq, int Hkv,
              float scale_log2, float scale) {
  using namespace bwd_wg;
  using L = DqSmem<DK, DV>;
  using bf16 = __nv_bfloat16;
  constexpr int KT = L::KT;
  extern __shared__ unsigned char bwd_wg_smem[];
  unsigned char* base = hop::align1024(bwd_wg_smem);
  bf16* sq = reinterpret_cast<bf16*>(base);
  bf16* sdo = reinterpret_cast<bf16*>(base + L::dout);
  bf16* sk = reinterpret_cast<bf16*>(base + L::k);
  bf16* sv = reinterpret_cast<bf16*>(base + L::v);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(base + L::bars);
  uint64_t* full_k = q_full + 1;
  uint64_t* full_v = full_k + STAGES;
  uint64_t* empty = full_v + STAGES;
  const int tile = gridDim.x - 1 - blockIdx.x;  // longest tiles first
  const int q0 = tile * DQ_QT, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int n_kt = (min(q0 + DQ_QT, S) - 1) / KT + 1;  // 0 .. diagonal
  if (threadIdx.x == 0) {
    hop::mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      hop::mbar_init(full_k + s, 1);
      hop::mbar_init(full_v + s, 1);
      hop::mbar_init(empty + s, 8);
    }
    hop::fence_barrier_init();
  }
  __syncthreads();
  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    hop::producer_regs();
    if (threadIdx.x == 0) {
      hop::mbar_expect_tx(q_full, hop::tile_bytes<DK, DQ_QT>() +
                                      hop::tile_bytes<DV, DQ_QT>());
      hop::tma_tile<DK, DQ_QT>(sq, &tq, q_full, h, q0, b);
      hop::tma_tile<DV, DQ_QT>(sdo, &tdo, q_full, h, q0, b);
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
  hop::consumer_regs();
  const int cw = wg - 1, tid = threadIdx.x - 128 * wg;
  const int warp = tid >> 5, lane = tid & 31;
  const int r_lo = q0 + 64 * cw;                    // this warpgroup's rows
  const int row0 = r_lo + 16 * warp + (lane >> 2);  // and row0 + 8
  // -lse log2e and D of rows row0, row0 + 8; rows >= S: -inf (P = 0), 0
  float nl[2], dd[2];
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int row = row0 + 8 * u;
    const size_t r = ((size_t)b * Hq + h) * S + row;
    nl[u] = row < S ? -lse[r] * LOG2E : mma::neg_inf();
    dd[u] = row < S ? delta[r] : 0.f;
  }
  float acc[DK / 2];
#pragma unroll
  for (int x = 0; x < DK / 2; ++x) acc[x] = 0.f;
  hop::mbar_wait(q_full, 0);

  for (int t = 0; t < n_kt; ++t) {
    const int s = t % STAGES;
    const uint32_t ph = (t / STAGES) & 1;
    const bf16* tk_s = sk + s * KT * DK;
    const bf16* tv_s = sv + s * KT * DV;
    hop::mbar_wait(full_k + s, ph);
    hop::mbar_wait(full_v + s, ph);
    if (t * KT <= r_lo + 63) {  // else above every row of this warpgroup
      float sc[KT / 2], dp[KT / 2];
      // S = Q K^T over DK, dP = dO V^T over DV: Q, dO as A; K, V as B
      hop::wg_fence();
#pragma unroll
      for (int kk = 0; kk < DK / 16; ++kk)
        hop::mma_ss<KT>(sc, hop::desc_k<DQ_QT>(sq, 64 * cw, kk),
                        hop::desc_k<KT>(tk_s, 0, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < DV / 16; ++kk)
        hop::mma_ss<KT>(dp, hop::desc_k<DQ_QT>(sdo, 64 * cw, kk),
                        hop::desc_k<KT>(tv_s, 0, kk), kk > 0);
      hop::wg_commit();
      hop::wg_wait<0>();
      hop::fence_regs(sc);
      hop::fence_regs(dp);
      // dS into dp; entry 4x + e: row row0 + 8 (e / 2), key KT t + 8x +
      // 2 (lane % 4) + e % 2
      const bool diag = t * KT + KT - 1 > r_lo;
#pragma unroll
      for (int x = 0; x < KT / 8; ++x)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = t * KT + 8 * x + 2 * (lane & 3) + (e & 1);
          const int u = e >> 1;
          float p = hop::ex2(fmaf(sc[4 * x + e], scale_log2, nl[u]));
          if (diag && key > row0 + 8 * u) p = 0.f;
          dp[4 * x + e] = p * (dp[4 * x + e] - dd[u]);
        }
      uint32_t da[KT / 16][4];
      hop::acc_to_a<KT>(dp, da);
      hop::fence_regs(acc);
      hop::fence_regs(da);
      hop::wg_fence();
#pragma unroll
      for (int kk = 0; kk < KT / 16; ++kk)
        hop::mma_rs<DK>(acc, da[kk], hop::desc_mn<KT>(tk_s, kk));
      hop::wg_commit();
      hop::wg_wait<0>();
      hop::fence_regs(acc);
    }
    if (lane == 0) hop::mbar_arrive(empty + s);
  }

#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int row = row0 + 8 * u;
    if (row >= S) continue;
    bf16* drow = dq + (((size_t)b * S + row) * Hq + h) * DK;
#pragma unroll
    for (int x = 0; x < DK / 8; ++x)
      *reinterpret_cast<uint32_t*>(drow + x * 8 + 2 * (lane & 3)) =
          hop::pack_bf16(acc[4 * x + 2 * u] * scale,
                         acc[4 * x + 2 * u + 1] * scale);
  }
}

// ---------------------------------------------------------------------------
// launches and the C entries
// ---------------------------------------------------------------------------
template <typename T>
static cudaError_t launch_delta(const void* o, const void* dout, void* delta,
                                int B, int S, int Hq, int hdv,
                                cudaStream_t st) {
  const size_t threads = (size_t)B * S * Hq * (hdv * sizeof(T) / 16);
  bwd_delta<T><<<(unsigned)((threads + 255) / 256), 256, 0, st>>>(
      (const T*)o, (const T*)dout, (float*)delta, B, S, Hq, hdv);
  return cudaGetLastError();
}

// The dK/dV partials' combine (when the walk is split), launched after the
// dK/dV kernel: kv_tile keys a dK/dV block.
static cudaError_t launch_combine(void* part, void* dk, void* dv, int B,
                                  int S, int Hkv, int hd, int hdv, int G,
                                  int chunk, int parts, int kv_tile,
                                  float scale, cudaStream_t st) {
  const size_t per = (size_t)B * S * Hkv * (hd > hdv ? hd : hdv);
  const size_t need = (per + 255) / 256;
  const unsigned blocks = (unsigned)(need < 4096 ? need : 4096);
  bwd_dkdv_combine<<<blocks, 256, 0, st>>>(
      (const float*)part, (__nv_bfloat16*)dk, (__nv_bfloat16*)dv, B, S, Hkv,
      hd, hdv, G, chunk, parts, kv_tile, scale);
  return cudaGetLastError();
}

// The mma.sync body (hd 16).
template <int HD>
static int launch_tc(const void* q, const void* k, const void* v,
                     const void* o, const void* dout, const void* lse,
                     void* delta, void* dq, void* dk, void* dv, void* part,
                     int B, int S, int Hq, int Hkv, float scale, int chunk,
                     cudaStream_t st) {
  using namespace bwd_tc;
  using bf16 = __nv_bfloat16;
  const int n = (S + T - 1) / T, G = Hq / Hkv;
  if (chunk < 1) return (int)cudaErrorInvalidValue;
  const int parts = (G * n + chunk - 1) / chunk;
  if (parts > 1 && part == nullptr) return (int)cudaErrorInvalidValue;
  const float scale_log2 = scale * LOG2E;
  cudaError_t err = launch_delta<bf16>(o, dout, delta, B, S, Hq, HD, st);
  if (err != cudaSuccess) return (int)err;

  const size_t smem = smem_bytes<HD>();
  auto kv_kernel = bwd_dkdv_tc<HD>;
  err = allow_smem(kv_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kv_kernel<<<dim3(n * parts, Hkv, B), NT, smem, st>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout,
      (const float*)lse, (const float*)delta, (bf16*)dk, (bf16*)dv,
      (float*)part, S, Hq, Hkv, chunk, parts, scale_log2, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (parts > 1) {
    err = launch_combine(part, dk, dv, B, S, Hkv, HD, HD, G, chunk, parts, T,
                         scale, st);
    if (err != cudaSuccess) return (int)err;
  }

  const size_t dq_smem = dq_smem_bytes<HD, HD>();
  auto q_kernel = bwd_dq_tc<HD, HD>;
  err = allow_smem(q_kernel, dq_smem);
  if (err != cudaSuccess) return (int)err;
  q_kernel<<<dim3(n, Hq, B), NT, dq_smem, st>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout,
      (const float*)lse, (const float*)delta, (bf16*)dq, S, Hq, Hkv,
      scale_log2, scale);
  return (int)cudaGetLastError();
}

// The warp-specialised body: D, dK/dV (`bwd_dkdv_wg`, or at dk > dv
// `bwd_dkdv_pair_wg`), the combine when split, dQ (`bwd_dq_wg`).
template <int DK, int DV>
static int launch_wg(const void* q, const void* k, const void* v,
                     const void* o, const void* dout, const void* lse,
                     void* delta, void* dq, void* dk, void* dv, void* part,
                     int B, int S, int Hq, int Hkv, float scale, int chunk,
                     cudaStream_t st) {
  using namespace bwd_wg;
  using bf16 = __nv_bfloat16;
  constexpr int KT = kv_tile<DK, DV>(), DKT = dq_key_tile<DK>();
  const int n = (S + QT - 1) / QT, G = Hq / Hkv;
  if (chunk < 1) return (int)cudaErrorInvalidValue;
  const int parts = (G * n + chunk - 1) / chunk;
  if (parts > 1 && part == nullptr) return (int)cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv, tdo;
  int rc = make_map(&tq, q, B, S, Hq, DK, QT);
  if (rc == 0) rc = make_map(&tdo, dout, B, S, Hq, DV, QT);
  if (rc == 0) rc = make_map(&tk, k, B, S, Hkv, DK, KT);
  if (rc == 0) rc = make_map(&tv, v, B, S, Hkv, DV, KT);
  if (rc != 0) return rc;
  const float scale_log2 = scale * LOG2E;
  cudaError_t err = launch_delta<bf16>(o, dout, delta, B, S, Hq, DV, st);
  if (err != cudaSuccess) return (int)err;

  const size_t smem = KvSmem<DK, DV>::bytes;
  auto launch_kv = [&](auto kernel) {
    cudaError_t e = allow_smem(kernel, smem);
    if (e != cudaSuccess) return e;
    // longest walks (key tile 0) first where Q and dO fit in 40 MB of L2
    // (on an H100 at 4 x 1024, 32 / 8, hd 64: 33.5 MB, dK/dV 25 % faster
    // than head-major)
    const int blocks = (S + KT - 1) / KT * parts;
    const int lpt = hop::longest_first((size_t)blocks * Hkv * B,
                                       (size_t)B * S * Hq * (DK + DV) * 2,
                                       (size_t)40 << 20);
    kernel<<<hop::grid_of(lpt, blocks, Hkv, B), hop::WG_THREADS, smem,
             st>>>(
        tq, tk, tv, tdo, (const float*)lse, (const float*)delta, (bf16*)dk,
        (bf16*)dv, (float*)part, S, Hq, Hkv, chunk, parts, scale_log2, scale,
        lpt);
    return cudaGetLastError();
  };
  if constexpr (pair_kv<DK, DV>())
    err = launch_kv(bwd_dkdv_pair_wg<DK, DV>);
  else
    err = launch_kv(bwd_dkdv_wg<DK>);
  if (err != cudaSuccess) return (int)err;
  if (parts > 1) {
    err = launch_combine(part, dk, dv, B, S, Hkv, DK, DV, G, chunk, parts,
                         KT, scale, st);
    if (err != cudaSuccess) return (int)err;
  }

  // dQ's maps: K and V in its own key tiles, Q and dO in 128-row tiles
  rc = make_map(&tq, q, B, S, Hq, DK, DQ_QT);
  if (rc == 0) rc = make_map(&tdo, dout, B, S, Hq, DV, DQ_QT);
  if (rc == 0) rc = make_map(&tk, k, B, S, Hkv, DK, DKT);
  if (rc == 0) rc = make_map(&tv, v, B, S, Hkv, DV, DKT);
  if (rc != 0) return rc;
  const size_t dq_smem = DqSmem<DK, DV>::bytes;
  auto q_kernel = bwd_dq_wg<DK, DV>;
  err = allow_smem(q_kernel, dq_smem);
  if (err != cudaSuccess) return (int)err;
  q_kernel<<<dim3((S + DQ_QT - 1) / DQ_QT, Hq, B), hop::WG_THREADS, dq_smem,
             st>>>(tq, tk, tv, tdo, (const float*)lse, (const float*)delta,
                   (bf16*)dq, S, Hq, Hkv, scale_log2, scale);
  return (int)cudaGetLastError();
}

template <int DK, int DV>
static int launch_f32(const void* q, const void* k, const void* v,
                      const void* o, const void* dout, const void* lse,
                      void* delta, void* dq, void* dk, void* dv, int B, int S,
                      int Hq, int Hkv, float scale, cudaStream_t st) {
  using namespace flash_bwd;
  cudaError_t err = launch_delta<float>(o, dout, delta, B, S, Hq, DV, st);
  if (err != cudaSuccess) return (int)err;

  const size_t smem = smem_bytes<DK, DV>();
  const int tiles = (S + T64 - 1) / T64;
  auto kv_kernel = bwd_dkdv<float, DK, DV>;
  err = allow_smem(kv_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kv_kernel<<<dim3(tiles, Hkv, B), NT, smem, st>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)dout,
      (const float*)lse, (const float*)delta, (float*)dk, (float*)dv, S, Hq,
      Hkv, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  auto q_kernel = bwd_dq<float, DK, DV>;
  err = allow_smem(q_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  q_kernel<<<dim3(tiles, Hq, B), NT, smem, st>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)dout,
      (const float*)lse, (const float*)delta, (float*)dq, S, Hq, Hkv, scale);
  return (int)cudaGetLastError();
}

// The width pairs the backward takes: (16, 16), (64, 64), (128, 128),
// (192, 128).
static bool widths_ok(int hd, int hdv) {
  return (hd == hdv && (hd == 16 || hd == 64 || hd == 128)) ||
         (hd == 192 && hdv == 128);
}

// The body `flash_prefill_bwd` runs: 2, the warp-specialised `wgmma` body
// (bf16 at (64, 64), (128, 128), (192, 128)); 1, the `mma.sync` body (bf16
// at hd 16); 0, the CUDA-core body (float32).
static int body(int hd, int hdv, int dtype) {
  if (dtype != 1 || !widths_ok(hd, hdv)) return 0;
  return hd == 16 ? 1 : 2;
}

// dtype codes: 0 = float32, 1 = bfloat16; (hd, hdv), the widths of q / k
// and of v / o / dO, one of `widths_ok`'s pairs (anything else returns
// cudaErrorInvalidValue, and the wrapper refuses it first).  `delta` is
// float32 scratch [B,Hq,S] the caller allocates.  `kv_chunk`: query-tile
// iterations a dK/dV block of the tensor-core body walks; when it is less
// than G * ceil(S / 64), `partials` is float32 scratch of
// ceil(G * ceil(S / 64) / kv_chunk) * B * S * Hkv * (hd + hdv) elements
// (the float32 body reads neither).
extern "C" int flash_prefill_bwd(const void* q, const void* k, const void* v,
                                 const void* o, const void* dout,
                                 const void* lse, void* delta, void* dq,
                                 void* dk, void* dv, void* partials, int B,
                                 int S, int Hq, int Hkv, int hd, int hdv,
                                 float scale, int kv_chunk, int dtype,
                                 void* stream) {
  if (!widths_ok(hd, hdv)) return (int)cudaErrorInvalidValue;
  if (B == 0 || S == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  switch (body(hd, hdv, dtype)) {
    case 2:
      if (hd == 64)
        return launch_wg<64, 64>(q, k, v, o, dout, lse, delta, dq, dk, dv,
                                 partials, B, S, Hq, Hkv, scale, kv_chunk, st);
      if (hd == 128)
        return launch_wg<128, 128>(q, k, v, o, dout, lse, delta, dq, dk, dv,
                                   partials, B, S, Hq, Hkv, scale, kv_chunk,
                                   st);
      return launch_wg<192, 128>(q, k, v, o, dout, lse, delta, dq, dk, dv,
                                 partials, B, S, Hq, Hkv, scale, kv_chunk, st);
    case 1:
      return launch_tc<16>(q, k, v, o, dout, lse, delta, dq, dk, dv, partials,
                           B, S, Hq, Hkv, scale, kv_chunk, st);
  }
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  if (hd == 16)
    return launch_f32<16, 16>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, S,
                              Hq, Hkv, scale, st);
  if (hd == 64)
    return launch_f32<64, 64>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, S,
                              Hq, Hkv, scale, st);
  if (hd == 128)
    return launch_f32<128, 128>(q, k, v, o, dout, lse, delta, dq, dk, dv, B,
                                S, Hq, Hkv, scale, st);
  return launch_f32<192, 128>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, S,
                              Hq, Hkv, scale, st);
}

// The body `flash_prefill_bwd` runs for this type and these widths: 2 the
// `wgmma` body, 1 the `mma.sync` body, 0 the CUDA-core body.
extern "C" int flash_prefill_bwd_tensor_core(int hd, int hdv, int dtype) {
  return body(hd, hdv, dtype);
}

// Keys a dK/dV block of the body takes (the wrapper's `bwd_kv_tile`): 128
// for the `wgmma` body at hd 64, else 64.
extern "C" int flash_prefill_bwd_kv_tile(int hd, int hdv, int dtype) {
  return body(hd, hdv, dtype) == 2 && hd == 64 ? 128 : 64;
}
