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
// backward layout).
//
// Bound on the H100: the operations.  A sequence does 10 * S(S+1)/2 * Hq
// * hd flops of products (the QK^T recompute, dO V^T, dV, dK, dQ; the dQ
// kernel recomputes QK^T and dO V^T, 14 in all) over (4 * S * Hq + 4 * S
// * Hkv) * hd elements moved, ~1.2 * S flops a bf16 byte at Hq 32 / Hkv
// 8: past the card's ~295 from S ~250.  So the products belong on the
// tensor cores.  Two bodies, chosen by type and width in the C entry
// below (never a retry after a failure):
//
// * bf16 at hd 16, 64 and 128 -- the tensor-core body (`mma.sync.m16n8k16`,
//   float32 accumulators, mma_common.cuh), 4 warps a block:
//   - `bwd_dkdv_tc`: one block per (64-key tile, KV head, sequence), a
//     warp per 16 keys.  It walks the G query heads of the group and,
//     for each, the 64-query tiles from the diagonal down; Q, dO, lse and
//     D of tile t+1 are staged by `cp.async` into the second of two
//     stages while tile t computes.  Per tile a warp forms S^T = K Q^T
//     and dP^T = V dO^T in registers, P^T = exp2(S^T scale log2e - lse
//     log2e) and dS^T = P^T o (dP^T - D), rounds both to bf16 A fragments
//     in registers (no trip through shared memory), and accumulates dV +=
//     P^T dO and dK += dS^T Q in float32 registers (dO and Q as B through
//     `ldmatrix.trans`).  At hd 128 the 64 queries go in two passes of 32
//     to keep the two [16 x 128] accumulators and the score fragments
//     within the register file.  The GQA sum stays inside a block, in a
//     fixed order: no atomics, and two runs give the same bits (a
//     training run that resumes from a checkpoint relies on that).  When
//     one block a key tile would leave SMs idle (small B, the wrapper's
//     `bwd_kv_chunk`), the walk of each key tile is cut into chunks of
//     `chunk` tiles, one block each, that write float32 partials; then
//     `bwd_dkdv_combine` sums them in chunk order (deterministic too).
//   - `bwd_dq_tc`: one block per (64-query tile, q head, sequence), a
//     warp per 16 rows, over key tiles 0 .. diagonal with K and V in two
//     stages; S, P, dP, dS as above, then dQ += dS K (K through
//     `ldmatrix.trans`) in float32 registers, scaled at the end.  Longest
//     tiles first.
//   Only diagonal and ragged tiles are masked; rows and keys >= S are
//   zero-filled by `cp.async` and never written, so any S is legal.
//   - `bwd_dkdv_pair_tc` (MLA's training widths, Q/K 192 over V 128,
//     the non-absorbed form the JAX package trains): one warp holding
//     dK [16 x 192] and dV [16 x 128] in float32 would need 160
//     accumulator registers before any score fragment, so each 16 keys
//     get a pair of warps (8 warps, 256 threads a block).  Warps 0-3 form
//     S^T = K Q^T and P^T, store P^T (float32, in fragment order: the
//     partner lane holds the same entries) to shared memory, and
//     accumulate dV += P^T dO; warps 4-7 form dP^T = V dO^T meanwhile,
//     read P^T after one block barrier, form dS^T and accumulate dK +=
//     dS^T Q.  Same walk, staging, split and partials as `bwd_dkdv_tc`.
//   `bwd_dq_tc` takes the pair as it is: dQ [16 x 192] is 96 registers.
// * float32 -- the CUDA-core body: float32 FMAs out of shared memory
//   (each thread a 4 x 4 register tile of scores and a 4 x hd/16 tile of
//   its outputs, rows padded by one float so the 16 keys or rows a
//   half-warp reads sit in 16 banks), `bwd_dkdv` and `bwd_dq` on the same
//   grids as above without a split.  The tensor cores take bf16, so
//   float32 (the CPU-parity checks) stays on the CUDA cores' 67 TFLOP/s.
//
// Widths: Q/K hd, V, O and dO hdv; (hd, hdv) is (64, 64), (128, 128) (the
// trainable GQA families), (16, 16) (their reduced configurations, which
// the examples train) or (192, 128) (MLA).  Layouts: q/dq
// [B,S,Hq,hd]; o/dO [B,S,Hq,hdv]; k/dk [B,S,Hkv,hd]; v/dv [B,S,Hkv,hdv];
// lse and the D scratch [B,Hq,S] float32.  One type (float32 or bfloat16)
// for q, k, v, o, dO and the gradients; float32 everywhere inside.  The
// scale is the caller's (1/sqrt(hd)).
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
// the warp-pair dK/dV kernel: 8 warps; K, V, two stages of Q and dO, two
// stages of lse and D, and each 16-key group's P^T tile [16 x 64] float32
// in fragment order (T / 8 float4 a lane)
constexpr int NT2 = 256;
template <int DK, int DV>
constexpr size_t pair_smem_bytes() {
  return (size_t)3 * T * (ld<DK>() + ld<DV>()) * sizeof(__nv_bfloat16) +
         (size_t)4 * T * sizeof(float) + (size_t)4 * (T / 8) * 32 * 16;
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
// chunk order; key j's tile has ceil(G * (n - j / 64) / chunk) chunks.
// The partials hold `parts` dK tensors [B,S,Hkv,hd], then `parts` dV
// tensors [B,S,Hkv,hdv].  A thread per column c of a token row r: dK's
// and dV's element (r, c), where each has one, summed in one loop.
__global__ void bwd_dkdv_combine(const float* __restrict__ part,
                                 __nv_bfloat16* __restrict__ dk,
                                 __nv_bfloat16* __restrict__ dv, int B, int S,
                                 int Hkv, int hd, int hdv, int G, int chunk,
                                 int parts, float scale) {
  const int row_k = Hkv * hd, row_v = Hkv * hdv, row = max(row_k, row_v);
  const size_t per_k = (size_t)B * S * row_k, per_v = (size_t)B * S * row_v;
  const float* part_v = part + (size_t)parts * per_k;
  const size_t total = (size_t)B * S * row;
  const int n = (S + bwd_tc::T - 1) / bwd_tc::T;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    const size_t r = i / row;
    const int c = (int)(i - r * row), j = (int)(r % S);
    const int used = (G * (n - j / bwd_tc::T) + chunk - 1) / chunk;
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

// Warp-pair dK/dV at DK > DV (MLA's 192 / 128): block as `bwd_dkdv_tc`,
// 8 warps.  Warp w handles keys 16 (w % 4) .. +15 of the key tile; warps
// 0-3 form P^T and own dV, warps 4-7 form dS^T and own dK (see the note
// at the top).
template <int DK, int DV>
__global__ void __launch_bounds__(bwd_tc::NT2)
    bwd_dkdv_pair_tc(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     const __nv_bfloat16* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     __nv_bfloat16* __restrict__ dk,
                     __nv_bfloat16* __restrict__ dv, float* __restrict__ part,
                     int S, int Hq, int Hkv, int chunk, int parts,
                     float scale_log2, float scale) {
  using namespace bwd_tc;
  static_assert(DK > DV, "the dK accumulator is the larger one");
  constexpr int LDK = ld<DK>(), LDV = ld<DV>(), NS = T / 8;
  constexpr int NK = DK / 8, NV = DV / 8;
  extern __shared__ float4 bwd_tc_smem[];
  __nv_bfloat16* sk = reinterpret_cast<__nv_bfloat16*>(bwd_tc_smem);
  __nv_bfloat16* sv = sk + T * LDK;
  __nv_bfloat16* sq = sv + T * LDV;       // [2][T][LDK]
  __nv_bfloat16* sdo = sq + 2 * T * LDK;  // [2][T][LDV]
  float* sst = reinterpret_cast<float*>(sdo + 2 * T * LDV);  // [2][lse, D]
  float4* sp = reinterpret_cast<float4*>(sst + 4 * T);  // [4][NS][32] P^T
  const int n = (S + T - 1) / T, G = Hq / Hkv;
  const int kt = blockIdx.x / parts, c = blockIdx.x - kt * parts;
  const int hk = blockIdx.y, b = blockIdx.z, nq = n - kt;
  const int it0 = c * chunk, it1 = min(G * nq, it0 + chunk);
  if (it0 >= it1) return;  // a chunk past this key tile's walk
  const int j0 = kt * T;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int grp = warp & 3, half = warp >> 2;
  const size_t q_stride = (size_t)Hq * DK, o_stride = (size_t)Hq * DV;
  const size_t k_stride = (size_t)Hkv * DK, v_stride = (size_t)Hkv * DV;
  const size_t k_base = ((size_t)b * S * Hkv + hk) * DK;
  const size_t v_base = ((size_t)b * S * Hkv + hk) * DV;

  // iteration it: query head hk * G + it / nq, query tile kt + it % nq
  auto stage = [&](int it, int st) {
    const int g = it / nq, i0 = (kt + it - g * nq) * T, h = hk * G + g;
    mma::stage_rows<DK, NT2>(sq + st * T * LDK,
                             q + ((size_t)b * S * Hq + h) * DK, q_stride, i0,
                             S);
    mma::stage_rows<DV, NT2>(sdo + st * T * LDV,
                             dout + ((size_t)b * S * Hq + h) * DV, o_stride,
                             i0, S);
    if (threadIdx.x < 2 * T)
      stage_stats(sst + st * 2 * T, lse, delta, ((size_t)b * Hq + h) * S, i0,
                  S);
  };
  mma::stage_rows<DK, NT2>(sk, k + k_base, k_stride, j0, S);
  mma::stage_rows<DV, NT2>(sv, v + v_base, v_stride, j0, S);
  stage(it0, 0);
  mma::cp_async_commit();

  float acc[NK][4];  // warps 0-3: dV in the first NV; warps 4-7: dK
#pragma unroll
  for (int x = 0; x < NK; ++x)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[x][e] = 0.f;
  const int key0 = j0 + grp * 16 + (lane >> 2);  // keys key0, key0 + 8
  float4* my_p = sp + grp * NS * 32 + lane;     // entry x at my_p[32 x]

  for (int it = it0; it < it1; ++it) {
    mma::cp_async_wait<0>();
    __syncthreads();  // tile `it` staged; the other stage and P^T free
    const int st = (it - it0) & 1;
    if (it + 1 < it1) {
      stage(it + 1, st ^ 1);
      mma::cp_async_commit();
    }
    const int qt = kt + it % nq, i0 = qt * T;
    const __nv_bfloat16* tq = sq + st * T * LDK;
    const __nv_bfloat16* tdo = sdo + st * T * LDV;
    const float* tl = sst + st * 2 * T;
    const float* td = tl + T;
    const bool edge = qt == kt || i0 + T > S;  // diagonal or ragged tile
    // entry e of 8-query tile x is key key0 + 8 (e / 2), query i0 + 8x +
    // 2t + e % 2
    float f[NS][4];
#pragma unroll
    for (int x = 0; x < NS; ++x)
#pragma unroll
      for (int e = 0; e < 4; ++e) f[x][e] = 0.f;
    if (half == 0) {
      // S^T = K Q^T (K as A, Q as B), then P^T, shared with the partner
#pragma unroll
      for (int kk = 0; kk < DK / 16; ++kk) {
        uint32_t ka[4];
        mma::ldsm_x4(ka, mma::a_frag_addr(sk, LDK, grp * 16, kk * 16, lane));
#pragma unroll
        for (int np = 0; np < NS / 2; ++np) {
          uint32_t bq[4];
          mma::ldsm_x4(bq, mma::bk_frag_addr(tq, LDK, np * 16, kk * 16,
                                             lane));
          mma::mma_bf16(f[2 * np], ka, bq[0], bq[1]);
          mma::mma_bf16(f[2 * np + 1], ka, bq[2], bq[3]);
        }
      }
#pragma unroll
      for (int x = 0; x < NS; ++x) {
        const int col = x * 8 + 2 * (lane & 3);
        const float2 l2 = *reinterpret_cast<const float2*>(tl + col);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = i0 + col + (e & 1), j = key0 + (e >> 1) * 8;
          float p = exp2f(f[x][e] * scale_log2 -
                          (e & 1 ? l2.y : l2.x) * LOG2E);
          if (edge && (j > i || i >= S)) p = 0.f;
          f[x][e] = p;
        }
        my_p[32 * x] = make_float4(f[x][0], f[x][1], f[x][2], f[x][3]);
      }
    } else {
      // dP^T = V dO^T (V as A, dO as B) while the partner forms P^T
#pragma unroll
      for (int kk = 0; kk < DV / 16; ++kk) {
        uint32_t va[4];
        mma::ldsm_x4(va, mma::a_frag_addr(sv, LDV, grp * 16, kk * 16, lane));
#pragma unroll
        for (int np = 0; np < NS / 2; ++np) {
          uint32_t bo[4];
          mma::ldsm_x4(bo, mma::bk_frag_addr(tdo, LDV, np * 16, kk * 16,
                                             lane));
          mma::mma_bf16(f[2 * np], va, bo[0], bo[1]);
          mma::mma_bf16(f[2 * np + 1], va, bo[2], bo[3]);
        }
      }
    }
    __syncthreads();  // P^T in shared memory
    if (half == 0) {
      // dV += P^T dO: dO as B through ldmatrix.trans
#pragma unroll
      for (int kk = 0; kk < T / 16; ++kk) {
        uint32_t pa[4];
        mma::probs_to_a<NS>(f, kk, pa);
#pragma unroll
        for (int np = 0; np < NV / 2; ++np) {
          uint32_t bo[4];
          mma::ldsm_x4_trans(bo, mma::bv_frag_addr(tdo, LDV, kk * 16,
                                                   np * 16, lane));
          mma::mma_bf16(acc[2 * np], pa, bo[0], bo[1]);
          mma::mma_bf16(acc[2 * np + 1], pa, bo[2], bo[3]);
        }
      }
    } else {
      // dS^T = P^T o (dP^T - D), then dK += dS^T Q: Q as B through
      // ldmatrix.trans
#pragma unroll
      for (int x = 0; x < NS; ++x) {
        const float4 p4 = my_p[32 * x];
        const float2 d2 =
            *reinterpret_cast<const float2*>(td + x * 8 + 2 * (lane & 3));
        f[x][0] = p4.x * (f[x][0] - d2.x);
        f[x][1] = p4.y * (f[x][1] - d2.y);
        f[x][2] = p4.z * (f[x][2] - d2.x);
        f[x][3] = p4.w * (f[x][3] - d2.y);
      }
#pragma unroll
      for (int kk = 0; kk < T / 16; ++kk) {
        uint32_t da[4];
        mma::probs_to_a<NS>(f, kk, da);
#pragma unroll
        for (int np = 0; np < NK / 2; ++np) {
          uint32_t bq[4];
          mma::ldsm_x4_trans(bq, mma::bv_frag_addr(tq, LDK, kk * 16, np * 16,
                                                   lane));
          mma::mma_bf16(acc[2 * np], da, bq[0], bq[1]);
          mma::mma_bf16(acc[2 * np + 1], da, bq[2], bq[3]);
        }
      }
    }
  }

  const size_t rows = (size_t)gridDim.z * S * Hkv;  // B * S * Hkv
  const size_t per_k = rows * DK, per_v = rows * DV;  // one partial each
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int j = key0 + u * 8;
    if (j >= S) continue;
    if (half == 0) {
      const size_t off = v_base + (size_t)j * v_stride + 2 * (lane & 3);
      if (parts == 1) {
#pragma unroll
        for (int x = 0; x < NV; ++x)
          *reinterpret_cast<uint32_t*>(dv + off + x * 8) =
              mma::pack_bf16(acc[x][2 * u], acc[x][2 * u + 1]);
      } else {
        float* pv = part + (size_t)parts * per_k + (size_t)c * per_v + off;
#pragma unroll
        for (int x = 0; x < NV; ++x)
          *reinterpret_cast<float2*>(pv + x * 8) =
              make_float2(acc[x][2 * u], acc[x][2 * u + 1]);
      }
    } else {
      const size_t off = k_base + (size_t)j * k_stride + 2 * (lane & 3);
      if (parts == 1) {
#pragma unroll
        for (int x = 0; x < NK; ++x)
          *reinterpret_cast<uint32_t*>(dk + off + x * 8) = mma::pack_bf16(
              acc[x][2 * u] * scale, acc[x][2 * u + 1] * scale);
      } else {
        float* pk = part + (size_t)c * per_k + off;
#pragma unroll
        for (int x = 0; x < NK; ++x)
          *reinterpret_cast<float2*>(pk + x * 8) =
              make_float2(acc[x][2 * u], acc[x][2 * u + 1]);
      }
    }
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

template <int DK, int DV>
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
  cudaError_t err = launch_delta<bf16>(o, dout, delta, B, S, Hq, DV, st);
  if (err != cudaSuccess) return (int)err;

  if constexpr (DK == DV) {
    const size_t smem = smem_bytes<DK>();
    auto kv_kernel = bwd_dkdv_tc<DK>;
    err = allow_smem(kv_kernel, smem);
    if (err != cudaSuccess) return (int)err;
    kv_kernel<<<dim3(n * parts, Hkv, B), NT, smem, st>>>(
        (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout,
        (const float*)lse, (const float*)delta, (bf16*)dk, (bf16*)dv,
        (float*)part, S, Hq, Hkv, chunk, parts, scale_log2, scale);
  } else {
    const size_t smem = pair_smem_bytes<DK, DV>();
    auto kv_kernel = bwd_dkdv_pair_tc<DK, DV>;
    err = allow_smem(kv_kernel, smem);
    if (err != cudaSuccess) return (int)err;
    kv_kernel<<<dim3(n * parts, Hkv, B), NT2, smem, st>>>(
        (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout,
        (const float*)lse, (const float*)delta, (bf16*)dk, (bf16*)dv,
        (float*)part, S, Hq, Hkv, chunk, parts, scale_log2, scale);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (parts > 1) {
    const size_t per = (size_t)B * S * Hkv * (DK > DV ? DK : DV);
    const size_t need = (per + 255) / 256;
    const unsigned blocks = (unsigned)(need < 4096 ? need : 4096);
    bwd_dkdv_combine<<<blocks, 256, 0, st>>>(
        (const float*)part, (bf16*)dk, (bf16*)dv, B, S, Hkv, DK, DV, G,
        chunk, parts, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }

  const size_t smem = dq_smem_bytes<DK, DV>();
  auto q_kernel = bwd_dq_tc<DK, DV>;
  err = allow_smem(q_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  q_kernel<<<dim3(n, Hq, B), NT, smem, st>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout,
      (const float*)lse, (const float*)delta, (bf16*)dq, S, Hq, Hkv,
      scale_log2, scale);
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

// The tensor-core body takes bf16 at every accepted pair.
static bool tensor_core(int hd, int hdv, int dtype) {
  return dtype == 1 && widths_ok(hd, hdv);
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
  if (tensor_core(hd, hdv, dtype)) {
    if (hd == 16)
      return launch_tc<16, 16>(q, k, v, o, dout, lse, delta, dq, dk, dv,
                               partials, B, S, Hq, Hkv, scale, kv_chunk, st);
    if (hd == 64)
      return launch_tc<64, 64>(q, k, v, o, dout, lse, delta, dq, dk, dv,
                               partials, B, S, Hq, Hkv, scale, kv_chunk, st);
    if (hd == 128)
      return launch_tc<128, 128>(q, k, v, o, dout, lse, delta, dq, dk, dv,
                                 partials, B, S, Hq, Hkv, scale, kv_chunk,
                                 st);
    return launch_tc<192, 128>(q, k, v, o, dout, lse, delta, dq, dk, dv,
                               partials, B, S, Hq, Hkv, scale, kv_chunk, st);
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

// 1 when `flash_prefill_bwd` runs the tensor-core body for this type and
// these widths.
extern "C" int flash_prefill_bwd_tensor_core(int hd, int hdv, int dtype) {
  return tensor_core(hd, hdv, dtype);
}
