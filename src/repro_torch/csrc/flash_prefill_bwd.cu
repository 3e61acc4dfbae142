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
// so no S x S matrix is ever stored.  Three kernels:
//
// * `bwd_delta`: D [B,Hq,S] float32, one warp per (token, q head).
// * `bwd_dkdv`: one block per (64-key tile, KV head, sequence).  It loops
//   over the G query heads of the group and, for each, over the 64-query
//   tiles on and below the key tile's diagonal, and keeps dK and dV of its
//   64 keys in float32 registers until the end.  The GQA sum therefore
//   happens inside the block, in a fixed order: no atomics, and two runs
//   give the same bits (a training run that resumes from a checkpoint
//   relies on that).
// * `bwd_dq`: one block per (64-query tile, q head, sequence) over the key
//   tiles 0 .. diagonal, dQ in float32 registers.
//
// Bound on the H100: the operations.  A sequence does 10 * S(S+1)/2 * Hq
// * hd flops (the QK^T recompute, dO V^T, dV, dK and dQ products, two
// flops a multiply-add) over (4 * S * Hq + 4 * S * Hkv) * hd elements
// moved, ~1.2 * S flops a bf16 byte at Hq 32 / Hkv 8: past the card's
// ~295 from S ~250.  This first body is a simple one: float32 FMAs out of
// shared memory on the CUDA cores (each thread a 4 x 4 register tile of
// scores and a 4 x hd/16 tile of its outputs, rows padded by one float so
// the 16 keys or rows a half-warp reads sit in 16 banks), for bf16 and
// float32 inputs alike, so it runs well below the tensor cores' rate.  A
// tensor-core body (the forward's `mma.sync` fragments) is later work.
//
// Layouts: q/dq/o/dO [B,S,Hq,hd]; k/v/dk/dv [B,S,Hkv,hd]; lse and the D
// scratch [B,Hq,S] float32.  One type (float32 or bfloat16) for q, k, v,
// o, dO and the gradients; float32 everywhere inside.  hd 64 or 128 (the
// trainable families' widths); any S, a ragged last tile included (rows
// and keys >= S are zero-filled and never written).
#include "paged_common.cuh"

namespace flash_bwd {
constexpr int T64 = 64;   // keys and queries a tile
constexpr int NT = 256;   // threads: 16 x 16
constexpr int LDP = T64 + 1;
template <int HD>
__host__ __device__ constexpr int ldh() { return HD + 1; }
template <int HD>
constexpr size_t smem_bytes() {  // K, V, Q, dO tiles; P, dS; lse, D
  return (size_t)(4 * T64 * ldh<HD>() + 2 * T64 * LDP + 2 * T64) *
         sizeof(float);
}

template <int HD>
struct Smem {
  float *k, *v, *q, *dout, *p, *ds, *lse, *delta;
  __device__ explicit Smem(float* base) {
    constexpr int L = ldh<HD>();
    k = base;
    v = k + T64 * L;
    q = v + T64 * L;
    dout = q + T64 * L;
    p = dout + T64 * L;
    ds = p + T64 * LDP;
    lse = ds + T64 * LDP;
    delta = lse + T64;
  }
};

// Rows r0 .. r0+63 of one head (row stride `stride` elements) into a
// [64][HD + 1] float tile; rows >= S are zero.
template <int HD, typename T>
__device__ __forceinline__ void load_rows(float* dst, const T* src,
                                          size_t stride, int r0, int S) {
  constexpr int L = ldh<HD>();
  for (int i = threadIdx.x; i < T64 * HD; i += NT) {
    const int r = i / HD, d = i - r * HD;
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
template <int HD>
__device__ __forceinline__ void probs_tile(const Smem<HD>& sm, int i0,
                                           int j0, int S, float scale,
                                           bool want_p) {
  constexpr int L = ldh<HD>();
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float s[4][4], dp[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) s[a][b] = dp[a][b] = 0.f;
#pragma unroll 4
  for (int d = 0; d < HD; ++d) {
    float qa[4], oa[4], kb[4], vb[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      qa[a] = sm.q[(ty + 16 * a) * L + d];
      oa[a] = sm.dout[(ty + 16 * a) * L + d];
      kb[a] = sm.k[(tx + 16 * a) * L + d];
      vb[a] = sm.v[(tx + 16 * a) * L + d];
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        s[a][b] = fmaf(qa[a], kb[b], s[a][b]);
        dp[a][b] = fmaf(oa[a], vb[b], dp[a][b]);
      }
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

// D = rowsum(dO o O), one warp per (b, i, h) row.
template <typename T>
__global__ void bwd_delta(const T* __restrict__ o, const T* __restrict__ dout,
                          float* __restrict__ delta, int B, int S, int Hq,
                          int hd) {
  const size_t row = ((size_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= (size_t)B * S * Hq) return;  // whole warps leave together
  const T* orow = o + row * hd;
  const T* grow = dout + row * hd;
  float acc = 0.f;
  for (int d = lane; d < hd; d += 32) acc += to_f(orow[d]) * to_f(grow[d]);
  acc = warp_sum(acc);
  if (lane == 0) {
    const int h = (int)(row % Hq);
    const size_t bi = row / Hq;  // b * S + i
    const int i = (int)(bi % S), b = (int)(bi / S);
    delta[((size_t)b * Hq + h) * S + i] = acc;
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(flash_bwd::NT)
    bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const T* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ delta,
             T* __restrict__ dk, T* __restrict__ dv, int S, int Hq, int Hkv,
             float scale) {
  using namespace flash_bwd;
  constexpr int L = ldh<HD>(), NC = HD / 16;
  extern __shared__ float bwd_smem[];
  const Smem<HD> sm(bwd_smem);
  const int kt = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int j0 = kt * T64, G = Hq / Hkv, n_tiles = (S + T64 - 1) / T64;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const size_t q_stride = (size_t)Hq * HD, kv_stride = (size_t)Hkv * HD;
  const size_t kv_base = ((size_t)b * S * Hkv + hk) * HD;
  load_rows<HD>(sm.k, k + kv_base, kv_stride, j0, S);
  load_rows<HD>(sm.v, v + kv_base, kv_stride, j0, S);

  float acc_k[4][NC], acc_v[4][NC];  // keys ty + 16a, columns tx + 16c
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc_k[a][c] = acc_v[a][c] = 0.f;

  for (int g = 0; g < G; ++g) {
    const int h = hk * G + g;
    const size_t q_base = ((size_t)b * S * Hq + h) * HD;
    const size_t row0 = ((size_t)b * Hq + h) * S;
    for (int qt = kt; qt < n_tiles; ++qt) {
      const int i0 = qt * T64;
      __syncthreads();  // the previous tile's Q, dO, P, dS are consumed
      load_rows<HD>(sm.q, q + q_base, q_stride, i0, S);
      load_rows<HD>(sm.dout, dout + q_base, q_stride, i0, S);
      load_row_stats(sm.lse, sm.delta, lse, delta, row0, i0, S);
      __syncthreads();
      probs_tile<HD>(sm, i0, j0, S, scale, true);
      __syncthreads();
      const int rows = min(T64, S - i0);
      for (int r = 0; r < rows; ++r) {
        float pa[4], da[4], ov[NC], qv[NC];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          pa[a] = sm.p[r * LDP + ty + 16 * a];
          da[a] = sm.ds[r * LDP + ty + 16 * a];
        }
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          ov[c] = sm.dout[r * L + tx + 16 * c];
          qv[c] = sm.q[r * L + tx + 16 * c];
        }
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int c = 0; c < NC; ++c) {
            acc_v[a][c] = fmaf(pa[a], ov[c], acc_v[a][c]);
            acc_k[a][c] = fmaf(da[a], qv[c], acc_k[a][c]);
          }
      }
    }
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int j = j0 + ty + 16 * a;
    if (j >= S) continue;
    const size_t off = kv_base + (size_t)j * kv_stride;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      dk[off + tx + 16 * c] = from_f<T>(acc_k[a][c] * scale);
      dv[off + tx + 16 * c] = from_f<T>(acc_v[a][c]);
    }
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(flash_bwd::NT)
    bwd_dq(const T* __restrict__ q, const T* __restrict__ k,
           const T* __restrict__ v, const T* __restrict__ dout,
           const float* __restrict__ lse, const float* __restrict__ delta,
           T* __restrict__ dq, int S, int Hq, int Hkv, float scale) {
  using namespace flash_bwd;
  constexpr int L = ldh<HD>(), NC = HD / 16;
  extern __shared__ float bwd_smem[];
  const Smem<HD> sm(bwd_smem);
  const int qt = gridDim.x - 1 - blockIdx.x;  // longest tiles first
  const int h = blockIdx.y, b = blockIdx.z, hk = h / (Hq / Hkv);
  const int i0 = qt * T64;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const size_t q_stride = (size_t)Hq * HD, kv_stride = (size_t)Hkv * HD;
  const size_t q_base = ((size_t)b * S * Hq + h) * HD;
  const size_t kv_base = ((size_t)b * S * Hkv + hk) * HD;
  load_rows<HD>(sm.q, q + q_base, q_stride, i0, S);
  load_rows<HD>(sm.dout, dout + q_base, q_stride, i0, S);
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
    load_rows<HD>(sm.k, k + kv_base, kv_stride, j0, S);
    load_rows<HD>(sm.v, v + kv_base, kv_stride, j0, S);
    __syncthreads();
    probs_tile<HD>(sm, i0, j0, S, scale, false);
    __syncthreads();
    const int keys = min(T64, S - j0);
    for (int j = 0; j < keys; ++j) {
      float da[4], kv[NC];
#pragma unroll
      for (int a = 0; a < 4; ++a) da[a] = sm.ds[(ty + 16 * a) * LDP + j];
#pragma unroll
      for (int c = 0; c < NC; ++c) kv[c] = sm.k[j * L + tx + 16 * c];
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

template <typename T, int HD>
static int launch(const void* q, const void* k, const void* v, const void* o,
                  const void* dout, const void* lse, void* delta, void* dq,
                  void* dk, void* dv, int B, int S, int Hq, int Hkv,
                  float scale, cudaStream_t st) {
  using namespace flash_bwd;
  const size_t rows = (size_t)B * S * Hq;
  bwd_delta<T><<<(unsigned)((rows * 32 + NT - 1) / NT), NT, 0, st>>>(
      (const T*)o, (const T*)dout, (float*)delta, B, S, Hq, HD);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const size_t smem = smem_bytes<HD>();
  const int tiles = (S + T64 - 1) / T64;
  auto kv_kernel = bwd_dkdv<T, HD>;
  err = allow_smem(kv_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kv_kernel<<<dim3(tiles, Hkv, B), NT, smem, st>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout,
      (const float*)lse, (const float*)delta, (T*)dk, (T*)dv, S, Hq, Hkv,
      scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  auto q_kernel = bwd_dq<T, HD>;
  err = allow_smem(q_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  q_kernel<<<dim3(tiles, Hq, B), NT, smem, st>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout,
      (const float*)lse, (const float*)delta, (T*)dq, S, Hq, Hkv, scale);
  return (int)cudaGetLastError();
}

// dtype codes: 0 = float32, 1 = bfloat16; hd 64 or 128 (anything else
// returns cudaErrorInvalidValue, and the wrapper refuses it first).
// `delta` is float32 scratch [B,Hq,S] the caller allocates.
extern "C" int flash_prefill_bwd(const void* q, const void* k, const void* v,
                                 const void* o, const void* dout,
                                 const void* lse, void* delta, void* dq,
                                 void* dk, void* dv, int B, int S, int Hq,
                                 int Hkv, int hd, float scale, int dtype,
                                 void* stream) {
  if (B == 0 || S == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 1 && hd == 64)
    return launch<__nv_bfloat16, 64>(q, k, v, o, dout, lse, delta, dq, dk, dv,
                                     B, S, Hq, Hkv, scale, st);
  if (dtype == 1 && hd == 128)
    return launch<__nv_bfloat16, 128>(q, k, v, o, dout, lse, delta, dq, dk,
                                      dv, B, S, Hq, Hkv, scale, st);
  if (dtype == 0 && hd == 64)
    return launch<float, 64>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, S,
                             Hq, Hkv, scale, st);
  if (dtype == 0 && hd == 128)
    return launch<float, 128>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, S,
                              Hq, Hkv, scale, st);
  return (int)cudaErrorInvalidValue;
}
