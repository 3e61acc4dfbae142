// Shared pieces of the paged attention kernels: float conversion,
// warp reductions, the shared-memory tile and the online-softmax update.
//
// One thread block owns R query rows (float32 in shared memory) that all
// read the same KV head.  Keys arrive KT at a time (one pool page, or one
// tile of the chunk's own keys) into shared memory; the block computes the
// R x KT scores, masks them to NEG_INF, and folds them into the running
// max m, denominator l and accumulator acc (float32, shared memory).
//
// Every bf16-query kernel on the serving paths, the int8 paged decode
// included, has a tensor-core body (gqa_tc.cuh, mla_tc.cuh,
// flash_prefill.cu, paged_decode.cu).  This float32 tile is only the
// fallback body, chosen by type and width: for float32 inputs (the int8
// decode with a float32 query among them) and for the widths the
// tensor-core bodies do not take, in every GQA kernel and in flash
// prefill.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define PAGED_NEG_INF (-1e30f)

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(int8_t x) { return (float)x; }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Views into the block's dynamic shared memory.  `dv` is the value (and
// output) width where it differs from the query / key width hd (flash
// prefill at MLA's Q/K 192 over V 128); 0 means hd.
struct Tile {
  float* q;      // [R][hd]
  float* acc;    // [R][dv]
  float* m;      // [R]
  float* l;      // [R]
  float* alpha;  // [R]
  float* k;      // [KT][hd + 1]  (padded row: conflict-free score loop)
  float* v;      // [KT][dv]
  float* s;      // [R][KT]
};

__host__ __device__ inline size_t tile_floats(int R, int KT, int hd,
                                              int dv = 0) {
  if (dv == 0) dv = hd;
  return (size_t)R * (hd + dv) + 3 * (size_t)R + (size_t)KT * (hd + 1) +
         (size_t)KT * dv + (size_t)R * KT;
}

__device__ inline Tile carve_tile(float* smem, int R, int KT, int hd,
                                  int dv = 0) {
  if (dv == 0) dv = hd;
  Tile t;
  t.q = smem;
  t.acc = t.q + R * hd;
  t.m = t.acc + R * dv;
  t.l = t.m + R;
  t.alpha = t.l + R;
  t.k = t.alpha + R;
  t.v = t.k + KT * (hd + 1);
  t.s = t.v + KT * dv;
  return t;
}

// Zero acc, set m = NEG_INF and l = 0 (`hd`: the accumulator's width).
__device__ inline void tile_init(Tile& t, int R, int hd) {
  for (int i = threadIdx.x; i < R * hd; i += blockDim.x) t.acc[i] = 0.f;
  for (int r = threadIdx.x; r < R; r += blockDim.x) {
    t.m[r] = PAGED_NEG_INF;
    t.l[r] = 0.f;
  }
}

// s[r][j] = scale * q[r] . k[j] where valid(r, j), else NEG_INF.
template <typename Valid>
__device__ inline void tile_scores(Tile& t, int R, int KT, int hd,
                                   float scale, Valid valid) {
  for (int i = threadIdx.x; i < R * KT; i += blockDim.x) {
    const int r = i / KT, j = i - (i / KT) * KT;
    float sc = PAGED_NEG_INF;
    if (valid(r, j)) {
      const float* qr = t.q + r * hd;
      const float* kj = t.k + j * (hd + 1);
      float a = 0.f;
      for (int d = 0; d < hd; ++d) a += qr[d] * kj[d];
      sc = a * scale;
    }
    t.s[i] = sc;
  }
  __syncthreads();
}

// Fold one tile of masked scores into (m, l, acc).  Masked entries add
// nothing, so a row with no valid key so far keeps l = 0 and acc = 0.
// `hd` here is the value width (acc and v rows).
__device__ inline void tile_update(Tile& t, int R, int KT, int hd) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_warps = blockDim.x >> 5;
  for (int r = warp; r < R; r += n_warps) {
    float* sr = t.s + r * KT;
    float mx = PAGED_NEG_INF;
    for (int j = lane; j < KT; j += 32) mx = fmaxf(mx, sr[j]);
    mx = warp_max(mx);
    const float m_prev = t.m[r];
    const float m_new = fmaxf(m_prev, mx);
    float sum = 0.f;
    for (int j = lane; j < KT; j += 32) {
      const float x = sr[j];
      const float p = (x > 0.5f * PAGED_NEG_INF) ? expf(x - m_new) : 0.f;
      sr[j] = p;
      sum += p;
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      const float a = expf(m_prev - m_new);
      t.alpha[r] = a;
      t.l[r] = t.l[r] * a + sum;
      t.m[r] = m_new;
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < R * hd; i += blockDim.x) {
    const int r = i / hd, d = i - (i / hd) * hd;
    const float* pr = t.s + r * KT;
    float a = 0.f;
    for (int j = 0; j < KT; ++j) a += pr[j] * t.v[j * hd + d];
    t.acc[i] = t.acc[i] * t.alpha[r] + a;
  }
  __syncthreads();
}

// Per-row factors of unscaled pages: none.
struct NoScale {
  __device__ float2 operator()(int) const { return make_float2(1.f, 1.f); }
};

// Copy KT key/value rows of one KV head into the tile (as float32).
// Row j of the source starts at src + row_offset(j); rows with
// j >= n_rows are zero-filled.  Row j's keys are multiplied by
// row_scale(j).x and its values by .y (int8 pages: the per-token-head
// scales, so the values are dequantized in registers).
template <typename T, typename RowOffset, typename RowScale = NoScale>
__device__ inline void tile_load_kv(Tile& t, const T* k_src, const T* v_src,
                                    int KT, int hd, int n_rows,
                                    RowOffset row_offset,
                                    RowScale row_scale = RowScale()) {
  for (int i = threadIdx.x; i < KT * hd; i += blockDim.x) {
    const int j = i / hd, d = i - (i / hd) * hd;
    float kx = 0.f, vx = 0.f;
    if (j < n_rows) {
      const size_t off = row_offset(j) + d;
      const float2 sc = row_scale(j);
      kx = to_f(k_src[off]) * sc.x;
      vx = to_f(v_src[off]) * sc.y;
    }
    t.k[j * (hd + 1) + d] = kx;
    t.v[j * hd + d] = vx;
  }
  __syncthreads();
}

// Start of the trailing contiguous run of valid positions (0 when the
// row has none): `_pool_limits` of the JAX package, one row.
__device__ inline int row_pool_limit(const int* cp, int C) {
  int last = -1;
  for (int i = C - 1; i >= 0; --i)
    if (cp[i] >= 0) {
      last = i;
      break;
    }
  if (last < 0) return 0;
  const int d = cp[last] - last;
  int lim = cp[last];
  for (int i = last; i >= 0 && cp[i] >= 0 && cp[i] - i == d; --i)
    lim = cp[i];
  return lim;
}

// Raise the dynamic shared-memory limit of `kernel` when a tile needs
// more than the default 48 KB.
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
