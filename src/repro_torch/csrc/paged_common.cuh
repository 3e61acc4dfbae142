// Shared pieces of the paged attention kernels: float conversion,
// warp reductions, the shared-memory tile and the online-softmax update.
//
// One thread block owns R query rows (float32 in shared memory) that all
// read the same KV head.  Keys arrive KT at a time (one pool page, or one
// tile of the chunk's own keys) into shared memory; the block computes the
// R x KT scores, masks them to NEG_INF, and folds them into the running
// max m, denominator l and accumulator acc (float32, shared memory).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define PAGED_NEG_INF (-1e30f)

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

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

// Views into the block's dynamic shared memory.
struct Tile {
  float* q;      // [R][hd]
  float* acc;    // [R][hd]
  float* m;      // [R]
  float* l;      // [R]
  float* alpha;  // [R]
  float* k;      // [KT][hd + 1]  (padded row: conflict-free score loop)
  float* v;      // [KT][hd]
  float* s;      // [R][KT]
};

__host__ __device__ inline size_t tile_floats(int R, int KT, int hd) {
  return (size_t)2 * R * hd + 3 * (size_t)R + (size_t)KT * (hd + 1) +
         (size_t)KT * hd + (size_t)R * KT;
}

__device__ inline Tile carve_tile(float* smem, int R, int KT, int hd) {
  Tile t;
  t.q = smem;
  t.acc = t.q + R * hd;
  t.m = t.acc + R * hd;
  t.l = t.m + R;
  t.alpha = t.l + R;
  t.k = t.alpha + R;
  t.v = t.k + KT * (hd + 1);
  t.s = t.v + KT * hd;
  return t;
}

// Zero acc, set m = NEG_INF and l = 0.
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

// Copy KT key/value rows of one KV head into the tile (as float32).
// Row j of the source starts at src + row_offset(j); rows with
// j >= n_rows are zero-filled.
template <typename T, typename RowOffset>
__device__ inline void tile_load_kv(Tile& t, const T* k_src, const T* v_src,
                                    int KT, int hd, int n_rows,
                                    RowOffset row_offset) {
  for (int i = threadIdx.x; i < KT * hd; i += blockDim.x) {
    const int j = i / hd, d = i - (i / hd) * hd;
    float kx = 0.f, vx = 0.f;
    if (j < n_rows) {
      const size_t off = row_offset(j) + d;
      kx = to_f(k_src[off]);
      vx = to_f(v_src[off]);
    }
    t.k[j * (hd + 1) + d] = kx;
    t.v[j * hd + d] = vx;
  }
  __syncthreads();
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
