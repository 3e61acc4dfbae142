// Shared pieces of the absorbed-MLA attention kernels over a latent pool.
//
// The latent cache holds one row [c_kv ; k_rope] of dk = dl + dr values
// per token, shared by every query head.  A query row [q_lat ; q_rope] has
// the same width, so a score is one dk-wide dot product and the value is
// the key row's first dl columns: MQA with key width dk and value width dl.
//
// One thread block (NT = 256 threads) owns R = 32 query rows, the heads
// h0 .. h0+31 of one query.  Keys arrive KT = 32 token positions at a time
// (each row found through the block table or in the chunk's dense latent)
// into shared memory as float32.  Warp w scores rows 4w..4w+3 against key
// `lane` and folds them into the running max and denominator, which the
// warp keeps in registers (the same warp owns the same rows on every
// tile); the probabilities go to shared memory, and every thread then
// accumulates its VPT value columns (d = tid + c * NT) of all R rows in
// registers.  The accumulator [R, dl] never touches shared memory: at
// dl = 512 that is 64 registers a thread.  Masked keys contribute exactly
// 0, so a row with no valid key keeps l = 0 and writes zeros.
#pragma once

#include "paged_common.cuh"

namespace mla {

constexpr int NT = 256;  // threads per block (8 warps)
constexpr int R = 32;    // query rows (heads) per block: 4 per warp
constexpr int KT = 32;   // keys per tile: one per lane

__host__ __device__ inline int pad4(int x) { return (x + 3) & ~3; }

struct Smem {
  float* q;        // [R][dkp]       query rows, zero past dk
  float* p;        // [R][KT]        probabilities of the current tile
  float* k;        // [KT][dkp + 1]  key tile (odd stride: no bank conflicts)
  float* l;        // [R]            final denominators
  float* alpha;    // [R]            rescale factors of the current tile
  long long* row;  // [KT]           element offset of each key row, -1 = none
  int* valid;      // [KT]           the current tile's mask
  int* cp;         // [C]            chunk positions (segment prefill)
};

__host__ __device__ inline size_t float_bytes(int dk) {
  const int dkp = pad4(dk);
  const size_t n = (size_t)R * dkp + (size_t)R * KT + (size_t)KT * (dkp + 1) +
                   2 * (size_t)R;
  return (n * sizeof(float) + 7) & ~(size_t)7;
}

// Dynamic shared memory of one block; n_cp chunk positions.
inline size_t smem_bytes(int dk, int n_cp) {
  return float_bytes(dk) + KT * sizeof(long long) + (KT + n_cp) * sizeof(int);
}

__device__ inline Smem carve(float* base, int dk) {
  const int dkp = pad4(dk);
  Smem s;
  s.q = base;
  s.p = s.q + R * dkp;
  s.k = s.p + R * KT;
  s.l = s.k + KT * (dkp + 1);
  s.alpha = s.l + R;
  s.row = reinterpret_cast<long long*>(reinterpret_cast<char*>(base) +
                                       float_bytes(dk));
  s.valid = reinterpret_cast<int*>(s.row + KT);
  s.cp = s.valid + KT;
  return s;
}

// Query row `qi` (= b * C + i): rows r -> head h0 + r; heads past Hq and
// columns past dk are zero.
template <typename TQ>
__device__ inline void load_queries(Smem& s, const TQ* __restrict__ q_lat,
                                    const TQ* __restrict__ q_rope, size_t qi,
                                    int h0, int Hq, int dl, int dr) {
  const int dk = dl + dr, dkp = pad4(dk);
  for (int i = threadIdx.x; i < R * dkp; i += NT) {
    const int r = i / dkp, d = i - r * dkp;
    const int h = h0 + r;
    float x = 0.f;
    if (h < Hq) {
      const size_t row = qi * Hq + h;
      if (d < dl)
        x = to_f(q_lat[row * dl + d]);
      else if (d < dk)
        x = to_f(q_rope[row * dr + (d - dl)]);
    }
    s.q[i] = x;
  }
}

// Key rows for pool positions start .. start+KT-1 through the row's block
// table `trow` (entries clamped into [0, N-1]); positions >= end are
// absent, and valid(pos) masks the present ones.
template <typename Valid>
__device__ inline void set_pool_rows(Smem& s, const int* __restrict__ trow,
                                     int start, int end, int N, int page,
                                     int dk, Valid valid) {
  const int j = threadIdx.x;
  if (j < KT) {
    const int pos = start + j;
    long long o = -1;
    int ok = 0;
    if (pos < end) {
      const int pid = min(max(trow[pos / page], 0), N - 1);
      o = ((long long)pid * page + pos % page) * dk;
      ok = valid(pos) ? 1 : 0;
    }
    s.row[j] = o;
    s.valid[j] = ok;
  }
  __syncthreads();
}

// Key rows j0 .. j0+KT-1 of the chunk's dense latent (row `base` + j),
// present and valid for j < n.
__device__ inline void set_chunk_rows(Smem& s, size_t base, int j0, int n,
                                      int dk) {
  const int j = threadIdx.x;
  if (j < KT) {
    const int jj = j0 + j;
    const bool present = jj < n;
    s.row[j] = present ? (long long)(base + jj) * dk : -1;
    s.valid[j] = present ? 1 : 0;
  }
  __syncthreads();
}

// Fold one tile of KT keys (rows set by set_*_rows) into the running
// state: m_run / l_run are the warp's four rows, acc the thread's columns.
template <int VPT, typename T>
__device__ __forceinline__ void attend_tile(Smem& s, float (&acc)[R][VPT],
                                            float (&m_run)[4],
                                            float (&l_run)[4],
                                            const T* __restrict__ src, int dl,
                                            int dk, float scale) {
  const int dkp = pad4(dk), ks = dkp + 1;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  // 1. stage the key rows as float32 (absent rows and pad columns zero)
  for (int i = tid; i < KT * dkp; i += NT) {
    const int j = i / dkp, d = i - j * dkp;
    const long long o = s.row[j];
    s.k[j * ks + d] = (o >= 0 && d < dk) ? to_f(src[o + d]) : 0.f;
  }
  __syncthreads();

  // 2. scores of rows 4w .. 4w+3 against key `lane`, online softmax
  float a[4] = {0.f, 0.f, 0.f, 0.f};
  const float* kj = s.k + lane * ks;
  const float* q0 = s.q + 4 * warp * dkp;
  for (int d = 0; d < dkp; d += 4) {
    const float k0 = kj[d], k1 = kj[d + 1], k2 = kj[d + 2], k3 = kj[d + 3];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float4 qv = *reinterpret_cast<const float4*>(q0 + u * dkp + d);
      a[u] = fmaf(qv.x, k0, a[u]);
      a[u] = fmaf(qv.y, k1, a[u]);
      a[u] = fmaf(qv.z, k2, a[u]);
      a[u] = fmaf(qv.w, k3, a[u]);
    }
  }
  const bool ok = s.valid[lane] != 0;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int r = 4 * warp + u;
    const float x = ok ? a[u] * scale : PAGED_NEG_INF;
    const float m_new = fmaxf(m_run[u], warp_max(x));
    const float pr = ok ? expf(x - m_new) : 0.f;
    s.p[r * KT + lane] = pr;
    const float al = expf(m_run[u] - m_new);
    l_run[u] = l_run[u] * al + warp_sum(pr);
    m_run[u] = m_new;
    if (lane == 0) s.alpha[r] = al;
  }
  __syncthreads();

  // 3. acc = acc * alpha + p @ v over this thread's value columns
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const float al = s.alpha[r];
#pragma unroll
    for (int c = 0; c < VPT; ++c) acc[r][c] *= al;
  }
  for (int j = 0; j < KT; j += 4) {
    float v[4][VPT];
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
#pragma unroll
      for (int c = 0; c < VPT; ++c) {
        const int d = tid + c * NT;
        v[jj][c] = d < dl ? s.k[(j + jj) * ks + d] : 0.f;
      }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float4 pv = *reinterpret_cast<const float4*>(s.p + r * KT + j);
#pragma unroll
      for (int c = 0; c < VPT; ++c)
        acc[r][c] = fmaf(pv.w, v[3][c],
                         fmaf(pv.z, v[2][c],
                              fmaf(pv.y, v[1][c],
                                   fmaf(pv.x, v[0][c], acc[r][c]))));
    }
  }
  __syncthreads();
}

// out[qi, h0 + r, :] = acc / max(l, 1e-30) for the heads below Hq.
template <int VPT, typename TQ>
__device__ inline void finish(Smem& s, const float (&acc)[R][VPT],
                              const float (&l_run)[4], TQ* __restrict__ out,
                              size_t qi, int h0, int Hq, int dl) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (lane == 0) {
#pragma unroll
    for (int u = 0; u < 4; ++u) s.l[4 * warp + u] = l_run[u];
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int h = h0 + r;
    if (h >= Hq) continue;
    const float l = fmaxf(s.l[r], 1e-30f);
#pragma unroll
    for (int c = 0; c < VPT; ++c) {
      const int d = tid + c * NT;
      if (d < dl) out[(qi * Hq + h) * dl + d] = from_f<TQ>(acc[r][c] / l);
    }
  }
}

}  // namespace mla
