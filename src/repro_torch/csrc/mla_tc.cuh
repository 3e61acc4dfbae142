// Tensor-core body of the absorbed-MLA kernels over a latent pool: bf16
// queries and pool, one template for chunk prefill, segment prefill and
// split decode (mla_paged_prefill.cu and mla_paged_decode.cu instantiate
// it; see their source notes for what each computes).
//
// One block owns R = 64 heads of one query (heads >= Hq are zero rows;
// dk is zero-padded to a multiple of 16), so all its rows share one key
// set and one valid flag a key.  Q [64 x dk] is bf16 in shared memory;
// key tiles of KT = 32 gathered latent rows arrive by 16-byte `cp.async`
// into a ring of three stages, and each staged tile serves both
// products: all dk columns for the scores, its first dl columns for the
// values (`ldmatrix.trans`).  8 warps in two warpgroups, each warp 16
// rows (`mma.sync.m16n8k16` bf16, float32 fragments).  While every warp
// accumulates P(t) V(t) into its warpgroup's half of the dl value
// columns (16 rows x dl/2 float32 a warp in registers, 128 a thread at
// dl = 512: the [64 x 512] accumulator does not fit one warpgroup, as in
// FlashMLA), both warpgroups compute the scores of tile t+1 over half of
// dk each, warps 0-3 add the halves and run the online softmax, and tile
// t+2 loads.  One block-wide barrier a tile; P and the rescale factors
// pass between warp w and w + 4 in fragment order.  About 200 KB of
// shared memory at DeepSeek-V3 width: one block an SM (KT = 64 would
// need more than the 227 KB a block can have).
//
// Modes (blockIdx = (head group, y, row b)):
//   PREFILL  y = chunk index i; pool tokens < offsets[b], then the
//            chunk's own rows j <= i.
//   SEGMENT  y = i; pool tokens below chunk_positions[b, i] except the
//            chunk's own slots, walked up to the row's pool limit, then
//            the chunk's rows j <= i.
//   DECODE   y = split s of the row's key walk, one query a row (C = 1):
//            pool tokens [s * split, min((s + 1) * split, end)) with end
//            = min(lengths[b], P * page).  A row of n = ceil(end / split)
//            splits (at least 1) runs splits 0 .. n-1; blocks with s >= n
//            exit at once.  With n = 1 the block writes the normalised
//            context itself (a row of length 0 walks nothing and writes
//            zeros); otherwise it writes its float32 partial -- the
//            unnormalised accumulator and (m, l), m in log2 units and
//            kept finite (>= PAGED_NEG_INF) -- for the combine kernel.
#pragma once

#include "mla_common.cuh"
#include "mma_common.cuh"

namespace mla_tc {
constexpr int NT = 256;     // threads: two warpgroups
constexpr int R = 64;       // heads of one query a block, 16 a warp
constexpr int KT = 32;      // keys a tile
constexpr int STAGES = 3;   // key tiles in flight: PV, scores, loading
constexpr int PREFILL = 0, SEGMENT = 1, DECODE = 2;

__host__ __device__ inline int dkp(int dk) { return (dk + 15) & ~15; }
__host__ __device__ inline int ld(int dk) { return dkp(dk) + 8; }

// Exchange buffers between warp w of the first warpgroup and warp w + 4
// of the second (same 16 rows, same fragment layout), in fragment order
// [warp][register][lane]: conflict-free without ldmatrix.
constexpr int S_WORDS = 4 * (KT / 8) * 4 * 32;       // partial scores
constexpr int P_WORDS = 4 * (KT / 16) * 4 * 32;      // P as A fragments
constexpr int A_WORDS = 4 * 2 * 32;                  // alpha of rows g, g+8

// Q [R][ld], key stages [STAGES][KT][ld] (bf16); partial scores, two P
// and two alpha buffers, l [R] (32-bit words); valid [STAGES][KT] and
// the chunk positions [n_cp] (int).
inline size_t smem_bytes(int dk, int n_cp) {
  return (size_t)(R + STAGES * KT) * ld(dk) * 2 +
         (size_t)(S_WORDS + 2 * P_WORDS + 2 * A_WORDS + R) * 4 +
         (size_t)(STAGES * KT + n_cp) * 4;
}

// The tensor-core body takes bf16 queries and pool with dl a multiple of
// 32 (two warpgroups of 16-column value tiles) up to 512 and dr a
// multiple of 8 (16-byte rows), within the block's shared memory.
inline bool width_ok(int dl, int dr, int n_cp) {
  return dl > 0 && dl % 32 == 0 && dl <= 512 && dr >= 0 && dr % 8 == 0 &&
         smem_bytes(dl + dr, n_cp) <= 232448;
}

// Named barrier 1 between the warpgroups: the second arrives once its
// partial scores are in shared memory, the first waits for them.
__device__ __forceinline__ void scores_arrive() {
  asm volatile("bar.arrive 1, %0;\n" ::"n"(NT) : "memory");
}
__device__ __forceinline__ void scores_wait() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(NT) : "memory");
}
}  // namespace mla_tc

// Iteration t of the key walk (t = -1 .. nt-1), between two block-wide
// barriers, while tile t+2 loads into the third stage: both warpgroups
// compute the scores of tile t+1 over half of dk each (the first k-steps
// in warps 0-3, the rest in warps 4-7).  Warps 4-7 hand their half over
// and accumulate P(t) V(t) into their half of the value columns while
// warps 0-3 add the halves, run the online softmax and publish P(t+1)
// and its rescale factors, then accumulate P(t) V(t) into the other
// half.  One block-wide barrier a tile orders all of it.
//
// `where`: offsets [B] (PREFILL), chunk positions [B,C] (SEGMENT) or
// lengths [B] (DECODE); `part` (DECODE): the float32 partials, o
// [B][S][Hq][dl] then (m, l) [B][S][Hq][2], S = gridDim.y.
template <int MODE, int VN>
__global__ void __launch_bounds__(mla_tc::NT, 1)
    mla_tc_kernel(const __nv_bfloat16* __restrict__ q_lat,
                  const __nv_bfloat16* __restrict__ q_rope,
                  const __nv_bfloat16* __restrict__ lat_chunk,
                  const __nv_bfloat16* __restrict__ pages,
                  const int* __restrict__ tables,
                  const int* __restrict__ where,
                  __nv_bfloat16* __restrict__ out, float* __restrict__ part,
                  int C, int Hq, int dl, int dr, int N, int page, int P,
                  float scale_log2, int split) {
  using namespace mla_tc;
  using bf16 = __nv_bfloat16;
  constexpr bool SEG = MODE == SEGMENT, DEC = MODE == DECODE;
  extern __shared__ float4 mla_tc_smem[];
  __shared__ int end_s, my_s;
  const int dk = dl + dr, LD = ld(dk), nch = dkp(dk) / 8, kch = dk / 8;
  bf16* sq = reinterpret_cast<bf16*>(mla_tc_smem);
  bf16* sk = sq + R * LD;  // [STAGES][KT][LD]
  float* ss = reinterpret_cast<float*>(sk + STAGES * KT * LD);
  uint32_t* sp = reinterpret_cast<uint32_t*>(ss + S_WORDS);  // [2][P_WORDS]
  float* sa = reinterpret_cast<float*>(sp + 2 * P_WORDS);     // [2][A_WORDS]
  float* sl = sa + 2 * A_WORDS;
  int* svalid = reinterpret_cast<int*>(sl + R);  // [STAGES][KT]
  int* scp = svalid + STAGES * KT;
  const int hb = blockIdx.x * R, b = blockIdx.z;  // first head of the block
  const int i = DEC ? 0 : blockIdx.y;
  const size_t qi = (size_t)b * C + i;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  if (SEG) {
    for (int c = tid; c < C; c += NT) scp[c] = where[(size_t)b * C + c];
    __syncthreads();
    if (tid == 0) {
      my_s = scp[i];
      end_s = min(row_pool_limit(scp, C), max(scp[i], 0));
    }
  } else if (tid == 0) {
    my_s = 0;
    end_s = max(where[b], 0);
  }
  __syncthreads();
  const int my = my_s;
  int start = 0, end = min(end_s, P * page);
  bool partial = false;  // DECODE: this block writes a partial
  if (DEC) {
    const int n_split = max(1, (end + split - 1) / split);
    if ((int)blockIdx.y >= n_split) return;  // the whole block
    start = blockIdx.y * split;
    end = min(end, start + split);
    partial = n_split > 1;
  }
  // pool tiles, then (prefill) the chunk's own rows j <= i
  const int n_pool = (end - start + KT - 1) / KT;
  const int nt = DEC ? n_pool : n_pool + i / KT + 1;

  // query rows: head hb + r, [q_lat ; q_rope ; zeros]
  for (int c = tid; c < R * nch; c += NT) {
    const int r = c / nch, col = (c - r * nch) * 8, h = hb + r;
    const bf16* src = q_lat;
    bool ok = false;
    if (h < Hq && col < dk) {
      const size_t row = qi * Hq + h;
      src = col < dl ? q_lat + row * dl + col : q_rope + row * dr + col - dl;
      ok = true;
    }
    mma::cp_async16(sq + r * LD + col, src, ok);
  }

  // Staging: thread tid copies key kj = tid / 8 of a tile, its 16-byte
  // chunks kc, kc + 8, ... (absent rows and pad columns zero).
  const int kj = tid >> 3, kc = tid & 7;
  const int* trow = tables + (size_t)b * P;
  // the pool page holding key kj of tile t, clamped into the pool; -1
  // past `end` and for chunk tiles (loaded one tile ahead of its use)
  auto pool_page = [&](int t) -> int {
    const int pos = start + t * KT + kj;
    return t < n_pool && pos < end ? min(max(trow[pos / page], 0), N - 1)
                                   : -1;
  };
  // and its valid flag (one a key, for every row of the block)
  auto stage = [&](int t, int pid) {
    const int pos = start + t * KT + kj, jj = (t - n_pool) * KT + kj;
    const bf16* row = nullptr;
    if (t < n_pool) {
      if (pid >= 0) row = pages + ((size_t)pid * page + pos % page) * dk;
    } else if (!DEC && jj <= i) {
      row = lat_chunk + (qi - i + jj) * dk;
    }
    bf16* dst = sk + ((t % STAGES) * KT + kj) * LD;
    for (int c = kc; c < nch; c += 8) {
      const bool ok = row != nullptr && c < kch;
      mma::cp_async16(dst + c * 8, ok ? row + c * 8 : pages, ok);
    }
    if (kc == 0) {
      int valid = row != nullptr;
      if (SEG && valid && t < n_pool) {
        valid = pos < my;
        for (int c = 0; c < C; ++c)
          if (scp[c] == pos) valid = 0;
      }
      svalid[(t % STAGES) * KT + kj] = valid;
    }
  };

  stage(0, pool_page(0));
  mma::cp_async_commit();  // Q and tile 0
  int pid_next = pool_page(1);

  const bool first = warp < 4;  // the first warpgroup (softmax)
  const int wq = warp & 3, r0 = wq * 16, g = lane >> 2, tq = lane & 3;
  const int nks = nch / 2;  // 16-column k-steps of the scores
  const int ks0 = first ? 0 : nks / 2, ks1 = first ? nks / 2 : nks;
  const int cbase = first ? 0 : dl / 2;  // this warpgroup's value columns
  const int nv = dl / 16;                 // ... in 8-column tiles
  float o[VN][4], m[2], l[2], alpha[2];
  uint32_t pa[KT / 16][4];  // P(t) as A fragments
#pragma unroll
  for (int n = 0; n < VN; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  m[0] = m[1] = mma::neg_inf();
  l[0] = l[1] = 0.f;

  for (int t = -1; t < nt; ++t) {
    mma::cp_async_wait<0>();
    __syncthreads();  // tile t+1 staged, P(t) published; t-1's buffers free
    if (t + 2 < nt) {
      stage(t + 2, pid_next);
      mma::cp_async_commit();
      pid_next = pool_page(t + 3);
    }
    uint32_t pa_next[KT / 16][4];
    float alpha_next[2];
    if (t + 1 < nt) {
      // this warpgroup's half of the scores of tile t+1
      const bf16* kt = sk + ((t + 1) % STAGES) * KT * LD;
      float s[KT / 8][4];
#pragma unroll
      for (int n = 0; n < KT / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
      const bf16* qa = mma::a_frag_addr(sq, LD, r0, 0, lane);
      const bf16* kb = mma::bk_frag_addr(kt, LD, 0, 0, lane);
#pragma unroll 2
      for (int c = ks0 * 16; c < ks1 * 16; c += 16) {
        uint32_t a[4], b0[4], b1[4];
        mma::ldsm_x4(a, qa + c);
        mma::ldsm_x4(b0, kb + c);
        mma::ldsm_x4(b1, kb + 16 * LD + c);
        mma::mma_bf16(s[0], a, b0[0], b0[1]);
        mma::mma_bf16(s[1], a, b0[2], b0[3]);
        mma::mma_bf16(s[2], a, b1[0], b1[1]);
        mma::mma_bf16(s[3], a, b1[2], b1[3]);
      }
      float* sw = ss + wq * (KT / 8) * 4 * 32 + lane;
      if (!first) {
#pragma unroll
        for (int n = 0; n < KT / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) sw[(n * 4 + e) * 32] = s[n][e];
        scores_arrive();
      } else {
        scores_wait();
        const int* vf = svalid + ((t + 1) % STAGES) * KT;
#pragma unroll
        for (int n = 0; n < KT / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float x = s[n][e] + sw[(n * 4 + e) * 32];
            s[n][e] = vf[n * 8 + 2 * tq + (e & 1)] ? x * scale_log2
                                                   : mma::neg_inf();
          }
        mma::softmax_update<KT / 8>(s, m, l, alpha_next);
        uint32_t* pw = sp + ((t + 1) & 1) * P_WORDS + wq * (KT / 16) * 4 * 32;
        float* aw = sa + ((t + 1) & 1) * A_WORDS + wq * 2 * 32;
#pragma unroll
        for (int kk = 0; kk < KT / 16; ++kk) {
          mma::probs_to_a<KT / 8>(s, kk, pa_next[kk]);
#pragma unroll
          for (int x = 0; x < 4; ++x)
            pw[(kk * 4 + x) * 32 + lane] = pa_next[kk][x];
        }
        aw[lane] = alpha_next[0];
        aw[32 + lane] = alpha_next[1];
      }
    }

    if (t >= 0) {
      // o = o * alpha(t) + P(t) V(t) over this warpgroup's value columns
      if (!first) {
        const uint32_t* pr = sp + (t & 1) * P_WORDS + wq * (KT / 16) * 4 * 32;
        const float* ar = sa + (t & 1) * A_WORDS + wq * 2 * 32;
#pragma unroll
        for (int kk = 0; kk < KT / 16; ++kk)
#pragma unroll
          for (int x = 0; x < 4; ++x) pa[kk][x] = pr[(kk * 4 + x) * 32 + lane];
        alpha[0] = ar[lane];
        alpha[1] = ar[32 + lane];
      }
#pragma unroll
      for (int n = 0; n < VN; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[n][e] *= alpha[e >> 1];
      const bf16* vt = sk + (t % STAGES) * KT * LD;
#pragma unroll
      for (int kk = 0; kk < KT / 16; ++kk)
#pragma unroll
        for (int np = 0; np < VN / 2; ++np) {
          // no branch in this loop, so the loads are issued ahead of the
          // products: past this warpgroup's columns (dl < 16 VN) a tile
          // reads column cbase into accumulators that are never stored
          const int col = cbase + (2 * np < nv ? np * 16 : 0);
          uint32_t bv[4];
          mma::ldsm_x4_trans(bv,
                             mma::bv_frag_addr(vt, LD, kk * 16, col, lane));
          mma::mma_bf16(o[2 * np], pa[kk], bv[0], bv[1]);
          mma::mma_bf16(o[2 * np + 1], pa[kk], bv[2], bv[3]);
        }
    }
    if (first && t + 1 < nt) {
#pragma unroll
      for (int kk = 0; kk < KT / 16; ++kk)
#pragma unroll
        for (int x = 0; x < 4; ++x) pa[kk][x] = pa_next[kk][x];
      alpha[0] = alpha_next[0];
      alpha[1] = alpha_next[1];
    }
  }

  if (DEC && partial) {
    // the split's float32 partial: o unnormalised, (m, l) of each head
    const size_t slot = (size_t)b * gridDim.y + blockIdx.y;
    float* po = part + slot * Hq * dl;
    float* pml = part + (size_t)gridDim.z * gridDim.y * Hq * dl +
                 slot * Hq * 2;
    const float lsum[2] = {mma::quad_sum(l[0]), mma::quad_sum(l[1])};
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int h = hb + r0 + g + 8 * u;
      if (h >= Hq) continue;
      float* orow = po + (size_t)h * dl + cbase + 2 * tq;
#pragma unroll
      for (int n = 0; n < VN; ++n) {
        if (n >= nv) break;
        *reinterpret_cast<float2*>(orow + n * 8) =
            make_float2(o[n][2 * u], o[n][2 * u + 1]);
      }
      if (first && tq == 0)
        *reinterpret_cast<float2*>(pml + (size_t)h * 2) =
            make_float2(fmaxf(m[u], PAGED_NEG_INF), lsum[u]);
    }
    return;
  }

  // denominators: the first warpgroup's quad sums, shared with the second
  if (first) {
    const float l0 = mma::quad_sum(l[0]), l1 = mma::quad_sum(l[1]);
    if (tq == 0) {
      sl[r0 + g] = l0;
      sl[r0 + g + 8] = l1;
    }
  }
  __syncthreads();
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int r = r0 + g + 8 * u, h = hb + r;
    if (h >= Hq) continue;
    const float den = fmaxf(sl[r], 1e-30f);
    bf16* orow = out + (qi * Hq + h) * dl + cbase + 2 * tq;
#pragma unroll
    for (int n = 0; n < VN; ++n) {
      if (n >= nv) break;
      *reinterpret_cast<uint32_t*>(orow + n * 8) =
          mma::pack_bf16(o[n][2 * u] / den, o[n][2 * u + 1] / den);
    }
  }
}

// Launch the tensor-core body: grid (head groups, Y, B) with Y the chunk
// length (prefill) or the number of splits (decode).
template <int MODE, int VN>
static int launch_mla_tc(const void* ql, const void* qr, const void* lc,
                         const void* pages, const void* tables,
                         const void* where, void* out, float* part, int B,
                         int C, int Y, int Hq, int dl, int dr, int N,
                         int page, int P, float scale, int split,
                         cudaStream_t stream) {
  const size_t smem =
      mla_tc::smem_bytes(dl + dr, MODE == mla_tc::SEGMENT ? C : 0);
  auto kernel = mla_tc_kernel<MODE, VN>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Hq + mla_tc::R - 1) / mla_tc::R, Y, B);
  using bf16 = __nv_bfloat16;
  kernel<<<grid, mla_tc::NT, smem, stream>>>(
      (const bf16*)ql, (const bf16*)qr, (const bf16*)lc, (const bf16*)pages,
      (const int*)tables, (const int*)where, (bf16*)out, part, C, Hq, dl,
      dr, N, page, P, scale * 1.4426950408889634f, split);
  return (int)cudaGetLastError();
}

// ... at the value-tile count for dl (VN 8 up to dl 128, else 32).
template <int MODE>
static int launch_mla_tc_width(const void* ql, const void* qr,
                               const void* lc, const void* pages,
                               const void* tables, const void* where,
                               void* out, float* part, int B, int C, int Y,
                               int Hq, int dl, int dr, int N, int page,
                               int P, float scale, int split,
                               cudaStream_t st) {
  if (dl <= 128)
    return launch_mla_tc<MODE, 8>(ql, qr, lc, pages, tables, where, out,
                                  part, B, C, Y, Hq, dl, dr, N, page, P,
                                  scale, split, st);
  return launch_mla_tc<MODE, 32>(ql, qr, lc, pages, tables, where, out, part,
                                 B, C, Y, Hq, dl, dr, N, page, P, scale,
                                 split, st);
}
