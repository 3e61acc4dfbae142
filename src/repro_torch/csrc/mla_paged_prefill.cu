// Absorbed-MLA chunked prefill and segment prefill over the latent pool,
// on Hopper.
//
// Replaces the Pallas TPU kernels `mla_paged_prefill` and
// `mla_paged_prefill_segments` (src/repro/kernels/paged_prefill.py).  A
// chunk of C queries, each with its W_uk-absorbed heads [q_lat ; q_rope],
// attends the request's resident latent tokens through the block table
// plus the chunk's own latent rows, which arrive densely (the caller
// scatters them into the pool afterwards), causally by chunk index
// (padding queries included):
//
//   prefill:  query i sits at offset + i and attends pool tokens < offset.
//   segments: query i sits at chunk_positions[i] (ascending, -1 = pad) and
//             attends pool tokens < its own position except the slots any
//             chunk position will fill (one exclusion flag per key).  The
//             walk stops at min(own position, the row's pool limit) -- the
//             limit is `_pool_limits`: the start of the trailing contiguous
//             run of positions, past which every slot is the chunk's own.
//             With contiguous positions both variants walk the same keys
//             with the same mask and the same order of products, so they
//             agree bit for bit (each body is one template for both).
//
// Bound on the H100: a chunk of C = 64 queries over T attended tokens
// does C * Hq * (2 * dk + 2 * dl) flops per token (17.8 MFLOP at Hq = 128)
// on 1152 bytes of latent: about 15 kFLOP per byte, far above the card's
// balance point, so operations bound it: a matrix product of [heads x dk]
// by [dk x keys], then [heads x keys] by [keys x dl] for every query.
//
// Two bodies, chosen by type and width in `dispatch` below (never a retry
// after a failure):
//
// * bf16 queries and pool with dl a multiple of 32 up to 512 and dr a
//   multiple of 8 -- the tensor-core body (`mla_prefill_tc`): one block
//   owns R = 64 heads of one query (heads >= Hq are zero rows; dk is
//   zero-padded to a multiple of 16), so all its rows share one key set
//   and one valid flag a key.  Q [64 x dk] is bf16 in shared memory; key
//   tiles of KT = 32 gathered latent rows arrive by 16-byte `cp.async`
//   into a ring of three stages, and each staged tile serves both
//   products: all dk columns for the scores, its first dl columns for
//   the values (`ldmatrix.trans`).  8 warps in two warpgroups, each warp
//   16 rows (`mma.sync.m16n8k16` bf16, float32 fragments).  While every
//   warp accumulates P(t) V(t) into its warpgroup's half of the dl value
//   columns (16 rows x dl/2 float32 a warp in registers, 128 a thread at
//   dl = 512: the [64 x 512] accumulator does not fit one warpgroup, as
//   in FlashMLA), both warpgroups compute the scores of tile t+1 over
//   half of dk each, warps 0-3 add the halves and run the online
//   softmax, and tile t+2 loads.  One block-wide barrier a tile; P and
//   the rescale factors pass between warp w and w + 4 in fragment order.
//   About 200 KB of shared memory at DeepSeek-V3 width: one block an SM
//   (KT = 64 would need more than the 227 KB a block can have).
// * float32 queries (with a float32 or bf16 pool), and bf16 at other
//   widths -- the CUDA-core body (`mla_prefill_kernel`): one block per
//   (32 heads, query), float32 FMAs out of shared memory with the
//   accumulator in registers (see mla_common.cuh).
//
// Layouts: q_lat [B,C,Hq,dl], q_rope [B,C,Hq,dr]; lat_chunk [B,C,dl+dr]
// (q's type); latent pages [N,page,dl+dr]; tables [B,P] int32; offsets
// [B] or chunk_positions [B,C] int32; out [B,C,Hq,dl] in q's type.
#include "mla_common.cuh"
#include "mma_common.cuh"

// ---------------------------------------------------------------------------
// CUDA-core body (float32 queries; bf16 at other widths)
// ---------------------------------------------------------------------------
template <bool SEG, typename TQ, typename TKV, int VPT>
__global__ void __launch_bounds__(mla::NT, 1)
    mla_prefill_kernel(const TQ* __restrict__ q_lat,
                       const TQ* __restrict__ q_rope,
                       const TQ* __restrict__ lat_chunk,
                       const TKV* __restrict__ pages,
                       const int* __restrict__ tables,
                       const int* __restrict__ where,  // [B] or [B,C]
                       TQ* __restrict__ out, int C, int Hq, int dl, int dr,
                       int N, int page, int P, float scale) {
  using namespace mla;
  extern __shared__ float4 mla_smem[];
  __shared__ int end_s, my_s;
  const int h0 = blockIdx.x * R, i = blockIdx.y, b = blockIdx.z;
  const int dk = dl + dr;
  const size_t qi = (size_t)b * C + i;
  Smem s = carve(reinterpret_cast<float*>(mla_smem), dk);
  load_queries(s, q_lat, q_rope, qi, h0, Hq, dl, dr);

  float acc[R][VPT];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < VPT; ++c) acc[r][c] = 0.f;
  float m_run[4], l_run[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    m_run[u] = PAGED_NEG_INF;
    l_run[u] = 0.f;
  }

  if (SEG) {
    for (int c = threadIdx.x; c < C; c += NT)
      s.cp[c] = where[(size_t)b * C + c];
    __syncthreads();
    if (threadIdx.x == 0) {
      my_s = s.cp[i];
      end_s = min(row_pool_limit(s.cp, C), max(s.cp[i], 0));
    }
  } else if (threadIdx.x == 0) {
    my_s = 0;
    end_s = max(where[b], 0);
  }
  __syncthreads();
  const int my = my_s, end = min(end_s, P * page);

  // resident pool tokens
  const int* trow = tables + (size_t)b * P;
  for (int start = 0; start < end; start += KT) {
    set_pool_rows(s, trow, start, end, N, page, dk, [&](int pos) {
      if (!SEG) return true;
      if (pos >= my) return false;
      for (int c = 0; c < C; ++c)
        if (s.cp[c] == pos) return false;
      return true;
    });
    attend_tile<VPT>(s, acc, m_run, l_run, pages, dl, dk, scale);
  }

  // the chunk's own latent rows j <= i
  for (int j0 = 0; j0 <= i; j0 += KT) {
    set_chunk_rows(s, (size_t)b * C, j0, i + 1, dk);
    attend_tile<VPT>(s, acc, m_run, l_run, lat_chunk, dl, dk, scale);
  }
  finish<VPT>(s, acc, l_run, out, qi, h0, Hq, dl);
}

template <bool SEG, typename TQ, typename TKV, int VPT>
static int launch(const void* ql, const void* qr, const void* lc,
                  const void* pages, const void* tables, const void* where,
                  void* out, int B, int C, int Hq, int dl, int dr, int N,
                  int page, int P, float scale, cudaStream_t stream) {
  const size_t smem = mla::smem_bytes(dl + dr, SEG ? C : 0);
  auto kernel = mla_prefill_kernel<SEG, TQ, TKV, VPT>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Hq + mla::R - 1) / mla::R, C, B);
  kernel<<<grid, mla::NT, smem, stream>>>(
      (const TQ*)ql, (const TQ*)qr, (const TQ*)lc, (const TKV*)pages,
      (const int*)tables, (const int*)where, (TQ*)out, C, Hq, dl, dr, N, page,
      P, scale);
  return (int)cudaGetLastError();
}

template <bool SEG, typename TQ, typename TKV>
static int by_width(const void* ql, const void* qr, const void* lc,
                    const void* pages, const void* tables, const void* where,
                    void* out, int B, int C, int Hq, int dl, int dr, int N,
                    int page, int P, float scale, cudaStream_t st) {
  if (dl <= mla::NT)
    return launch<SEG, TQ, TKV, 1>(ql, qr, lc, pages, tables, where, out, B,
                                   C, Hq, dl, dr, N, page, P, scale, st);
  if (dl <= 2 * mla::NT)
    return launch<SEG, TQ, TKV, 2>(ql, qr, lc, pages, tables, where, out, B,
                                   C, Hq, dl, dr, N, page, P, scale, st);
  return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// tensor-core body (bf16 queries and pool)
// ---------------------------------------------------------------------------
namespace mla_tc {
constexpr int NT = 256;     // threads: two warpgroups
constexpr int R = 64;       // heads of one query a block, 16 a warp
constexpr int KT = 32;      // keys a tile
constexpr int STAGES = 3;   // key tiles in flight: PV, scores, loading

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
template <bool SEG, int VN>
__global__ void __launch_bounds__(mla_tc::NT, 1)
    mla_prefill_tc(const __nv_bfloat16* __restrict__ q_lat,
                   const __nv_bfloat16* __restrict__ q_rope,
                   const __nv_bfloat16* __restrict__ lat_chunk,
                   const __nv_bfloat16* __restrict__ pages,
                   const int* __restrict__ tables,
                   const int* __restrict__ where,  // [B] or [B,C]
                   __nv_bfloat16* __restrict__ out, int C, int Hq, int dl,
                   int dr, int N, int page, int P, float scale_log2) {
  using namespace mla_tc;
  using bf16 = __nv_bfloat16;
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
  const int h0 = blockIdx.x * R, i = blockIdx.y, b = blockIdx.z;
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
  const int my = my_s, end = min(end_s, P * page);
  // pool tiles, then the chunk's own rows j <= i
  const int n_pool = (end + KT - 1) / KT, nt = n_pool + i / KT + 1;

  // query rows: head h0 + r, [q_lat ; q_rope ; zeros]
  for (int c = tid; c < R * nch; c += NT) {
    const int r = c / nch, col = (c - r * nch) * 8, h = h0 + r;
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
    const int pos = t * KT + kj;
    return t < n_pool && pos < end ? min(max(trow[pos / page], 0), N - 1)
                                   : -1;
  };
  // and its valid flag (one a key, for every row of the block)
  auto stage = [&](int t, int pid) {
    const int pos = t * KT + kj, jj = (t - n_pool) * KT + kj;
    const bf16* row = nullptr;
    if (t < n_pool) {
      if (pid >= 0) row = pages + ((size_t)pid * page + pos % page) * dk;
    } else if (jj <= i) {
      row = lat_chunk + (qi - i + jj) * dk;
    }
    bf16* dst = sk + ((t % STAGES) * KT + kj) * LD;
    for (int c = kc; c < nch; c += 8) {
      const bool ok = row != nullptr && c < kch;
      mma::cp_async16(dst + c * 8, ok ? row + c * 8 : lat_chunk, ok);
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
    const int r = r0 + g + 8 * u, h = h0 + r;
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

// The tensor-core body takes bf16 queries and pool with dl a multiple of
// 32 (two warpgroups of 16-column value tiles) up to 512 and dr a
// multiple of 8 (16-byte rows), within the block's shared memory.
static bool tensor_core_width(int dl, int dr, int n_cp) {
  return dl > 0 && dl % 32 == 0 && dl <= 512 && dr >= 0 && dr % 8 == 0 &&
         mla_tc::smem_bytes(dl + dr, n_cp) <= 232448;
}

template <bool SEG, int VN>
static int launch_tc(const void* ql, const void* qr, const void* lc,
                     const void* pages, const void* tables, const void* where,
                     void* out, int B, int C, int Hq, int dl, int dr, int N,
                     int page, int P, float scale, cudaStream_t stream) {
  const size_t smem = mla_tc::smem_bytes(dl + dr, SEG ? C : 0);
  auto kernel = mla_prefill_tc<SEG, VN>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Hq + mla_tc::R - 1) / mla_tc::R, C, B);
  using bf16 = __nv_bfloat16;
  kernel<<<grid, mla_tc::NT, smem, stream>>>(
      (const bf16*)ql, (const bf16*)qr, (const bf16*)lc, (const bf16*)pages,
      (const int*)tables, (const int*)where, (bf16*)out, C, Hq, dl, dr, N,
      page, P, scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// dispatch by type and width
// ---------------------------------------------------------------------------
template <bool SEG>
static int dispatch(const void* ql, const void* qr, const void* lc,
                    const void* pages, const void* tables, const void* where,
                    void* out, int B, int C, int Hq, int dl, int dr, int N,
                    int page, int P, float scale, int q_dtype, int kv_dtype,
                    void* stream) {
  if (B == 0 || C == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (q_dtype == 1 && kv_dtype == 1) {
    if (tensor_core_width(dl, dr, SEG ? C : 0)) {
      if (dl <= 128)
        return launch_tc<SEG, 8>(ql, qr, lc, pages, tables, where, out, B, C,
                                 Hq, dl, dr, N, page, P, scale, st);
      return launch_tc<SEG, 32>(ql, qr, lc, pages, tables, where, out, B, C,
                                Hq, dl, dr, N, page, P, scale, st);
    }
    return by_width<SEG, __nv_bfloat16, __nv_bfloat16>(
        ql, qr, lc, pages, tables, where, out, B, C, Hq, dl, dr, N, page, P,
        scale, st);
  }
  if (q_dtype == 0 && kv_dtype == 1)
    return by_width<SEG, float, __nv_bfloat16>(ql, qr, lc, pages, tables,
                                               where, out, B, C, Hq, dl, dr,
                                               N, page, P, scale, st);
  if (q_dtype == 0 && kv_dtype == 0)
    return by_width<SEG, float, float>(ql, qr, lc, pages, tables, where, out,
                                       B, C, Hq, dl, dr, N, page, P, scale,
                                       st);
  return (int)cudaErrorInvalidValue;
}

// dtype codes: 0 = float32, 1 = bfloat16.
extern "C" int mla_paged_prefill(const void* q_lat, const void* q_rope,
                                 const void* lat_chunk, const void* pages,
                                 const void* tables, const void* offsets,
                                 void* out, int B, int C, int Hq, int dl,
                                 int dr, int N, int page, int P, float scale,
                                 int q_dtype, int kv_dtype, void* stream) {
  return dispatch<false>(q_lat, q_rope, lat_chunk, pages, tables, offsets,
                         out, B, C, Hq, dl, dr, N, page, P, scale, q_dtype,
                         kv_dtype, stream);
}

extern "C" int mla_paged_prefill_seg(const void* q_lat, const void* q_rope,
                                     const void* lat_chunk,
                                     const void* pages, const void* tables,
                                     const void* chunk_positions, void* out,
                                     int B, int C, int Hq, int dl, int dr,
                                     int N, int page, int P, float scale,
                                     int q_dtype, int kv_dtype,
                                     void* stream) {
  return dispatch<true>(q_lat, q_rope, lat_chunk, pages, tables,
                        chunk_positions, out, B, C, Hq, dl, dr, N, page, P,
                        scale, q_dtype, kv_dtype, stream);
}

// 1 when the entries above run the tensor-core body for these types and
// widths (n_cp: the chunk length of a segment call, 0 for the offset one).
extern "C" int mla_paged_prefill_tensor_core(int dl, int dr, int n_cp,
                                             int q_dtype, int kv_dtype) {
  return q_dtype == 1 && kv_dtype == 1 && tensor_core_width(dl, dr, n_cp);
}
