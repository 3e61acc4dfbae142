// Hopper body of the absorbed-MLA paged decode (`mla_decode_wg`),
// instantiated by mla_paged_decode.cu: bf16 queries and latent pool at
// DeepSeek-V3's widths, dl 512 latent and dr 64 RoPE columns, over
// 64-token pages (the MLA engine's page).
//
// One block takes R = 64 heads of one row's split of the key walk
// (FlashMLA's decode shape): Q [64 x 576] bf16 sits in shared memory as
// nine TMA boxes of [64 heads][64 columns] (eight of q_lat, one of
// q_rope) in 128-byte swizzle, 73.7 KB.  A key tile is one 64-token page,
// [64 x 576], nine boxes of [64 rows][64 columns] from a rank-4 map over
// the pool [N, 64, 1, dl + dr] with the page id as its outer coordinate;
// two stages of an `mbarrier` ring (147.5 KB), then P [64 x 64] bf16 (8
// KB) and each row's rescale factor and denominator: 230,952 bytes with
// the 1024-byte alignment, of the 232,448 a block may have, so one block
// an SM.  Each tile serves both products: all 576 columns for the
// scores, its first 512 for the values.
//
// 256 threads: two warpgroups, up to 255 registers a thread (a ninth warp,
// or a producer warpgroup cut by `setmaxnreg`, would cap them at 168, and
// the first warpgroup's 176 live accumulators would spill).  The second
// warpgroup's first thread issues the loads: Q and the first two pages of
// the split up front, then each later page (its table entry read a page
// ahead, clamped into the pool) into the stage both warpgroups have just
// released.
// The first warpgroup computes S = Q K^T by `wgmma.m64n64k16` from shared
// memory (36 k-steps: nine regions of four), masks the keys at or past the
// split's end (-inf, selected, never multiplied), runs the online softmax in
// log2 units in registers, and puts P (rounded to bf16) and the rescale
// factors in shared memory; then both warpgroups accumulate P V into their
// own 256 value columns, [64 x 256] float32 in 128 registers a thread, by
// `wgmma.m64n256k16` with P read K-major out of shared memory and V MN-major
// out of the same tile.  While the second accumulates P(t) V(t), the first
// computes the scores of tile t + 1; named barriers hand P over (barrier 2)
// and back (barrier 3).  Slots at or past the length land with their page:
// the first warpgroup zeroes their latent columns before any product reads
// the tile, so a stale or non-finite slot never reaches the output.
//
// The split plan stays the host's (mla_paged_decode.cu): a row of one
// split writes its normalised context; a longer row's splits write float32
// partials (the unnormalised accumulator and (m, l) a head, m in log2
// units and kept finite) for `mla_decode_combine`.
#pragma once

#include "hopper_common.cuh"
#include "mla_common.cuh"

namespace mla_wg {
constexpr int R = 64;      // heads a block: the M of one `wgmma`
constexpr int KT = 64;     // keys a tile: one 64-token page
constexpr int NT = 256;    // two warpgroups
constexpr int STAGES = 2;
constexpr int DL = 512, DR = 64;
constexpr int NR = (DL + DR) / 64;  // 64-column regions of a row: 9
constexpr int REGION = 64 * 64;     // bf16 elements of a [64][64] box
// byte offsets from a 1024-byte boundary
constexpr size_t Q = 0;
constexpr size_t K = Q + (size_t)NR * REGION * 2;
constexpr size_t PS = K + (size_t)STAGES * NR * REGION * 2;
constexpr size_t ALPHA = PS + (size_t)REGION * 2;  // [R] float
constexpr size_t DEN = ALPHA + R * 4;              // [R] float
constexpr size_t BARS = DEN + R * 4;               // Q, full, empty
constexpr size_t BYTES = BARS + 8 * (1 + 2 * STAGES) + 1024;
static_assert(BYTES <= 232448, "one block an SM");

// The body takes dl 512, dr 64 (nine regions) at 64-token pages.
inline bool width_ok(int dl, int dr, int page) {
  return dl == DL && dr == DR && page == KT;
}
}  // namespace mla_wg

// Block (head group, split, row b).  `part`: o [B][S][Hq][dl] then (m, l)
// [B][S][Hq][2] float32, S = gridDim.y (written by rows of more than one
// split).
__global__ void __launch_bounds__(mla_wg::NT, 1)
    mla_decode_wg(const __grid_constant__ CUtensorMap tql,
                  const __grid_constant__ CUtensorMap tqr,
                  const __grid_constant__ CUtensorMap tlp,
                  const int* __restrict__ tables,
                  const int* __restrict__ lengths,
                  __nv_bfloat16* __restrict__ out, float* __restrict__ part,
                  int Hq, int N, int P, float scale_log2, int split) {
  using namespace mla_wg;
  using bf16 = __nv_bfloat16;
  extern __shared__ unsigned char mla_wg_smem[];
  unsigned char* base = hop::align1024(mla_wg_smem);
  bf16* sq = reinterpret_cast<bf16*>(base + Q);
  bf16* sk = reinterpret_cast<bf16*>(base + K);
  bf16* sp = reinterpret_cast<bf16*>(base + PS);
  float* salpha = reinterpret_cast<float*>(base + ALPHA);
  float* sden = reinterpret_cast<float*>(base + DEN);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(base + BARS);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + STAGES;

  const int hb = blockIdx.x * R, s_idx = blockIdx.y, b = blockIdx.z;
  const int row_end = min(max(lengths[b], 0), P * KT);
  const int n_split = max(1, (row_end + split - 1) / split);
  if (s_idx >= n_split) return;  // the whole block: past the row's end
  const int start = s_idx * split, end = min(row_end, start + split);
  const int nt = (end - start + KT - 1) / KT;  // pages it walks (0: none)
  const int tid = threadIdx.x, wg = tid >> 7;
  const int* trow = tables + (size_t)b * P + start / KT;
  auto page_of = [&](int t) { return min(max(trow[t], 0), N - 1); };
  // page t into its stage: nine boxes of [64 rows][64 columns]
  auto load_page = [&](int t, int pg) {
    const int s = t % STAGES;
    hop::mbar_expect_tx(full + s, (uint32_t)NR * REGION * 2);
#pragma unroll
    for (int c = 0; c < NR; ++c)
      hop::tma_load(sk + (s * NR + c) * REGION, &tlp, full + s, c * 64, 0, 0,
                    pg);
  };
  if (tid == 128) {
    // the loads' thread (the second warpgroup's first): the barriers, Q
    // and the first pages
    hop::mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      hop::mbar_init(full + s, 1);
      hop::mbar_init(empty + s, 2);  // one thread of each warpgroup
    }
    hop::fence_barrier_init();
    if (nt > 0) {
      hop::prefetch_map(&tql);
      hop::prefetch_map(&tqr);
      hop::prefetch_map(&tlp);
      hop::mbar_expect_tx(q_full, (uint32_t)NR * REGION * 2);
#pragma unroll
      for (int c = 0; c < DL / 64; ++c)
        hop::tma_load(sq + c * REGION, &tql, q_full, c * 64, 0, hb, b);
      hop::tma_load(sq + (DL / 64) * REGION, &tqr, q_full, 0, 0, hb, b);
      for (int t = 0; t < STAGES && t < nt; ++t) load_page(t, page_of(t));
    }
  }
  // the loads' thread: the table entry of the next page to load, read a
  // page ahead of its use
  int pg_next = tid == 128 && STAGES < nt ? page_of(STAGES) : 0;
  __syncthreads();

  const bool first = wg == 0;  // scores and softmax, value columns 0-255
  const int ct = tid - 128 * wg, w = ct >> 5, lane = ct & 31;
  const int g = lane >> 2, c4 = lane & 3;
  float o[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) o[i] = 0.f;
  float m[2] = {mma::neg_inf(), mma::neg_inf()}, l[2] = {0.f, 0.f};
  if (first && nt > 0) hop::mbar_wait(q_full, 0);
  for (int t = 0; t < nt; ++t) {
    const int s = t % STAGES;
    bf16* kt = sk + s * NR * REGION;
    const int valid = end - (start + t * KT);  // keys < valid are read
    hop::mbar_wait(full + s, (t / STAGES) & 1);
    if (first) {
      if (valid < KT) {
        // whole pages land: zero the latent columns of the slots at or
        // past the end (all eight 16-byte chunks of a row's 128 bytes in
        // each of the eight latent regions, so the swizzle is moot)
        for (int i = ct; i < (KT - valid) * 64; i += 128) {
          const int r = valid + (i >> 6), c = (i >> 3) & 7, k = i & 7;
          *reinterpret_cast<uint4*>(kt + c * REGION + r * 64 + k * 8) =
              make_uint4(0u, 0u, 0u, 0u);
        }
        hop::fence_proxy_async();
        hop::named_sync(1, 128);
      }
      float sc[32];
      hop::wg_fence();
#pragma unroll
      for (int kk = 0; kk < NR * 4; ++kk)
        hop::mma_ss<64>(sc, hop::desc_k<R>(sq, 0, kk),
                        hop::desc_k<KT>(kt, 0, kk), kk > 0);
      hop::wg_commit();
      hop::wg_wait<0>();
      hop::fence_regs(sc);
      // this thread's keys are 8 j + 2 c4 + e % 2 of rows 16 w + g (+ 8)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (8 * j + 2 * c4 + (e & 1) >= valid) sc[4 * j + e] = mma::neg_inf();
      // the online softmax in log2 units, the scale folded into the
      // exponent's FMA: p = 2^(s scale_log2 - m)
      float nbase[2], alpha[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        float mx = mma::neg_inf();
#pragma unroll
        for (int j = 0; j < 8; ++j)
          mx = fmaxf(mx, fmaxf(sc[4 * j + 2 * u], sc[4 * j + 2 * u + 1]));
        mx = fmaxf(m[u], mma::quad_max(mx) * scale_log2);
        const float mb = mx == mma::neg_inf() ? 0.f : mx;
        alpha[u] = hop::ex2(m[u] - mb);
        m[u] = mx;
        nbase[u] = -mb;
      }
      float sum[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sc[4 * j + e] = hop::ex2(fmaf(sc[4 * j + e], scale_log2,
                                        nbase[e >> 1]));
          sum[e >> 1] += sc[4 * j + e];
        }
#pragma unroll
      for (int u = 0; u < 2; ++u) l[u] = l[u] * alpha[u] + sum[u];
      // P(t) and alpha(t) for both warpgroups, once the second is done
      // with P(t - 1)
      if (t > 0) hop::named_sync(3, 256);
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int r = 16 * w + g + 8 * u;
#pragma unroll
        for (int j = 0; j < 8; ++j)
          *reinterpret_cast<uint32_t*>(sp + r * 64 + ((j ^ (r & 7)) << 3) +
                                       2 * c4) =
              hop::pack_bf16(sc[4 * j + 2 * u], sc[4 * j + 2 * u + 1]);
        if (c4 == 0) salpha[r] = alpha[u];
      }
      hop::fence_proxy_async();
      hop::named_arrive(2, 256);
      hop::named_sync(1, 128);  // every row of P written
#pragma unroll
      for (int i = 0; i < 128; ++i) o[i] *= alpha[(i >> 1) & 1];
      hop::fence_regs(o);
      hop::wg_fence();
#pragma unroll
      for (int kk = 0; kk < KT / 16; ++kk)
        hop::mma_ss_mn256(o, hop::desc_k<R>(sp, 0, kk),
                          hop::desc_mn<KT>(kt, kk));
      hop::wg_commit();
      hop::wg_wait<0>();
      hop::fence_regs(o);
    } else {
      hop::named_sync(2, 256);  // P(t), alpha(t); zeroed slots
      const float a0 = salpha[16 * w + g], a1 = salpha[16 * w + g + 8];
#pragma unroll
      for (int i = 0; i < 128; ++i) o[i] *= (i >> 1) & 1 ? a1 : a0;
      hop::fence_regs(o);
      hop::wg_fence();
#pragma unroll
      for (int kk = 0; kk < KT / 16; ++kk)
        hop::mma_ss_mn256(o, hop::desc_k<R>(sp, 0, kk),
                          hop::desc_mn<KT>(kt + 4 * REGION, kk));
      hop::wg_commit();
      hop::wg_wait<0>();
      hop::fence_regs(o);
      if (t + 1 < nt) hop::named_arrive(3, 256);  // done with P(t)
    }
    if (ct == 0) {
      hop::mbar_arrive(empty + s);
      // the loads' thread refills the stage once both warpgroups are
      // done with page t (the first is on to the scores of page t + 1)
      if (!first && t + STAGES < nt) {
        hop::mbar_wait(empty + s, (t / STAGES) & 1);
        load_page(t + STAGES, pg_next);
        if (t + STAGES + 1 < nt) pg_next = page_of(t + STAGES + 1);
      }
    }
  }

  // accumulator entry 4 j + e of this thread: row 16 w + g + 8 (e / 2),
  // value column cbase + 8 j + 2 c4 + e % 2
  const int cbase = first ? 0 : DL / 2;
  const int B = gridDim.z, S = gridDim.y;
  if (n_split > 1) {
    // the split's float32 partial: o unnormalised, (m, l) of each head
    const size_t slot = (size_t)b * S + s_idx;
    float* po = part + slot * Hq * DL;
    float* pml = part + (size_t)B * S * Hq * DL + slot * Hq * 2;
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int h = hb + 16 * w + g + 8 * u;
      const float ls = mma::quad_sum(l[u]);
      if (h >= Hq) continue;
      float* orow = po + (size_t)h * DL + cbase + 2 * c4;
#pragma unroll
      for (int j = 0; j < 32; ++j)
        *reinterpret_cast<float2*>(orow + 8 * j) =
            make_float2(o[4 * j + 2 * u], o[4 * j + 2 * u + 1]);
      if (first && c4 == 0)
        *reinterpret_cast<float2*>(pml + (size_t)h * 2) =
            make_float2(fmaxf(m[u], PAGED_NEG_INF), ls);
    }
    return;
  }
  // one split: the normalised context, the denominators handed from the
  // first warpgroup to the second
  if (first) {
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const float ls = mma::quad_sum(l[u]);
      if (c4 == 0) sden[16 * w + g + 8 * u] = fmaxf(ls, 1e-30f);
    }
    hop::named_arrive(2, 256);
  } else {
    hop::named_sync(2, 256);
  }
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int r = 16 * w + g + 8 * u, h = hb + r;
    if (h >= Hq) continue;
    const float den = sden[r];
    bf16* orow = out + ((size_t)b * Hq + h) * DL + cbase + 2 * c4;
#pragma unroll
    for (int j = 0; j < 32; ++j)
      *reinterpret_cast<uint32_t*>(orow + 8 * j) =
          hop::pack_bf16(o[4 * j + 2 * u] / den, o[4 * j + 2 * u + 1] / den);
  }
}

// Launch the Hopper body: grid (head groups, S splits, B).
static int launch_mla_wg(const void* ql, const void* qr, const void* pages,
                         const void* tables, const void* lengths, void* out,
                         float* part, int B, int S, int Hq, int dl, int dr,
                         int N, int page, int P, float scale, int split,
                         cudaStream_t stream) {
  using namespace mla_wg;
  if (split % KT != 0) return (int)cudaErrorInvalidValue;
  CUtensorMap tql, tqr, tlp;
  int rc = make_map(&tql, ql, B, Hq, 1, dl, 64);
  if (rc == 0) rc = make_map(&tqr, qr, B, Hq, 1, dr, 64);
  if (rc == 0) rc = make_map(&tlp, pages, N, page, 1, dl + dr, 64);
  if (rc != 0) return rc;
  if (((uintptr_t)out) & 3) return (int)cudaErrorMisalignedAddress;
  auto kernel = mla_decode_wg;
  cudaError_t err = allow_smem(kernel, BYTES);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Hq + R - 1) / R, S, B);
  kernel<<<grid, NT, BYTES, stream>>>(
      tql, tqr, tlp, (const int*)tables, (const int*)lengths,
      (__nv_bfloat16*)out, part, Hq, N, P, scale * 1.4426950408889634f,
      split);
  return (int)cudaGetLastError();
}
