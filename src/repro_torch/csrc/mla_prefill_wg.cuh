// Hopper body of the absorbed-MLA chunk and segment prefill
// (`mla_prefill_wg<SEG>`), instantiated by mla_paged_prefill.cu: bf16
// queries, chunk latent and pool at DeepSeek-V3's widths, dl 512 latent
// and dr 64 RoPE columns, over 64-token pages (the MLA engine's page).
// It is the MLA decode's Hopper block (mla_wg.cuh: the same shared-memory
// layout, warpgroups, products and softmax) walking one chunk query's keys
// instead of one decode row's split.
//
// A block takes R = 64 heads of query i of row b: grid (head groups, C,
// B), 256 threads, one block an SM.  Shared memory holds Q [64 x 576] and
// two stages of a 64-key tile [64 x 576], each as nine [64 rows][64
// columns] regions in 128-byte swizzle (mla_wg's layout).  The maps see
// each tensor [B, S, W] as [B, W / 64, S, 64] (`make_region_map`), so one
// TMA box moves a whole tile, its regions one after another.  Q comes in
// two boxes (q_lat, q_rope seen as [B * C, Hq, dl | dr]).  The walk is a
// sequence of 64-key tiles through a two-stage `mbarrier` ring:
//   * pool tiles: whole 64-token pages of the row's table below the
//     walk's end (PREFILL: offsets[b]; SEGMENT: the query's own position
//     cut at the row's pool limit, `pool_limit_warp`), the table entry
//     read a page ahead and clamped into the pool;
//   * chunk tiles: rows 64 u .. 64 u + 63 of the row's own latent
//     [B, C, dl + dr], so TMA zero-fills the rows past C and a box never
//     reaches into row b + 1's chunk; the ceil((i + 1) / 64) tiles up to
//     the query's own row.
// Each tile carries a 64-bit mask of the keys the query reads (`keep`,
// one bit a row): the rows below the walk's end (pool) or at most i
// (chunk), less, in SEGMENT, the pool slots any chunk position will fill.
// The loads' warp (the second warpgroup's first) builds it with the
// tile's load, the chunk positions scanned from global memory (a lane
// each, OR-reduced), so any C fits; it rides in shared memory beside the
// stage.  The first warpgroup zeroes the latent columns of the rows the
// mask drops before any product reads the tile and replaces their scores
// by -inf (selected, never multiplied): a stale or non-finite slot, or a
// chunk row past the query, never reaches the output.  With contiguous
// positions both modes walk the same tiles under the same masks in the
// same order of products, so they agree bit for bit.
//
// The loads' thread issues Q at once and the first two tiles after one
// block barrier, the walk's end and the table's first entries read
// together; then each later tile into the stage both warpgroups have
// just released.  Products, softmax and the P handoff are mla_decode_wg's:
// S = Q K^T by `wgmma.m64n64k16` in the first warpgroup, the online
// softmax in log2 units, P rounded to bf16 into shared memory, and P V by
// `wgmma.m64n256k16` in both warpgroups into 256 value columns each.  The
// output is acc / max(l, 1e-30): a query whose every key is masked writes
// zeros.  Each warpgroup rounds its columns to bf16 into the Q region and
// stores them in one TMA box (heads past Hq left out).  `longest_first`
// maps blockIdx.y to query C - 1 - y, so the longest walks of a grid of
// more than one wave start first.
#pragma once

#include "mma_common.cuh"
#include "mla_wg.cuh"

namespace mla_pwg {
using namespace mla_wg;
// mla_wg's layout, then the stages' key masks and the walk's end
constexpr size_t KEEP = BARS + 8 * (1 + 2 * STAGES);  // [STAGES] uint64
constexpr size_t END = KEEP + 8 * STAGES;             // int
constexpr size_t SMEM_BYTES = END + 8 + 1024;
static_assert(SMEM_BYTES <= 232448, "one block an SM");

// The row's pool limit (`row_pool_limit` of paged_common.cuh: the start
// of the trailing contiguous run of valid chunk positions, 0 when none is
// valid), by one warp over cp [C] in global memory.
__device__ __forceinline__ int pool_limit_warp(const int* __restrict__ cp,
                                               int C, int lane) {
  int last = -1;
  for (int c = lane; c < C; c += 32)
    if (cp[c] >= 0) last = c;
  last = __reduce_max_sync(0xffffffffu, last);
  if (last < 0) return 0;
  const int d = cp[last] - last;  // constant along the trailing run
  int brk = -1;                   // the last index before the run
  for (int c = lane; c <= last; c += 32) {
    const int v = cp[c];
    if (v < 0 || v - c != d) brk = c;
  }
  brk = __reduce_max_sync(0xffffffffu, brk);
  return d + brk + 1;
}

// Bits 0 .. n - 1 (n clamped to [0, 64]).
__device__ __forceinline__ uint64_t low_bits(int n) {
  return n >= 64 ? ~0ull : n <= 0 ? 0ull : (1ull << n) - 1;
}
}  // namespace mla_pwg

// Block (head group, query, row b).  `where`: offsets [B] (PREFILL) or
// chunk positions [B, C] (SEGMENT); out [B, C, Hq, dl] through `tout`.
template <bool SEG>
__global__ void __launch_bounds__(mla_wg::NT, 1)
    mla_prefill_wg(const __grid_constant__ CUtensorMap tql,
                   const __grid_constant__ CUtensorMap tqr,
                   const __grid_constant__ CUtensorMap tlc,
                   const __grid_constant__ CUtensorMap tlp,
                   const __grid_constant__ CUtensorMap tout,
                   const int* __restrict__ tables,
                   const int* __restrict__ where, int C, int N, int P,
                   float scale_log2, int longest_first) {
  using namespace mla_pwg;
  using bf16 = __nv_bfloat16;
  extern __shared__ unsigned char mla_pwg_smem[];
  unsigned char* base = hop::align1024(mla_pwg_smem);
  bf16* sq = reinterpret_cast<bf16*>(base + Q);
  bf16* sk = reinterpret_cast<bf16*>(base + K);
  bf16* sp = reinterpret_cast<bf16*>(base + PS);
  float* salpha = reinterpret_cast<float*>(base + ALPHA);
  float* sden = reinterpret_cast<float*>(base + DEN);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(base + BARS);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + STAGES;
  uint64_t* skeep = reinterpret_cast<uint64_t*>(base + KEEP);
  int* send = reinterpret_cast<int*>(base + END);

  const int hb = blockIdx.x * R, b = blockIdx.z;
  const int i = longest_first ? C - 1 - (int)blockIdx.y : (int)blockIdx.y;
  const int tid = threadIdx.x, wg = tid >> 7;
  const int ct = tid - 128 * wg, w = ct >> 5, lane = ct & 31;
  const bool first = wg == 0;  // scores and softmax, value columns 0-255
  const bool loads = !first && w == 0;  // the second warpgroup's first warp
  const int* trow = tables + (size_t)b * P;
  const int* cp = where + (size_t)b * C;  // SEGMENT's chunk positions
  auto page_of = [&](int t) { return min(max(trow[t], 0), N - 1); };
  int end = 0, np = 0, nt = 0;  // the pool's end, pool tiles, all tiles
  auto walk = [&](int e) {
    end = e;
    np = (e + KT - 1) / KT;
    nt = np + i / KT + 1;
  };
  // the keys tile t keeps (the loads' warp, all its lanes)
  auto keep_of = [&](int t) -> uint64_t {
    if (t >= np) return low_bits(i + 1 - (t - np) * KT);  // chunk rows <= i
    const int lo = t * KT;
    uint64_t k = low_bits(end - lo);
    if (SEG) {
      // less the slots the chunk's own positions will fill
      unsigned ex0 = 0, ex1 = 0;
      for (int c = lane; c < C; c += 32) {
        const int d = cp[c] - lo;
        if (d >= 0 && d < 32) ex0 |= 1u << d;
        if (d >= 32 && d < 64) ex1 |= 1u << (d - 32);
      }
      ex0 = __reduce_or_sync(0xffffffffu, ex0);
      ex1 = __reduce_or_sync(0xffffffffu, ex1);
      k &= ~((uint64_t)ex1 << 32 | ex0);
    }
    return k;
  };
  // tile t into its stage in one box of nine [64 rows][64 columns]
  // regions: a pool page or chunk rows 64 (t - np) ..
  auto load_tile = [&](int t, int pg) {
    const int s = t % STAGES;
    hop::mbar_expect_tx(full + s, (uint32_t)NR * REGION * 2);
    if (t < np)
      hop::tma_load(sk + s * NR * REGION, &tlp, full + s, 0, 0, 0, pg);
    else
      hop::tma_load(sk + s * NR * REGION, &tlc, full + s, 0, (t - np) * KT,
                    0, b);
  };
  const int qrow = b * C + i;
  int pg[STAGES + 1] = {};
  if (loads) {
    // the table's first entries, read with the walk's end (before it is
    // known), so the start waits for one memory latency, not four
#pragma unroll
    for (int t = 0; t <= STAGES; ++t)
      pg[t] = P > 0 ? page_of(min(t, P - 1)) : 0;
    if (lane == 0) {
      hop::mbar_init(q_full, 1);
      for (int s = 0; s < STAGES; ++s) {
        hop::mbar_init(full + s, 1);
        hop::mbar_init(empty + s, 2);  // one thread of each warpgroup
      }
      hop::fence_barrier_init();
      hop::mbar_expect_tx(q_full, (uint32_t)NR * REGION * 2);
      hop::tma_load(sq, &tql, q_full, 0, hb, 0, qrow);
      hop::tma_load(sq + (DL / 64) * REGION, &tqr, q_full, 0, hb, 0, qrow);
      hop::prefetch_map(&tlc);
      hop::prefetch_map(&tlp);
      hop::prefetch_map(&tout);
    }
    int e = SEG ? min(pool_limit_warp(cp, C, lane), max(cp[i], 0))
                : max(where[b], 0);
    walk(min(e, P * KT));
    if (lane == 0) *send = end;
  }
  __syncthreads();
  // the loads' thread: the table entry of the next pool page to load,
  // read a tile ahead of its use
  int pg_next = pg[STAGES];
  if (loads) {
#pragma unroll
    for (int t = 0; t < STAGES; ++t)
      if (t < nt) {
        const uint64_t k = keep_of(t);
        if (lane == 0) {
          skeep[t] = k;
          load_tile(t, pg[t]);
        }
      }
  } else {
    walk(*send);
  }

  const int g = lane >> 2, c4 = lane & 3;
  float o[128];
#pragma unroll
  for (int x = 0; x < 128; ++x) o[x] = 0.f;
  float m[2] = {mma::neg_inf(), mma::neg_inf()}, l[2] = {0.f, 0.f};
  if (first) hop::mbar_wait(q_full, 0);
  for (int t = 0; t < nt; ++t) {
    const int s = t % STAGES;
    bf16* kt = sk + s * NR * REGION;
    hop::mbar_wait(full + s, (t / STAGES) & 1);
    if (first) {
      const uint64_t keep = skeep[s];
      if (keep != ~0ull) {
        // whole boxes land: zero the latent columns of the rows the mask
        // drops (all eight 16-byte chunks of a row's 128 bytes in each of
        // the eight latent regions, so the swizzle is moot)
        for (int x = ct; x < KT * 64; x += 128) {
          const int r = x >> 6, c = (x >> 3) & 7, k = x & 7;
          if (!((keep >> r) & 1))
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
      const uint64_t mine = keep >> (2 * c4);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (!((mine >> (8 * j + (e & 1))) & 1)) sc[4 * j + e] = mma::neg_inf();
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
      for (int x = 0; x < 128; ++x) o[x] *= alpha[(x >> 1) & 1];
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
      hop::named_sync(2, 256);  // P(t), alpha(t); dropped rows zeroed
      const float a0 = salpha[16 * w + g], a1 = salpha[16 * w + g + 8];
#pragma unroll
      for (int x = 0; x < 128; ++x) o[x] *= (x >> 1) & 1 ? a1 : a0;
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
    if (ct == 0) hop::mbar_arrive(empty + s);
    // the loads' warp refills the stage once both warpgroups are done
    // with tile t (the first is on to the scores of tile t + 1)
    if (loads && t + STAGES < nt) {
      const int tn = t + STAGES;
      const uint64_t k = keep_of(tn);
      if (lane == 0) {
        hop::mbar_wait(empty + s, (t / STAGES) & 1);
        skeep[s] = k;
        load_tile(tn, pg_next);
        if (tn + 1 < np) pg_next = page_of(tn + 1);
      }
      __syncwarp();
    }
  }

  // the normalised context: the denominators handed from the first
  // warpgroup to the second; each warpgroup rounds its 256 value columns
  // to bf16 into four regions of the Q region (free once the last scores
  // are done), which its first thread stores as one TMA box.  Accumulator
  // entry 4 j + e of this thread: row 16 w + g + 8 (e / 2), value column
  // 256 wg + 8 j + 2 c4 + e % 2
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
  bf16* so = sq + (first ? 0 : 4) * REGION;
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int r = 16 * w + g + 8 * u;
    const float inv = 1.f / sden[r];
#pragma unroll
    for (int j = 0; j < 32; ++j)
      *reinterpret_cast<uint32_t*>(so + (j >> 3) * REGION + r * 64 +
                                   (((j & 7) ^ (r & 7)) << 3) + 2 * c4) =
          hop::pack_bf16(o[4 * j + 2 * u] * inv, o[4 * j + 2 * u + 1] * inv);
  }
  hop::fence_proxy_async();
  hop::named_sync(first ? 1 : 4, 128);
  if (ct == 0) {
    hop::tma_store(&tout, so, 0, hb, first ? 0 : 4, qrow);
    hop::bulk_commit();
    hop::bulk_wait_read();
  }
}

// Rank-4 map over a contiguous bf16 tensor [B, S, W] (W a multiple of
// 64) seen as [B, W / 64, S, 64]: a box of `regions` [64 rows][64
// columns] regions in 128-byte swizzle is the body's tile layout, one
// region of 64 rows after another, moved by one TMA load or store; zero
// fill past S (a store leaves out those rows).  Returns a cudaError_t
// code.
static int make_region_map(CUtensorMap* map, const void* base, int B, int S,
                           int W, int regions) {
  const cuuint64_t e = sizeof(__nv_bfloat16);
  return encode_map(map, base,
                    {64, (cuuint64_t)S, (cuuint64_t)W / 64, (cuuint64_t)B},
                    {W * e, 64 * e, (cuuint64_t)S * W * e},
                    {64, 64, (cuuint32_t)regions, 1});
}

// Launch the Hopper body: grid (head groups, C, B).  `longest_first` < 0
// chooses by shape: longest walks first where the grid is more than one
// wave of the 132 SMs.
template <bool SEG>
static int launch_mla_prefill_wg(const void* ql, const void* qr,
                                 const void* lc, const void* pages,
                                 const void* tables, const void* where,
                                 void* out, int B, int C, int Hq, int dl,
                                 int dr, int N, int page, int P, float scale,
                                 int longest_first, cudaStream_t stream) {
  using namespace mla_pwg;
  CUtensorMap tql, tqr, tlc, tlp, tout;
  int rc = make_region_map(&tql, ql, B * C, Hq, dl, dl / 64);
  if (rc == 0) rc = make_region_map(&tqr, qr, B * C, Hq, dr, dr / 64);
  if (rc == 0) rc = make_region_map(&tlc, lc, B, C, dl + dr, NR);
  if (rc == 0) rc = make_region_map(&tlp, pages, N, page, dl + dr, NR);
  if (rc == 0) rc = make_region_map(&tout, out, B * C, Hq, dl, dl / 128);
  if (rc != 0) return rc;
  auto kernel = mla_prefill_wg<SEG>;
  cudaError_t err = allow_smem(kernel, SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Hq + R - 1) / R, C, B);
  if (longest_first < 0) longest_first = (size_t)grid.x * C * B > 132;
  kernel<<<grid, NT, SMEM_BYTES, stream>>>(
      tql, tqr, tlc, tlp, tout, (const int*)tables, (const int*)where, C, N,
      P, scale * 1.4426950408889634f, longest_first);
  return (int)cudaGetLastError();
}
