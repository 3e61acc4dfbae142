// Chunked prefill and segment prefill over the paged KV pool, on Hopper.
//
// Replaces the Pallas TPU kernels `paged_prefill_attention` and
// `paged_prefill_segments` (src/repro/kernels/paged_prefill.py).  A chunk
// of C query tokens attends the request's resident pool tokens through
// the block table, plus its own keys, which arrive densely (the caller
// scatters them into the pool afterwards), causally by index.
//
//   prefill:  query i sits at offset + i and attends pool tokens
//             < offset; pages at or past the offset are skipped.
//   segments: query i sits at chunk_positions[i] (ascending, -1 = pad)
//             and attends pool tokens < its own position, except the
//             slots any chunk position will fill.  Pages at or past the
//             row's pool limit (start of the trailing contiguous run of
//             positions) are skipped.  With contiguous positions the two
//             variants walk the same keys with the same masks and the
//             same order of products, so they agree bit for bit (each
//             body is one template for both).
//
// Bound on the H100: at C = 64 the chunk does 4 * C * T * Hq * hd flops
// over T resident tokens while reading T * Hkv * hd * 2 elements of K/V:
// C * Hq / Hkv flops per element, below the card's balance point, so the
// pool bytes bound it -- but at the serving path's sizes (one request,
// a window of 512 tokens: under 1 MB of K/V) the bound is a fraction of
// a microsecond, and what sets the time is latency: the launch, the
// dependent reads (offset or positions, table entry, K/V page), the key
// tiles a block walks one behind the other (about 1 us each: one
// warpgroup's chain of products, masks and exponentials), and the merge
// of a split walk.
//
// Three bodies, chosen by type, width and page size in `body` below and
// run by `dispatch` (never a retry after a failure):
//
// * bf16 q and pool, hd 64 / 128, G = Hq / Hkv <= 16, pages of 16, 32 or
//   64 tokens -- the Hopper body (`paged_prefill_wg`).  One block per
//   (64 query rows, split of the key walk, KV head, row): its rows are
//   64 / G queries x G heads (r = query * G + head), the M of one
//   `wgmma.m64nNk16` warpgroup.  The key walk is cut on the host
//   (`prefill_split_plan`, kernels/paged_prefill.py, from B, C, Hq, Hkv,
//   hd, page and the table window alone -- never the offsets or
//   positions): pool splits of `tps` 64-key tiles, then the chunk's own
//   keys in splits of their own, at most 8.  At the serving shape (C 64,
//   G 4, Hkv 8, a 512-token window) that is 4 x 5 x 8 = 160 blocks of
//   two tiles at most; at hd 128 fewer, longer splits read faster.
//   Warp 4 is the producer: one lane issues Q by TMA at once (a box of
//   [64 / G queries][G heads][64 columns] a 64-column region, from a
//   rank-4 map over q), the lanes read all of the split's table entries
//   at once (one dependent round trip a split, entries clamped into the
//   pool) and, as soon as the row's end is known, issue every page of
//   the split as TMA boxes ([page rows][64 columns] of one head, 128-byte
//   swizzle, from a rank-4 map over the pool [N, page, Hkv, hd] with the
//   page id as its outer coordinate) into a ring of `mbarrier` stages (4
//   at hd 64, 2 at 128), page p of a tile at row p * page of the tile's
//   64-row regions; chunk tiles come from maps over the k / v chunk [B,
//   C, Hkv, hd] (rows past C zero-filled).  While the split's tiles fit
//   in the ring all its loads are in flight at once; a longer split waits
//   on the ring's empty barriers.  Warps 0-3, the consumer warpgroup,
//   meanwhile build each pool tile's 64-bit key mask by ballots (key
//   inside the row's end, not one of the chunk's own slots in segment
//   mode: a binary search over the positions the producer compacted),
//   then for each tile: S = Q K^T by `wgmma` from shared memory (both
//   K-major), the masks (one bit test and one compare a score), the
//   online softmax in log2 units in registers, P rounded to bf16 as the
//   A operand of O += P V (`wgmma`, V read MN-major).  Whole pages land
//   in shared memory, slots that no row may read included (past the
//   offset or pool limit, the chunk's own slots, past the window): on a
//   tile whose mask is not full the consumers zero those V rows before
//   P V, so a stale or non-finite slot never reaches a product (its
//   scores are replaced by -inf, not multiplied).  The splits of a query
//   block are one thread block cluster: a block keeps its float32
//   partial (unnormalised O, each row's m and l) in its own shared
//   memory, and after a cluster barrier each block merges rows sp, sp +
//   splits, ... of the live splits in split order, reading the partials
//   through distributed shared memory (`ld.shared::cluster`), then a
//   second barrier keeps every block's memory until the merge is read.
//   No scratch in device memory and no atomics: two calls agree bit for
//   bit.  A query block whose walk has one live split writes its output
//   directly and its other blocks leave at once; a block whose split
//   starts past the row's end otherwise only shares the merge.
// * bf16 q and pool at hd 16 / 32 (the reduced configurations), or hd 64
//   / 128 at other page sizes, G <= 16 -- the `mma.sync` body
//   (`paged_prefill_tc`), on the block layout of gqa_tc.cuh that the GQA
//   decode shares.  One block per (16 / G queries, KV head, row): its 16
//   rows share every staged key tile.  The block walks its pool tiles of
//   64 positions (gathered through the block table, page pos / page and
//   slot pos % page, entries clamped into the pool, so any page size),
//   then the chunk tile(s) of its causal keys, through a three-stage
//   `cp.async` ring: two tiles in flight while one is scored, and each
//   thread reads its table entry one tile ahead.  Warp w scores keys
//   16w .. 16w+15 of every tile on `mma.sync` bf16 and keeps its own
//   float32 (m, l, o); the four are merged in warp order at the end.
//   Each key of a tile gets one valid flag as it is staged (inside the
//   walk, and in segment mode not one of the chunk's own slots: a binary
//   search over the chunk's valid positions, compacted once a block by
//   one warp, which also finds the pool limit with two ballots); keys
//   that no row may read are never loaded (zero-filled), so a stale slot
//   cannot reach a product.  The row masks are one compare a score: pool
//   key < the row's position (segments), chunk key j <= i.
// * float32 q (with a float32 or bf16 pool), and bf16 at other widths --
//   the CUDA-core body (`paged_prefill_kernel`): float32 FMAs out of
//   shared memory with the page walk in the block (paged_common.cuh).
//
// Layouts: q [B,C,Hq,hd]; k/v chunk [B,C,Hkv,hd] (q's type); k/v pages
// [N,page,Hkv,hd]; tables [B,P] int32; offsets [B] or chunk_positions
// [B,C] int32; out [B,C,Hq,hd] in q's type.  The Hopper body needs
// 16-byte aligned bases (TMA), which the wrapper ensures.
#include <limits.h>

#include "gqa_tc.cuh"
#include "hopper_common.cuh"
#include "paged_common.cuh"

// ---------------------------------------------------------------------------
// CUDA-core body (float32 q; bf16 at other widths)
// ---------------------------------------------------------------------------

template <bool SEG, typename TQ, typename TKV>
__global__ void paged_prefill_kernel(
    const TQ* __restrict__ q, const TQ* __restrict__ k_chunk,
    const TQ* __restrict__ v_chunk, const TKV* __restrict__ k_pages,
    const TKV* __restrict__ v_pages, const int* __restrict__ tables,
    const int* __restrict__ where,  // offsets [B] or positions [B,C]
    TQ* __restrict__ out, int C, int Hq, int Hkv, int hd, int N, int page,
    int P, int QT, float scale) {
  extern __shared__ float smem[];
  const int b = blockIdx.x, h = blockIdx.y, i0 = blockIdx.z * QT;
  const int G = Hq / Hkv, R = QT * G, KT = page;
  const int nq = min(QT, C - i0);
  Tile t = carve_tile(smem, R, KT, hd);
  // SEG: the row's chunk positions, then one exclusion flag per key
  int* cp = reinterpret_cast<int*>(t.s + R * KT);
  int* excl = cp + C;
  __shared__ int limit_s;

  // query row r = il * G + g  <->  query i0 + il, head h * G + g
  for (int i = threadIdx.x; i < R * hd; i += blockDim.x) {
    const int r = i / hd, d = i - (i / hd) * hd;
    const int il = r / G, g = r - (r / G) * G;
    float x = 0.f;
    if (il < nq)
      x = to_f(q[(((size_t)b * C + i0 + il) * Hq + (size_t)h * G + g) * hd +
                 d]);
    t.q[i] = x;
  }
  tile_init(t, R, hd);
  if (SEG) {
    for (int i = threadIdx.x; i < C; i += blockDim.x)
      cp[i] = where[(size_t)b * C + i];
    __syncthreads();
    if (threadIdx.x == 0) limit_s = row_pool_limit(cp, C);
  } else if (threadIdx.x == 0) {
    limit_s = where[b];
  }
  __syncthreads();
  const int limit = limit_s;

  // resident pool pages below the limit
  const int n_pages = limit > 0 ? min(P, (limit + page - 1) / page) : 0;
  for (int p = 0; p < n_pages; ++p) {
    const int pid = min(max(tables[(size_t)b * P + p], 0), N - 1);
    const size_t base = (size_t)pid * page * Hkv * hd;
    const int start = p * page;
    if (SEG) {
      for (int j = threadIdx.x; j < KT; j += blockDim.x) {
        int hit = 0;
        for (int c = 0; c < C; ++c) hit |= (cp[c] == start + j);
        excl[j] = hit;
      }
    }
    tile_load_kv(t, k_pages, v_pages, KT, hd, KT, [&](int j) {
      return base + ((size_t)j * Hkv + h) * hd;
    });
    tile_scores(t, R, KT, hd, scale, [&](int r, int j) {
      const int il = r / G;
      if (il >= nq) return false;
      if (SEG) return start + j < cp[i0 + il] && !excl[j];
      return start + j < limit;
    });
    tile_update(t, R, KT, hd);
  }

  // the chunk's own keys, causal by index
  const int n_keys = i0 + nq;
  for (int j0 = 0; j0 < n_keys; j0 += KT) {
    const int rows = min(KT, C - j0);
    tile_load_kv(t, k_chunk, v_chunk, KT, hd, rows, [&](int j) {
      return (((size_t)b * C + j0 + j) * Hkv + h) * hd;
    });
    tile_scores(t, R, KT, hd, scale, [&](int r, int j) {
      const int il = r / G;
      return il < nq && j < rows && j0 + j <= i0 + il;
    });
    tile_update(t, R, KT, hd);
  }

  for (int i = threadIdx.x; i < R * hd; i += blockDim.x) {
    const int r = i / hd, d = i - (i / hd) * hd;
    const int il = r / G, g = r - (r / G) * G;
    if (il < nq)
      out[(((size_t)b * C + i0 + il) * Hq + (size_t)h * G + g) * hd + d] =
          from_f<TQ>(t.acc[i] / fmaxf(t.l[r], 1e-30f));
  }
}

template <bool SEG, typename TQ, typename TKV>
static int launch(const void* q, const void* kc, const void* vc,
                  const void* kp, const void* vp, const void* tables,
                  const void* where, void* out, int B, int C, int Hq, int Hkv,
                  int hd, int N, int page, int P, float scale,
                  cudaStream_t stream) {
  const int G = Hq / Hkv;
  // about 32 query rows per block: QT queries x G heads
  const int QT = max(1, min(C, 32 / G));
  const int R = QT * G;
  const size_t smem = tile_floats(R, page, hd) * sizeof(float) +
                      (SEG ? (size_t)(C + page) * sizeof(int) : 0);
  auto kernel = paged_prefill_kernel<SEG, TQ, TKV>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B, Hkv, (C + QT - 1) / QT);
  kernel<<<grid, 256, smem, stream>>>(
      (const TQ*)q, (const TQ*)kc, (const TQ*)vc, (const TKV*)kp,
      (const TKV*)vp, (const int*)tables, (const int*)where, (TQ*)out, C, Hq,
      Hkv, hd, N, page, P, QT, scale);
  return (int)cudaGetLastError();
}

// Segment mode, one warp: compact row b's valid chunk positions `cp` [C]
// in order into `sown` (their count to *n_own), then the pool limit
// (`row_pool_limit`) to *end: with `last` the last valid index and d =
// cp[last] - last, the trailing run starts one past the last index <=
// last with cp[c] < 0 or cp[c] - c != d.
__device__ __forceinline__ void seg_scan(const int* __restrict__ cp, int C,
                                         int lane, int* sown, int* n_own,
                                         int* end) {
  int n = 0, last = -1, last_pos = 0;
  for (int c0 = 0; c0 < C; c0 += 128) {
    int x[4];  // 128 positions a pass, their loads in flight together
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int c = c0 + 32 * k + lane;
      x[k] = c < C ? cp[c] : -1;
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const unsigned vm = __ballot_sync(0xffffffffu, x[k] >= 0);
      if (x[k] >= 0) sown[n + __popc(vm & ((1u << lane) - 1u))] = x[k];
      n += __popc(vm);
      if (vm) {
        const int hi = 31 - __clz(vm);
        last = c0 + 32 * k + hi;
        last_pos = __shfl_sync(0xffffffffu, x[k], hi);
      }
    }
  }
  const int d = last_pos - last;
  int brk = -1;
  for (int c0 = 0; c0 <= last; c0 += 32) {
    const int c = c0 + lane;
    const int x = c < C ? cp[c] : -1;
    const unsigned bm =
        __ballot_sync(0xffffffffu, c <= last && (x < 0 || x - c != d));
    if (bm) brk = c0 + 31 - __clz(bm);
  }
  if (lane == 0) {
    *n_own = n;
    *end = last < 0 ? 0 : d + brk + 1;
  }
}

// Is pool position pos one of the n_own compacted chunk positions?
__device__ __forceinline__ bool own_slot(const int* sown, int n_own,
                                         int pos) {
  int lo = 0, hi = n_own;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (sown[mid] < pos)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo < n_own && sown[lo] == pos;
}

// ---------------------------------------------------------------------------
// tensor-core body (bf16 q and pool)
// ---------------------------------------------------------------------------
// Shared memory: the ring, the valid flags of its stages [STAGES][KT]
// (int), and in segment mode the chunk's valid positions [C] (int).
inline size_t prefill_tc_smem(int hd, int C, bool seg) {
  return gqa_tc::ring_bytes(hd) + (size_t)gqa_tc::STAGES * gqa_tc::KT * 4 +
         (seg ? (size_t)C * 4 : 0);
}

template <bool SEG, int HD>
__global__ void __launch_bounds__(gqa_tc::NT)
    paged_prefill_tc(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k_chunk,
                     const __nv_bfloat16* __restrict__ v_chunk,
                     const __nv_bfloat16* __restrict__ k_pages,
                     const __nv_bfloat16* __restrict__ v_pages,
                     const int* __restrict__ tables,
                     const int* __restrict__ where,  // offsets or positions
                     __nv_bfloat16* __restrict__ out, int C, int Hq, int Hkv,
                     int N, int page, int P, float scale_log2) {
  using namespace gqa_tc;
  using bf16 = __nv_bfloat16;
  constexpr int LD = HD + 8, CH = HD / 8;  // row stride; 16-byte chunks
  constexpr int TILE = 2 * KT * LD;        // one stage: K then V
  extern __shared__ float4 prefill_smem[];
  bf16* ring = reinterpret_cast<bf16*>(prefill_smem);
  bf16* sq = ring + (STAGES - 1) * TILE;  // Q in the last stage
  int* svalid = reinterpret_cast<int*>(ring + STAGES * TILE);
  int* sown = svalid + STAGES * KT;  // SEG: valid positions, ascending
  __shared__ int end_s, n_own_s;
  const int G = Hq / Hkv, QB = RM / G;
  const int i0 = blockIdx.x * QB, h = blockIdx.y, b = blockIdx.z;
  const int nr = min(QB, C - i0) * G;  // real rows r = (i - i0) * G + head
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  constexpr int TK = NT / KT;  // staging: threads a key
  static_assert(NT % KT == 0 && CH % TK == 0, "staging layout");
  const int kj = tid / TK, kc = tid % TK;  // key kj, chunks kc + TK n
  const int window = P * page;
  const int* trow = tables + (size_t)b * P;
  // row r of q and out: q0 + (r / G) * Hq * HD + (r % G) * HD
  const size_t q0 = (((size_t)b * C + i0) * Hq + (size_t)h * G) * HD;
  auto row_off = [&](int r) {
    return q0 + (size_t)(r / G) * Hq * HD + (size_t)(r % G) * HD;
  };

  for (int c = tid; c < RM * CH; c += NT) {
    const int r = c / CH, col = (c - r * CH) * 8;
    mma::cp_async16(sq + r * LD + col, q + (r < nr ? row_off(r) + col : 0),
                    r < nr);
  }
  // the pool page of key kj of pool tile t, clamped into the pool (-1
  // past the table's window); read a tile ahead of its use
  auto pool_page = [&](int t) -> int {
    const int pos = t * KT + kj;
    return pos < window ? min(max(trow[pos / page], 0), N - 1) : -1;
  };
  int pid[STAGES - 1];  // tiles 0 .. STAGES - 2
#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) pid[t] = pool_page(t);
  // this thread's rows g and g + 8: pool keys < rl, chunk keys <= ci
  int rl[2], ci[2];
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int r = g + 8 * u, i = i0 + r / G;
    const bool real = r < nr;
    ci[u] = real ? i : -1;
    rl[u] = !real ? -1 : SEG ? where[(size_t)b * C + i] : 0x7fffffff;
  }

  if (SEG) {
    if (warp == 0)
      seg_scan(where + (size_t)b * C, C, lane, sown, &n_own_s, &end_s);
    __syncthreads();
  }
  const int end = min(max(SEG ? end_s : where[b], 0), window);
  const int n_own = SEG ? n_own_s : 0;
  const int n_pool = (end + KT - 1) / KT;
  const int n_keys = nr / G + i0;  // chunk keys j <= the block's last query
  const int nt = n_pool + (n_keys + KT - 1) / KT;

  // key kj of tile t (pool tiles, then the chunk's) and its valid flag;
  // keys no row reads are zero-filled and flagged 0
  auto stage = [&](int t, int pid) {
    const bf16 *ks = nullptr, *vs = nullptr;
    if (t < n_pool) {
      const int pos = t * KT + kj;
      if (pos < end && !(SEG && own_slot(sown, n_own, pos))) {
        const size_t off = (((size_t)pid * page + pos % page) * Hkv + h) * HD;
        ks = k_pages + off;
        vs = v_pages + off;
      }
    } else {
      const int j = (t - n_pool) * KT + kj;
      if (j < n_keys) {
        const size_t off = (((size_t)b * C + j) * Hkv + h) * HD;
        ks = k_chunk + off;
        vs = v_chunk + off;
      }
    }
    bf16* dst = ring + (t % STAGES) * TILE + kj * LD;
#pragma unroll
    for (int c = kc; c < CH; c += TK) {
      mma::cp_async16(dst + c * 8, ks ? ks + c * 8 : k_pages, ks != nullptr);
      mma::cp_async16(dst + KT * LD + c * 8, vs ? vs + c * 8 : v_pages,
                      vs != nullptr);
    }
    if (kc == 0) svalid[(t % STAGES) * KT + kj] = ks != nullptr;
  };

  // Q and tile 0 in the first group, then one group a tile
#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) {
    if (t < nt) stage(t, pid[t]);
    mma::cp_async_commit();
  }
  int pid_next = STAGES - 1 < n_pool ? pool_page(STAGES - 1) : -1;

  uint32_t qa[HD / 16][4];  // Q as A fragments, rows >= nr zero
  float o[HD / 8][4], m[2], l[2];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  m[0] = m[1] = mma::neg_inf();
  l[0] = l[1] = 0.f;
  mma::cp_async_wait<STAGES - 2>();
  __syncthreads();
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
    mma::ldsm_x4(qa[kk], mma::a_frag_addr(sq, LD, 0, kk * 16, lane));

  const int k0 = warp * 16;  // this warp's keys of a tile
  for (int t = 0; t < nt; ++t) {
    mma::cp_async_wait<STAGES - 2>();
    __syncthreads();  // tile t staged; every warp is done with t - 1
    if (t + STAGES - 1 < nt) stage(t + STAGES - 1, pid_next);
    mma::cp_async_commit();
    pid_next = t + STAGES < n_pool ? pool_page(t + STAGES) : -1;
    const bf16* kt = ring + (t % STAGES) * TILE;
    float s[2][4];
    gqa_tc::warp_scores<HD>(qa, kt, k0, lane, s);
    const int* vf = svalid + (t % STAGES) * KT;
    const bool pool = t < n_pool;
    const int key0 = (pool ? t : t - n_pool) * KT;
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kk = k0 + n * 8 + 2 * tq + (e & 1), key = key0 + kk;
        const int u = e >> 1;
        const bool ok = vf[kk] && (pool ? key < rl[u] : key <= ci[u]);
        s[n][e] = ok ? s[n][e] * scale_log2 : mma::neg_inf();
      }
    gqa_tc::warp_fold<HD>(s, kt + KT * LD, k0, lane, m, l, o);
  }

  gqa_tc::merge_warps<HD>(reinterpret_cast<float*>(ring), m, l, o, nr,
                          [&](int r, int d, float x) {
                            out[row_off(r) + d] = __float2bfloat16(x);
                          });
}

template <bool SEG, int HD>
static int launch_tc(const void* q, const void* kc, const void* vc,
                     const void* kp, const void* vp, const void* tables,
                     const void* where, void* out, int B, int C, int Hq,
                     int Hkv, int N, int page, int P, float scale,
                     cudaStream_t stream) {
  const size_t smem = prefill_tc_smem(HD, C, SEG);
  auto kernel = paged_prefill_tc<SEG, HD>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int QB = gqa_tc::RM / (Hq / Hkv);
  using bf16 = __nv_bfloat16;
  dim3 grid((C + QB - 1) / QB, Hkv, B);
  kernel<<<grid, gqa_tc::NT, smem, stream>>>(
      (const bf16*)q, (const bf16*)kc, (const bf16*)vc, (const bf16*)kp,
      (const bf16*)vp, (const int*)tables, (const int*)where, (bf16*)out, C,
      Hq, Hkv, N, page, P, scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

template <bool SEG>
static int prefill_tc(const void* q, const void* kc, const void* vc,
                      const void* kp, const void* vp, const void* tables,
                      const void* where, void* out, int B, int C, int Hq,
                      int Hkv, int hd, int N, int page, int P, float scale,
                      cudaStream_t st) {
  switch (hd) {
    case 16:
      return launch_tc<SEG, 16>(q, kc, vc, kp, vp, tables, where, out, B, C,
                                Hq, Hkv, N, page, P, scale, st);
    case 32:
      return launch_tc<SEG, 32>(q, kc, vc, kp, vp, tables, where, out, B, C,
                                Hq, Hkv, N, page, P, scale, st);
    case 64:
      return launch_tc<SEG, 64>(q, kc, vc, kp, vp, tables, where, out, B, C,
                                Hq, Hkv, N, page, P, scale, st);
    case 128:
      return launch_tc<SEG, 128>(q, kc, vc, kp, vp, tables, where, out, B,
                                 C, Hq, Hkv, N, page, P, scale, st);
  }
  return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// Hopper body (bf16 q and pool at hd 64 / 128, pages of 16 / 32 / 64)
// ---------------------------------------------------------------------------
// Rank-4 map over q [B, C, Hq, W] bf16 whose box is [QB queries][G heads]
// [64 columns]: the G heads of one KV head for QB queries, in 128-byte
// swizzle, zero past C.  Returns a cudaError_t code.
static int make_q_map(CUtensorMap* map, const void* q, int B, int C, int Hq,
                      int W, int G, int QB) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  if (reinterpret_cast<uintptr_t>(q) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  const cuuint64_t e = sizeof(__nv_bfloat16);
  cuuint64_t dims[4] = {(cuuint64_t)W, (cuuint64_t)Hq, (cuuint64_t)C,
                        (cuuint64_t)B};
  cuuint64_t strides[3] = {W * e, (cuuint64_t)Hq * W * e,
                           (cuuint64_t)C * Hq * W * e};
  cuuint32_t box[4] = {64, (cuuint32_t)G, (cuuint32_t)QB, 1};
  cuuint32_t step[4] = {1, 1, 1, 1};
  CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                  const_cast<void*>(q), dims, strides, box, step,
                  CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

namespace prefill_wg {
constexpr int KT = 64;         // keys a tile
constexpr int RM = 64;         // query rows a block: the warpgroup's wgmma M
constexpr int NT = 160;        // warps 0-3 the consumer warpgroup, 4 the producer
constexpr int MAX_SPLITS = 8;  // splits a plan may have: a portable cluster

// Byte offsets in the block's shared memory (from a 1024-byte boundary):
// Q [HD/64][RM][64], K [STAGES][HD/64][KT][64], V the same, the barriers
// (Q full; full, then empty, a stage), each pool tile's key mask of the
// split [tps] (uint64: bit k, key k may be read by some row), then in
// segment mode the chunk's valid positions [C] (int).  Once the walk is
// over the K / V ring holds the block's partial: o [RM][OS] float32 (OS =
// HD + 8), then (m, l) [RM] float2.
template <int HD>
struct Smem {
  static constexpr int STAGES = HD == 64 ? 4 : 2, OS = HD + 8;
  static constexpr size_t tile = (size_t)KT * HD * 2;  // K or V of a tile
  static constexpr size_t k = (size_t)RM * HD * 2;
  static constexpr size_t v = k + STAGES * tile;
  static constexpr size_t bars = v + STAGES * tile;
  static constexpr size_t masks = bars + (size_t)8 * (1 + 2 * STAGES);
  static constexpr size_t ml = k + (size_t)RM * OS * 4;
  static_assert(ml + RM * 8 <= bars, "the partial fits in the ring");
  __host__ __device__ static size_t own(int tps) {
    return masks + (size_t)tps * 8;
  }
  static size_t bytes(int C, bool seg, int tps) {
    return own(tps) + (seg ? (size_t)C * 4 : 0) + 1024;
  }
};

// A page's box is [page rows][128 bytes] and lands at row p * page of a
// 64-row region: the rows start on the swizzle's 1024-byte period and a
// tile holds whole pages for these sizes.
inline bool page_ok(int page) {
  return page == 16 || page == 32 || page == 64;
}

// The TMA, proxy and cluster helpers shared with the GQA decode's Hopper
// body (hopper_common.cuh).
using hop::at_rank;
using hop::cluster_sync;
using hop::fence_proxy_async;
using hop::ld_cluster2;
using hop::ld_cluster4;
using hop::prefetch_map;
}  // namespace prefill_wg

// Block (query block qb of 64 / G queries, split sp, KV head h + Hkv * row
// b), 160 threads: warp 4 the producer, warps 0-3 the consumer warpgroup.
// The splits of a query block are one cluster (1, splits, 1); block sp is
// its rank sp.
template <bool SEG, int HD>
__global__ void __launch_bounds__(prefill_wg::NT)
    paged_prefill_wg(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tkp,
                     const __grid_constant__ CUtensorMap tvp,
                     const __grid_constant__ CUtensorMap tkc,
                     const __grid_constant__ CUtensorMap tvc,
                     const int* __restrict__ tables,
                     const int* __restrict__ where,  // offsets or positions
                     __nv_bfloat16* __restrict__ out, int C, int Hq, int Hkv,
                     int N, int page, int P, int tps, int pool_splits,
                     float scale_log2) {
  using namespace prefill_wg;
  using L = Smem<HD>;
  using bf16 = __nv_bfloat16;
  constexpr int STAGES = L::STAGES, OS = L::OS;
  extern __shared__ unsigned char prefill_wg_smem[];
  unsigned char* base = hop::align1024(prefill_wg_smem);
  bf16* sq = reinterpret_cast<bf16*>(base);
  bf16* sk = reinterpret_cast<bf16*>(base + L::k);
  bf16* sv = reinterpret_cast<bf16*>(base + L::v);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(base + L::bars);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + STAGES;
  uint64_t* smask = reinterpret_cast<uint64_t*>(base + L::masks);
  int* sown = reinterpret_cast<int*>(base + L::own(tps));
  float* so = reinterpret_cast<float*>(base + L::k);   // after the walk
  float2* sml = reinterpret_cast<float2*>(base + L::ml);
  __shared__ int end_s, n_own_s;

  const int G = Hq / Hkv, QB = RM / G;
  const int qb = blockIdx.x, sp = blockIdx.y, splits = gridDim.y;
  const int h = blockIdx.z % Hkv, b = blockIdx.z / Hkv;
  const int i0 = qb * QB, nq = min(QB, C - i0), nr = nq * G;
  const int n_keys = i0 + nq;  // chunk keys j <= the block's last query
  const int window = P * page, ppt = KT / page;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const bool pool = sp < pool_splits;
  const int t0 = (pool ? sp : sp - pool_splits) * tps;  // the split's tile 0
  const int* trow = tables + (size_t)b * P;
  // row r of q and out: q0 + (r / G) * Hq * HD + (r % G) * HD
  const size_t q0 = (((size_t)b * C + i0) * Hq + (size_t)h * G) * HD;
  auto row_off = [&](int r) {
    return q0 + (size_t)(r / G) * Hq * HD + (size_t)(r % G) * HD;
  };

  int pid = 0;         // producer: lane's table entry of the page batch
  int rl[2], ci[2];    // consumer: rows' pool limits, last chunk keys
  if (warp == 4) {
    // the barriers and Q (a box of [64 / G queries][G heads][64 columns]
    // a region: row r = query * G + head, queries past C zero); the
    // split's tensor maps, its first 32 table entries and the row's end
    // in flight together
    if (lane == 0) {
      hop::mbar_init(q_full, 1);
      for (int s = 0; s < STAGES; ++s) {
        hop::mbar_init(full + s, 1);
        hop::mbar_init(empty + s, 4);  // lane 0 of each consumer warp
      }
      hop::fence_barrier_init();
      hop::mbar_expect_tx(q_full, (uint32_t)G * QB * HD * 2);
#pragma unroll
      for (int c = 0; c < HD / 64; ++c)
        hop::tma_load(sq + c * RM * 64, &tq, q_full, c * 64, h * G, i0, b);
      prefetch_map(pool ? &tkp : &tkc);
      prefetch_map(pool ? &tvp : &tvc);
    }
    if (pool && t0 * ppt + lane < P) pid = trow[t0 * ppt + lane];
    if (SEG)
      seg_scan(where + (size_t)b * C, C, lane, sown, &n_own_s, &end_s);
    else if (lane == 0)
      end_s = where[b];
    // the consumers may read the row's end, the positions and the
    // barriers; the producer goes on to its loads at once
    __syncwarp();
    hop::named_arrive(2, NT);
  } else {
    // this thread's rows 16 warp + lane / 4 (+ 8): pool keys < rl, chunk
    // keys <= ci
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int r = 16 * warp + (lane >> 2) + 8 * u, i = i0 + r / G;
      const bool real = r < nr;
      ci[u] = real ? i : -1;
      rl[u] = !real ? -1 : SEG ? where[(size_t)b * C + i] : INT_MAX;
    }
    hop::named_sync(2, NT);
  }
  const int end = min(max(end_s, 0), window);
  const int n_own = SEG ? n_own_s : 0;
  const int n_pool = (end + KT - 1) / KT;     // pool tiles the row reads
  const int n_chunk = (n_keys + KT - 1) / KT;  // chunk tiles the block reads
  const int nt = min(tps, (pool ? n_pool : n_chunk) - t0);
  const int np_live = (n_pool + tps - 1) / tps;
  const int nc_live = (n_chunk + tps - 1) / tps, n_live = np_live + nc_live;
  // a split that starts past the row's end walks nothing; with one live
  // split its block writes the output and the others leave at once
  // (once their Q has landed), else they stay to share the merge
  if (nt <= 0 && tid == 0) hop::mbar_wait(q_full, 0);
  if (nt <= 0 && n_live == 1) return;

  if (warp == 4) {
    // the producer: every page (or chunk tile) of the split, a stage a
    // tile, reusing a stage once its consumers have released it
    int first = t0 * ppt;  // page of lane 0's entry
    const int p_end = min(P, (end + page - 1) / page);  // pages read
    for (int t = 0; t < nt; ++t) {
      const int s = t % STAGES;
      if (t >= STAGES) hop::mbar_wait(empty + s, (t / STAGES - 1) & 1);
      bf16* kd = sk + s * KT * HD;
      bf16* vd = sv + s * KT * HD;
      if (pool) {
        const int p0 = (t0 + t) * ppt;  // the tile's first page
        if (p0 - first >= 32) {         // the next batch of entries
          first = p0;
          pid = p0 + lane < P ? trow[p0 + lane] : 0;
        }
        const int np = min(ppt, p_end - p0);  // >= 1: p0 * page < end
        if (lane == 0)
          hop::mbar_expect_tx(full + s, (uint32_t)np * page * HD * 2 * 2);
        __syncwarp();
        const int j = lane - (p0 - first);  // this lane's page of the tile
        if (j >= 0 && j < np) {
          const int pg = min(max(pid, 0), N - 1);
#pragma unroll
          for (int c = 0; c < HD / 64; ++c) {
            hop::tma_load(kd + c * KT * 64 + j * page * 64, &tkp, full + s,
                          c * 64, h, 0, pg);
            hop::tma_load(vd + c * KT * 64 + j * page * 64, &tvp, full + s,
                          c * 64, h, 0, pg);
          }
        }
      } else if (lane == 0) {
        hop::mbar_expect_tx(full + s, 2 * hop::tile_bytes<HD, KT>());
        hop::tma_tile<HD, KT>(kd, &tkc, full + s, h, (t0 + t) * KT, b);
        hop::tma_tile<HD, KT>(vd, &tvc, full + s, h, (t0 + t) * KT, b);
      }
    }
  } else if (nt > 0) {
    // while the split's loads are in flight: each pool tile's key mask
    // (bit k: key k may be read by some row -- inside the row's end, not
    // one of the chunk's own slots), a ballot a 32 keys
    if (pool)
      for (int k0 = warp * 32; k0 < nt * KT; k0 += 128) {
        const int pos = t0 * KT + k0 + lane;
        const unsigned bits = __ballot_sync(
            0xffffffffu,
            pos < end && !(SEG && own_slot(sown, n_own, pos)));
        if (lane == 0) reinterpret_cast<unsigned*>(smask)[k0 / 32] = bits;
      }
    hop::named_sync(1, 128);  // the masks
    hop::mbar_wait(q_full, 0);
    float o[HD / 2], m[2], l[2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
    m[0] = m[1] = mma::neg_inf();
    l[0] = l[1] = 0.f;
    for (int t = 0; t < nt; ++t) {
      const int s = t % STAGES;
      const bf16* kt = sk + s * KT * HD;
      bf16* vt = sv + s * KT * HD;
      const int key0 = (t0 + t) * KT;  // pool position or chunk index
      const uint64_t vm = pool ? smask[t] : ~0ull;
      const bool bad = vm != ~0ull;
      hop::mbar_wait(full + s, (t / STAGES) & 1);
      if (bad) {
        // whole pages landed: zero the V rows of the keys no row may read
        if (tid < KT && !(vm >> tid & 1ull)) {
#pragma unroll
          for (int c = 0; c < HD / 64; ++c) {
            uint4* row = reinterpret_cast<uint4*>(vt + c * KT * 64 + tid * 64);
#pragma unroll
            for (int k = 0; k < 8; ++k) row[k] = make_uint4(0u, 0u, 0u, 0u);
          }
          fence_proxy_async();
        }
        hop::named_sync(1, 128);
      }
      float sc[KT / 2];
      hop::wg_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        hop::mma_ss<KT>(sc, hop::desc_k<RM>(sq, 0, kk),
                        hop::desc_k<KT>(kt, 0, kk), kk > 0);
      hop::wg_commit();
      hop::wg_wait<0>();
      hop::fence_regs(sc);
      // the masks: a score no row may take is replaced (never
      // multiplied), so a non-finite key cannot reach the softmax; this
      // thread's keys are 8 j + 2 (lane % 4) + e % 2
      const uint64_t my = vm >> (2 * (lane & 3));
      const int lim[2] = {(pool ? rl[0] : ci[0] + 1) - key0 - 2 * (lane & 3),
                          (pool ? rl[1] : ci[1] + 1) - key0 - 2 * (lane & 3)};
#pragma unroll
      for (int j = 0; j < KT / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kk = 8 * j + (e & 1);
          if (!(my >> kk & 1ull) || kk >= lim[e >> 1])
            sc[4 * j + e] = mma::neg_inf();
        }
      // the online softmax in log2 units, the scale folded into the
      // exponent's FMA: p = 2^(s scale_log2 - m)
      float nbase[2], alpha[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        float mx = mma::neg_inf();
#pragma unroll
        for (int j = 0; j < KT / 8; ++j)
          mx = fmaxf(mx, fmaxf(sc[4 * j + 2 * u], sc[4 * j + 2 * u + 1]));
        mx = fmaxf(m[u], mma::quad_max(mx) * scale_log2);
        const float base_ = mx == mma::neg_inf() ? 0.f : mx;
        alpha[u] = hop::ex2(m[u] - base_);
        m[u] = mx;
        nbase[u] = -base_;
      }
      float sum[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < KT / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sc[4 * j + e] = hop::ex2(fmaf(sc[4 * j + e], scale_log2,
                                        nbase[e >> 1]));
          sum[e >> 1] += sc[4 * j + e];
        }
#pragma unroll
      for (int u = 0; u < 2; ++u) l[u] = l[u] * alpha[u] + sum[u];
#pragma unroll
      for (int j = 0; j < HD / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[4 * j + e] *= alpha[e >> 1];
      uint32_t pa[KT / 16][4];
      hop::acc_to_a<KT>(sc, pa);
      hop::fence_regs(o);
      hop::fence_regs(pa);
      hop::wg_fence();
#pragma unroll
      for (int kk = 0; kk < KT / 16; ++kk)
        hop::mma_rs<HD>(o, pa[kk], hop::desc_mn<KT>(vt, kk));
      hop::wg_commit();
      hop::wg_wait<0>();
      hop::fence_regs(o);
      if (lane == 0) hop::mbar_arrive(empty + s);
    }

    const int row0 = 16 * warp + (lane >> 2);  // and row0 + 8
    const float ls[2] = {mma::quad_sum(l[0]), mma::quad_sum(l[1])};
    if (n_live == 1) {  // one live split: the output itself
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int r = row0 + 8 * u;
        if (r >= nr) continue;
        const float den = fmaxf(ls[u], 1e-30f);
        bf16* orow = out + row_off(r);
#pragma unroll
        for (int j = 0; j < HD / 8; ++j)
          *reinterpret_cast<uint32_t*>(orow + 8 * j + 2 * (lane & 3)) =
              hop::pack_bf16(o[4 * j + 2 * u] / den,
                             o[4 * j + 2 * u + 1] / den);
      }
      return;
    }
    // the partial (unnormalised o, m, l) into the ring, once every
    // consumer's last product has read it
    hop::named_sync(1, 128);
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int r = row0 + 8 * u;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j)
        *reinterpret_cast<float2*>(so + r * OS + 8 * j + 2 * (lane & 3)) =
            make_float2(o[4 * j + 2 * u], o[4 * j + 2 * u + 1]);
      if ((lane & 3) == 0) sml[r] = make_float2(m[u], ls[u]);
    }
  }
  if (n_live == 1) return;  // the producer of the one live split

  // The merge, shared by the cluster: block sp takes rows sp, sp +
  // splits, ..., a thread 8 columns of a row; each row's live splits --
  // pool splits 0 .. np_live - 1, then chunk splits from pool_splits --
  // read from their blocks' shared memory at once and summed in split
  // order: w_s = 2^(m_s - max m), value = sum w_s o_s / max(sum w_s l_s,
  // 1e-30), so a row with no valid key gets zeros.
  cluster_sync();
  auto split = [&](int k) { return k < np_live ? k : pool_splits + k - np_live; };
  const int mine = nr > sp ? (nr - sp + splits - 1) / splits : 0;
  for (int i = tid; i < mine * (HD / 8); i += NT) {
    const int li = i / (HD / 8), d = (i - li * (HD / 8)) * 8;
    const int r = sp + li * splits;
    float2 ml[MAX_SPLITS];
    float4 x[MAX_SPLITS][2];
#pragma unroll
    for (int k = 0; k < MAX_SPLITS; ++k)
      if (k < n_live) {
        const uint32_t src = at_rank(so + r * OS + d, split(k));
        ml[k] = ld_cluster2(at_rank(sml + r, split(k)));
        x[k][0] = ld_cluster4(src);
        x[k][1] = ld_cluster4(src + 16);
      }
    float mx = mma::neg_inf();
#pragma unroll
    for (int k = 0; k < MAX_SPLITS; ++k)
      if (k < n_live) mx = fmaxf(mx, ml[k].x);
    const float mbase = mx == mma::neg_inf() ? 0.f : mx;
    float den = 0.f, acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int k = 0; k < MAX_SPLITS; ++k)
      if (k < n_live) {
        const float w = exp2f(ml[k].x - mbase);
        den += w * ml[k].y;
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          acc[4 * h2] += w * x[k][h2].x;
          acc[4 * h2 + 1] += w * x[k][h2].y;
          acc[4 * h2 + 2] += w * x[k][h2].z;
          acc[4 * h2 + 3] += w * x[k][h2].w;
        }
      }
    den = fmaxf(den, 1e-30f);
    uint4 pk;
    pk.x = hop::pack_bf16(acc[0] / den, acc[1] / den);
    pk.y = hop::pack_bf16(acc[2] / den, acc[3] / den);
    pk.z = hop::pack_bf16(acc[4] / den, acc[5] / den);
    pk.w = hop::pack_bf16(acc[6] / den, acc[7] / den);
    *reinterpret_cast<uint4*>(out + row_off(r) + d) = pk;
  }
  // no block leaves while another still reads its shared memory
  cluster_sync();
}

template <bool SEG, int HD>
static int launch_wg(const void* q, const void* kc, const void* vc,
                     const void* kp, const void* vp, const void* tables,
                     const void* where, void* out, int B, int C, int Hq,
                     int Hkv, int N, int page, int P, int tps,
                     int pool_splits, int splits, float scale,
                     cudaStream_t stream) {
  using namespace prefill_wg;
  const int G = Hq / Hkv, QB = RM / G;
  CUtensorMap tq, tkp, tvp, tkc, tvc;
  int rc = make_q_map(&tq, q, B, C, Hq, HD, G, QB);
  if (rc == 0) rc = make_map(&tkp, kp, N, page, Hkv, HD, page);
  if (rc == 0) rc = make_map(&tvp, vp, N, page, Hkv, HD, page);
  if (rc == 0) rc = make_map(&tkc, kc, B, C, Hkv, HD, KT);
  if (rc == 0) rc = make_map(&tvc, vc, B, C, Hkv, HD, KT);
  if (rc != 0) return rc;
  const size_t smem = Smem<HD>::bytes(C, SEG, tps);
  auto kernel = paged_prefill_wg<SEG, HD>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((C + QB - 1) / QB, splits, Hkv * B);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = splits;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  using bf16 = __nv_bfloat16;
  err = cudaLaunchKernelEx(&cfg, kernel, tq, tkp, tvp, tkc, tvc,
                           (const int*)tables, (const int*)where, (bf16*)out,
                           C, Hq, Hkv, N, page, P, tps, pool_splits,
                           scale * 1.4426950408889634f);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The body `paged_prefill` / `paged_prefill_seg` run: 2, the Hopper body
// (`paged_prefill_wg`: bf16 at hd 64 / 128, G <= 16, pages of 16 / 32 /
// 64); 1, the `mma.sync` body (`paged_prefill_tc`: bf16 at hd 16 - 128,
// G <= 16, any page); 0, the CUDA-core body.
static int body(int Hq, int Hkv, int hd, int page, int q_dtype,
                int kv_dtype) {
  if (q_dtype != 1 || kv_dtype != 1 || !gqa_tc::width_ok(Hq, Hkv, hd))
    return 0;
  return (hd == 64 || hd == 128) && prefill_wg::page_ok(page) ? 2 : 1;
}

template <bool SEG>
static int dispatch(const void* q, const void* kc, const void* vc,
                    const void* kp, const void* vp, const void* tables,
                    const void* where, void* out, int B, int C, int Hq,
                    int Hkv, int hd, int N, int page, int P, int tps,
                    int pool_splits, int splits, float scale, int q_dtype,
                    int kv_dtype, void* stream) {
  if (B == 0 || C == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  switch (body(Hq, Hkv, hd, page, q_dtype, kv_dtype)) {
    case 2: {
      // the plan must cover the window and the chunk in at most a
      // portable cluster of splits
      const long long cover = (long long)tps * prefill_wg::KT;
      if (tps < 1 || pool_splits < 0 || splits > prefill_wg::MAX_SPLITS ||
          pool_splits * cover < (long long)P * page ||
          (splits - pool_splits) * cover < C)
        return (int)cudaErrorInvalidValue;
      if (hd == 64)
        return launch_wg<SEG, 64>(q, kc, vc, kp, vp, tables, where, out, B, C,
                                  Hq, Hkv, N, page, P, tps, pool_splits,
                                  splits, scale, st);
      return launch_wg<SEG, 128>(q, kc, vc, kp, vp, tables, where, out, B, C,
                                 Hq, Hkv, N, page, P, tps, pool_splits,
                                 splits, scale, st);
    }
    case 1:
      return prefill_tc<SEG>(q, kc, vc, kp, vp, tables, where, out, B, C, Hq,
                             Hkv, hd, N, page, P, scale, st);
  }
  if (q_dtype == 1 && kv_dtype == 1)
    return launch<SEG, __nv_bfloat16, __nv_bfloat16>(
        q, kc, vc, kp, vp, tables, where, out, B, C, Hq, Hkv, hd, N, page, P,
        scale, st);
  if (q_dtype == 0 && kv_dtype == 1)
    return launch<SEG, float, __nv_bfloat16>(q, kc, vc, kp, vp, tables,
                                             where, out, B, C, Hq, Hkv, hd,
                                             N, page, P, scale, st);
  if (q_dtype == 0 && kv_dtype == 0)
    return launch<SEG, float, float>(q, kc, vc, kp, vp, tables, where, out,
                                     B, C, Hq, Hkv, hd, N, page, P, scale,
                                     st);
  return (int)cudaErrorInvalidValue;
}

// dtype codes: 0 = float32, 1 = bfloat16.  tps / pool_splits / splits:
// the host's split plan (kernels/paged_prefill.py `prefill_split_plan`),
// read by the Hopper body alone.
extern "C" int paged_prefill(const void* q, const void* k_chunk,
                             const void* v_chunk, const void* k_pages,
                             const void* v_pages, const void* tables,
                             const void* offsets, void* out, int B, int C,
                             int Hq, int Hkv, int hd, int N, int page, int P,
                             int tps, int pool_splits, int splits,
                             float scale, int q_dtype, int kv_dtype,
                             void* stream) {
  return dispatch<false>(q, k_chunk, v_chunk, k_pages, v_pages, tables,
                         offsets, out, B, C, Hq, Hkv, hd, N, page, P, tps,
                         pool_splits, splits, scale, q_dtype, kv_dtype,
                         stream);
}

extern "C" int paged_prefill_seg(const void* q, const void* k_chunk,
                                 const void* v_chunk, const void* k_pages,
                                 const void* v_pages, const void* tables,
                                 const void* chunk_positions, void* out,
                                 int B, int C, int Hq, int Hkv, int hd, int N,
                                 int page, int P, int tps, int pool_splits,
                                 int splits, float scale, int q_dtype,
                                 int kv_dtype, void* stream) {
  return dispatch<true>(q, k_chunk, v_chunk, k_pages, v_pages, tables,
                        chunk_positions, out, B, C, Hq, Hkv, hd, N, page, P,
                        tps, pool_splits, splits, scale, q_dtype, kv_dtype,
                        stream);
}

// The body paged_prefill and paged_prefill_seg run: 2 `wgmma` (`paged_prefill_wg`), 1 `mma.sync`
// (`paged_prefill_tc`), 0 the CUDA cores.
extern "C" int paged_prefill_body(int Hq, int Hkv, int hd, int page,
                                  int q_dtype, int kv_dtype) {
  return body(Hq, Hkv, hd, page, q_dtype, kv_dtype);
}

