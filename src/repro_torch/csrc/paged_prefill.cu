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
// a microsecond, and what sets the time is the latency of a short
// serial walk of key tiles: a block can only score tile t once it has
// landed, and the chunk has few (row, KV head) pairs to spread.
//
// Two bodies, chosen by type and width in `dispatch` below (never a
// retry after a failure):
//
// * bf16 q and pool, hd 16 / 32 / 64 / 128 and G = Hq / Hkv <= 16 -- the
//   tensor-core body (`paged_prefill_tc`), on the block layout of
//   gqa_tc.cuh that the GQA decode shares.  One block per (16 / G
//   queries, KV head, row): its 16 rows (r = query * G + head) share every
//   staged key tile, and at the main path's shape (C 64, G 4) the 128
//   blocks fill the card in one wave.  The block walks its pool tiles of
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
// [B,C] int32; out [B,C,Hq,hd] in q's type.
#include "gqa_tc.cuh"
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
    // warp 0: compact the valid positions in order, then the pool limit
    // (`row_pool_limit`): with `last` the last valid index and d = cp[last]
    // - last, the trailing run starts one past the last index <= last
    // with cp[c] < 0 or cp[c] - c != d
    if (warp == 0) {
      const int* cp = where + (size_t)b * C;
      int n = 0, last = -1, last_pos = 0;
      for (int c0 = 0; c0 < C; c0 += 32) {
        const int x = c0 + lane < C ? cp[c0 + lane] : -1;
        const unsigned vm = __ballot_sync(0xffffffffu, x >= 0);
        if (x >= 0) sown[n + __popc(vm & ((1u << lane) - 1u))] = x;
        n += __popc(vm);
        if (vm) {
          const int hi = 31 - __clz(vm);
          last = c0 + hi;
          last_pos = __shfl_sync(0xffffffffu, x, hi);
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
        n_own_s = n;
        end_s = last < 0 ? 0 : d + brk + 1;
      }
    }
    __syncthreads();
  }
  const int end = min(max(SEG ? end_s : where[b], 0), window);
  const int n_own = SEG ? n_own_s : 0;
  const int n_pool = (end + KT - 1) / KT;
  const int n_keys = nr / G + i0;  // chunk keys j <= the block's last query
  const int nt = n_pool + (n_keys + KT - 1) / KT;

  // is pool position pos one of the chunk's own slots?
  auto own = [&](int pos) {
    int lo = 0, hi = n_own;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (sown[mid] < pos)
        lo = mid + 1;
      else
        hi = mid;
    }
    return lo < n_own && sown[lo] == pos;
  };
  // key kj of tile t (pool tiles, then the chunk's) and its valid flag;
  // keys no row reads are zero-filled and flagged 0
  auto stage = [&](int t, int pid) {
    const bf16 *ks = nullptr, *vs = nullptr;
    if (t < n_pool) {
      const int pos = t * KT + kj;
      if (pos < end && !(SEG && own(pos))) {
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

template <bool SEG>
static int dispatch(const void* q, const void* kc, const void* vc,
                    const void* kp, const void* vp, const void* tables,
                    const void* where, void* out, int B, int C, int Hq,
                    int Hkv, int hd, int N, int page, int P, float scale,
                    int q_dtype, int kv_dtype, void* stream) {
  if (B == 0 || C == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (q_dtype == 1 && kv_dtype == 1) {
    if (gqa_tc::width_ok(Hq, Hkv, hd))
      return prefill_tc<SEG>(q, kc, vc, kp, vp, tables, where, out, B, C, Hq,
                             Hkv, hd, N, page, P, scale, st);
    return launch<SEG, __nv_bfloat16, __nv_bfloat16>(
        q, kc, vc, kp, vp, tables, where, out, B, C, Hq, Hkv, hd, N, page, P,
        scale, st);
  }
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

// dtype codes: 0 = float32, 1 = bfloat16.
extern "C" int paged_prefill(const void* q, const void* k_chunk,
                             const void* v_chunk, const void* k_pages,
                             const void* v_pages, const void* tables,
                             const void* offsets, void* out, int B, int C,
                             int Hq, int Hkv, int hd, int N, int page, int P,
                             float scale, int q_dtype, int kv_dtype,
                             void* stream) {
  return dispatch<false>(q, k_chunk, v_chunk, k_pages, v_pages, tables,
                         offsets, out, B, C, Hq, Hkv, hd, N, page, P, scale,
                         q_dtype, kv_dtype, stream);
}

extern "C" int paged_prefill_seg(const void* q, const void* k_chunk,
                                 const void* v_chunk, const void* k_pages,
                                 const void* v_pages, const void* tables,
                                 const void* chunk_positions, void* out,
                                 int B, int C, int Hq, int Hkv, int hd, int N,
                                 int page, int P, float scale, int q_dtype,
                                 int kv_dtype, void* stream) {
  return dispatch<true>(q, k_chunk, v_chunk, k_pages, v_pages, tables,
                        chunk_positions, out, B, C, Hq, Hkv, hd, N, page, P,
                        scale, q_dtype, kv_dtype, stream);
}

// 1 when paged_prefill and paged_prefill_seg run the tensor-core body
// (bf16 mma.sync) for these types and widths.
extern "C" int paged_prefill_tensor_core(int Hq, int Hkv, int hd,
                                         int q_dtype, int kv_dtype) {
  return q_dtype == 1 && kv_dtype == 1 && gqa_tc::width_ok(Hq, Hkv, hd);
}
