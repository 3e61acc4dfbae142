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
// Three bodies, chosen by type, width and page size in `prefill_body`
// below (never a retry after a failure):
//
// * bf16 queries and pool at DeepSeek-V3's widths (dl 512, dr 64) over
//   64-token pages -- the Hopper body (`mla_prefill_wg` of
//   mla_prefill_wg.cuh, the MLA decode's `wgmma` block of mla_wg.cuh):
//   64 heads of one query a block, Q, each pool page and each 64 rows of
//   the chunk's latent by TMA, a 64-bit key mask a tile, `wgmma` for the
//   scores in one warpgroup and for P V in both, one block an SM; any C.
// * bf16 queries and pool with dl a multiple of 32 up to 512 and dr a
//   multiple of 8, at other widths or pages -- the `mma.sync` body
//   (`mla_tc_kernel` in mla_tc.cuh, PREFILL / SEGMENT modes; the split
//   decode of mla_paged_decode.cu is the same template): one block owns
//   R = 64 heads of one query, bf16 `mma.sync` over 32-key latent tiles
//   staged by `cp.async` into a three-stage ring, one block an SM.
// * float32 queries (with a float32 or bf16 pool), and bf16 at other
//   widths -- the CUDA-core body (`mla_prefill_kernel`): one block per
//   (32 heads, query), float32 FMAs out of shared memory with the
//   accumulator in registers (see mla_common.cuh).
//
// Layouts: q_lat [B,C,Hq,dl], q_rope [B,C,Hq,dr]; lat_chunk [B,C,dl+dr]
// (q's type); latent pages [N,page,dl+dr]; tables [B,P] int32; offsets
// [B] or chunk_positions [B,C] int32; out [B,C,Hq,dl] in q's type.  The
// Hopper body needs 16-byte aligned bases (TMA), which the wrapper
// ensures.
#include "mla_prefill_wg.cuh"
#include "mla_tc.cuh"

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
// dispatch by type, width and page size
// ---------------------------------------------------------------------------
// The body the entries run: 2, the Hopper body (`mla_prefill_wg`: bf16,
// dl 512, dr 64, 64-token pages); 1, the `mma.sync` body (`mla_tc_kernel`:
// bf16 at the widths `mla_tc::width_ok` takes for n_cp chunk positions, 0
// for the offset entry); 0, the CUDA-core body.
static int prefill_body(int dl, int dr, int n_cp, int page, int q_dtype,
                        int kv_dtype) {
  if (q_dtype != 1 || kv_dtype != 1) return 0;
  if (mla_wg::width_ok(dl, dr, page)) return 2;
  return mla_tc::width_ok(dl, dr, n_cp) ? 1 : 0;
}

template <bool SEG>
static int dispatch(const void* ql, const void* qr, const void* lc,
                    const void* pages, const void* tables, const void* where,
                    void* out, int B, int C, int Hq, int dl, int dr, int N,
                    int page, int P, float scale, int longest_first,
                    int q_dtype, int kv_dtype, void* stream) {
  if (B == 0 || C == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const int body = prefill_body(dl, dr, SEG ? C : 0, page, q_dtype, kv_dtype);
  if (body == 2)
    return launch_mla_prefill_wg<SEG>(ql, qr, lc, pages, tables, where, out,
                                      B, C, Hq, dl, dr, N, page, P, scale,
                                      longest_first, st);
  if (q_dtype == 1 && kv_dtype == 1) {
    if (body == 1)
      return launch_mla_tc_width<SEG ? mla_tc::SEGMENT : mla_tc::PREFILL>(
          ql, qr, lc, pages, tables, where, out, nullptr, B, C, C, Hq, dl,
          dr, N, page, P, scale, 0, st);
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

// dtype codes: 0 = float32, 1 = bfloat16.  `longest_first` (the Hopper
// body's launch order): 1 query C - 1 first, 0 query 0 first, < 0 chosen
// by shape (longest first where the grid is more than one wave).
extern "C" int mla_paged_prefill(const void* q_lat, const void* q_rope,
                                 const void* lat_chunk, const void* pages,
                                 const void* tables, const void* offsets,
                                 void* out, int B, int C, int Hq, int dl,
                                 int dr, int N, int page, int P, float scale,
                                 int longest_first, int q_dtype,
                                 int kv_dtype, void* stream) {
  return dispatch<false>(q_lat, q_rope, lat_chunk, pages, tables, offsets,
                         out, B, C, Hq, dl, dr, N, page, P, scale,
                         longest_first, q_dtype, kv_dtype, stream);
}

extern "C" int mla_paged_prefill_seg(const void* q_lat, const void* q_rope,
                                     const void* lat_chunk,
                                     const void* pages, const void* tables,
                                     const void* chunk_positions, void* out,
                                     int B, int C, int Hq, int dl, int dr,
                                     int N, int page, int P, float scale,
                                     int longest_first, int q_dtype,
                                     int kv_dtype, void* stream) {
  return dispatch<true>(q_lat, q_rope, lat_chunk, pages, tables,
                        chunk_positions, out, B, C, Hq, dl, dr, N, page, P,
                        scale, longest_first, q_dtype, kv_dtype, stream);
}

// The body the entries above run for these widths, page size and types
// (n_cp: the chunk length of a segment call, 0 for the offset one): 2
// `wgmma` (`mla_prefill_wg`), 1 `mma.sync` (`mla_tc_kernel`), 0 the CUDA
// cores.
extern "C" int mla_paged_prefill_tensor_core(int dl, int dr, int n_cp,
                                             int page, int q_dtype,
                                             int kv_dtype) {
  return prefill_body(dl, dr, n_cp, page, q_dtype, kv_dtype);
}
