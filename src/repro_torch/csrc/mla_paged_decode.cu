// Absorbed-MLA paged decode on Hopper.
//
// Replaces the Pallas TPU kernel `mla_paged_decode`
// (src/repro/kernels/mla_paged_decode.py).  One query per batch row, its
// W_uk-absorbed heads [q_lat ; q_rope], attends the row's latent pool
// tokens < length through its block table:
//   s = (q_lat . c + q_rope . k_rope) * scale,  ctx = softmax(s) @ c,
// with c / k_rope the first dl / last dr columns of each latent row.
//
// Bound on the H100: each attended token costs dk * 2 = 1152 bytes of
// latent (bf16, dl 512 + dr 64) and Hq * (2 * dk + 2 * dl) = 278.5 kFLOP
// at Hq = 128: 242 flops per byte, close to the card's bf16 balance point
// (~295), so on tensor cores bytes and flops bound it about equally.
//
// Three bodies, chosen by type, width and page size in `mla_decode_body`
// below (never a retry after a failure):
//
// * bf16 queries and pool at DeepSeek-V3's widths (dl 512, dr 64) over
//   64-token pages -- the Hopper body (`mla_decode_wg` of mla_wg.cuh: 64
//   heads a block, Q and one 64-token page a tile in shared memory by
//   TMA, `wgmma` for the scores in one consumer warpgroup and for P V in
//   both, 256 value columns each), on the same split plan, partials and
//   combine as the body below.
// * bf16 queries and pool with dl a multiple of 32 up to 512 and dr a
//   multiple of 8, at other widths or pages -- the `mma.sync` body: the
//   chunk prefill's block
//   (`mla_tc_kernel` of mla_tc.cuh, DECODE mode: 64 heads a block, bf16
//   `mma.sync`, 32-key latent tiles in a three-stage `cp.async` ring, one
//   block an SM) with the row's key walk split over blocks, since 56 rows
//   x 2 head groups are 112 blocks for 132 SMs and the longest row would
//   set the time.  Split plan: a fixed number of tokens a split (`split`,
//   chosen by the wrapper from the table window P * page alone, never
//   from the lengths, so the host reads nothing of the device), grid
//   (head groups, ceil(P * page / split), B); a block past its row's
//   length exits at once.  A row of one split writes its context
//   directly; a longer row's splits each write a float32 partial (the
//   unnormalised [64 x dl] accumulator and (m, l) per head: 64 * (dl + 2)
//   * 4 = 131.6 KB a block at dl 512), which `mla_decode_combine` merges
//   in split order (fixed order, no atomics: two calls agree bit for
//   bit) and reads back once: 2 * 131.6 KB of L2 / HBM traffic a split
//   beyond the bytes the bound counts.  The scratch [B, splits, Hq,
//   dl + 2] float32 comes from the wrapper (`torch.empty`).
// * float32 queries (with a float32 or bf16 pool), and bf16 at other
//   widths -- the CUDA-core body (`mla_decode_kernel`): one block per
//   (group of R = 32 heads, row), the row's groups adjacent in the grid
//   so they read the same latent tiles out of L2, float32 FMAs out of
//   shared memory with the accumulator in registers (see mla_common.cuh:
//   at dl = 512 the [Hq, dl] accumulator does not fit one block).  The
//   block walks the row's min(length, P * page) tokens, 32 positions at
//   a time.
//
// All clamp table entries into [0, N-1]; a row of length 0 reads
// nothing and writes zeros.
//
// Layouts: q_lat [B,Hq,dl], q_rope [B,Hq,dr]; latent pages [N,page,dl+dr];
// block tables [B,P] int32; lengths [B] int32; out [B,Hq,dl] in q's type.
// The Hopper body needs 16-byte aligned bases (TMA), which the wrapper
// ensures.
#include "mla_tc.cuh"
#include "mla_wg.cuh"

template <typename TQ, typename TKV, int VPT>
__global__ void __launch_bounds__(mla::NT, 1)
    mla_decode_kernel(const TQ* __restrict__ q_lat,
                      const TQ* __restrict__ q_rope,
                      const TKV* __restrict__ pages,
                      const int* __restrict__ tables,
                      const int* __restrict__ lengths, TQ* __restrict__ out,
                      int Hq, int dl, int dr, int N, int page, int P,
                      float scale) {
  using namespace mla;
  extern __shared__ float4 mla_smem[];
  const int h0 = blockIdx.x * R, b = blockIdx.y;
  const int dk = dl + dr;
  Smem s = carve(reinterpret_cast<float*>(mla_smem), dk);
  load_queries(s, q_lat, q_rope, (size_t)b, h0, Hq, dl, dr);

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

  const int end = min(max(lengths[b], 0), P * page);
  const int* trow = tables + (size_t)b * P;
  for (int start = 0; start < end; start += KT) {
    set_pool_rows(s, trow, start, end, N, page, dk, [](int) { return true; });
    attend_tile<VPT>(s, acc, m_run, l_run, pages, dl, dk, scale);
  }
  finish<VPT>(s, acc, l_run, out, (size_t)b, h0, Hq, dl);
}

template <typename TQ, typename TKV, int VPT>
static int launch(const void* ql, const void* qr, const void* pages,
                  const void* tables, const void* lengths, void* out, int B,
                  int Hq, int dl, int dr, int N, int page, int P, float scale,
                  cudaStream_t stream) {
  const size_t smem = mla::smem_bytes(dl + dr, 0);
  auto kernel = mla_decode_kernel<TQ, TKV, VPT>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Hq + mla::R - 1) / mla::R, B);
  kernel<<<grid, mla::NT, smem, stream>>>(
      (const TQ*)ql, (const TQ*)qr, (const TKV*)pages, (const int*)tables,
      (const int*)lengths, (TQ*)out, Hq, dl, dr, N, page, P, scale);
  return (int)cudaGetLastError();
}

template <typename TQ, typename TKV>
static int by_width(const void* ql, const void* qr, const void* pages,
                    const void* tables, const void* lengths, void* out, int B,
                    int Hq, int dl, int dr, int N, int page, int P,
                    float scale, cudaStream_t st) {
  if (dl <= mla::NT)
    return launch<TQ, TKV, 1>(ql, qr, pages, tables, lengths, out, B, Hq,
                              dl, dr, N, page, P, scale, st);
  if (dl <= 2 * mla::NT)
    return launch<TQ, TKV, 2>(ql, qr, pages, tables, lengths, out, B, Hq,
                              dl, dr, N, page, P, scale, st);
  return (int)cudaErrorInvalidValue;
}

// Merge the split partials of each row of more than one split, in split
// order: out = sum_s w_s o_s / max(sum_s w_s l_s, 1e-30), w_s = exp2(m_s
// - max_s m_s).  Grid (Hq, B), 128 threads, four columns a thread.
__global__ void mla_decode_combine(const float* __restrict__ part,
                                   const int* __restrict__ lengths,
                                   __nv_bfloat16* __restrict__ out, int S,
                                   int Hq, int dl, int window, int split) {
  const int h = blockIdx.x, b = blockIdx.y;
  const int end = min(max(lengths[b], 0), window);
  const int n_split = (end + split - 1) / split;
  if (n_split <= 1) return;  // the split kernel wrote this row
  const size_t slot = (size_t)b * S;
  const float* po = part + (slot * Hq + h) * dl;
  const float* pml = part + (size_t)gridDim.y * S * Hq * dl +
                     (slot * Hq + h) * 2;
  float mx = PAGED_NEG_INF;
  for (int s = 0; s < n_split; ++s) mx = fmaxf(mx, pml[(size_t)s * Hq * 2]);
  float den = 0.f;
  for (int s = 0; s < n_split; ++s) {
    const float2 ml =
        *reinterpret_cast<const float2*>(pml + (size_t)s * Hq * 2);
    den += exp2f(ml.x - mx) * ml.y;
  }
  den = fmaxf(den, 1e-30f);
  for (int d = 4 * threadIdx.x; d < dl; d += 4 * blockDim.x) {
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int s = 0; s < n_split; ++s) {
      const float w = exp2f(pml[(size_t)s * Hq * 2] - mx);
      const float4 v =
          *reinterpret_cast<const float4*>(po + (size_t)s * Hq * dl + d);
      acc.x = fmaf(w, v.x, acc.x);
      acc.y = fmaf(w, v.y, acc.y);
      acc.z = fmaf(w, v.z, acc.z);
      acc.w = fmaf(w, v.w, acc.w);
    }
    __nv_bfloat16* o = out + ((size_t)b * Hq + h) * dl + d;
    *reinterpret_cast<uint32_t*>(o) = mma::pack_bf16(acc.x / den, acc.y / den);
    *reinterpret_cast<uint32_t*>(o + 2) =
        mma::pack_bf16(acc.z / den, acc.w / den);
  }
}

// The body `mla_paged_decode` runs: 2, the Hopper body (`mla_decode_wg`:
// bf16, dl 512, dr 64, 64-token pages); 1, the `mma.sync` body
// (`mla_tc_kernel` DECODE: bf16 at the widths `mla_tc::width_ok` takes);
// 0, the CUDA-core body.
static int mla_decode_body(int dl, int dr, int page, int q_dtype,
                           int kv_dtype) {
  if (q_dtype != 1 || kv_dtype != 1 || !mla_tc::width_ok(dl, dr, 0)) return 0;
  return mla_wg::width_ok(dl, dr, page) ? 2 : 1;
}

// The split walk and its combine: `part` holds B * S * Hq * (dl + 2)
// floats, S = ceil(P * page / split).
static int decode_tc(const void* ql, const void* qr, const void* pages,
                     const void* tables, const void* lengths, void* out,
                     float* part, int B, int Hq, int dl, int dr, int N,
                     int page, int P, float scale, int split,
                     cudaStream_t st) {
  const int window = P * page;
  if (part == nullptr || split <= 0) return (int)cudaErrorInvalidValue;
  const int S = max(1, (window + split - 1) / split);
  int err = mla_decode_body(dl, dr, page, 1, 1) == 2
                ? launch_mla_wg(ql, qr, pages, tables, lengths, out, part, B,
                                S, Hq, dl, dr, N, page, P, scale, split, st)
                : launch_mla_tc_width<mla_tc::DECODE>(
                      ql, qr, nullptr, pages, tables, lengths, out, part, B,
                      1, S, Hq, dl, dr, N, page, P, scale, split, st);
  if (err != 0 || S == 1) return err;
  mla_decode_combine<<<dim3(Hq, B), 128, 0, st>>>(
      part, (const int*)lengths, (__nv_bfloat16*)out, S, Hq, dl, window,
      split);
  return (int)cudaGetLastError();
}

// dtype codes: 0 = float32, 1 = bfloat16.  `part` and `split`: the
// tensor-core body's partials and tokens a split (ignored by the
// CUDA-core body; see mla_paged_decode_tensor_core).
extern "C" int mla_paged_decode(const void* q_lat, const void* q_rope,
                                const void* pages, const void* tables,
                                const void* lengths, void* out, void* part,
                                int B, int Hq, int dl, int dr, int N,
                                int page, int P, float scale, int split,
                                int q_dtype, int kv_dtype, void* stream) {
  if (B == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (q_dtype == 1 && kv_dtype == 1) {
    if (mla_tc::width_ok(dl, dr, 0))
      return decode_tc(q_lat, q_rope, pages, tables, lengths, out,
                       (float*)part, B, Hq, dl, dr, N, page, P, scale, split,
                       st);
    return by_width<__nv_bfloat16, __nv_bfloat16>(
        q_lat, q_rope, pages, tables, lengths, out, B, Hq, dl, dr, N, page,
        P, scale, st);
  }
  if (q_dtype == 0 && kv_dtype == 1)
    return by_width<float, __nv_bfloat16>(q_lat, q_rope, pages, tables,
                                          lengths, out, B, Hq, dl, dr, N,
                                          page, P, scale, st);
  if (q_dtype == 0 && kv_dtype == 0)
    return by_width<float, float>(q_lat, q_rope, pages, tables, lengths, out,
                                  B, Hq, dl, dr, N, page, P, scale, st);
  return (int)cudaErrorInvalidValue;
}

// The body mla_paged_decode runs: 2 `wgmma` (`mla_decode_wg`), 1
// `mma.sync` (`mla_tc_kernel` DECODE), 0 the CUDA cores.
extern "C" int mla_paged_decode_body(int dl, int dr, int page, int q_dtype,
                                     int kv_dtype) {
  return mla_decode_body(dl, dr, page, q_dtype, kv_dtype);
}

// 1 when mla_paged_decode runs a tensor-core body (split walk and
// combine) for these types and widths.
extern "C" int mla_paged_decode_tensor_core(int dl, int dr, int q_dtype,
                                            int kv_dtype) {
  return q_dtype == 1 && kv_dtype == 1 && mla_tc::width_ok(dl, dr, 0);
}
