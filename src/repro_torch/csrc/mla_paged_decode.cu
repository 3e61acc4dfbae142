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
// (~295), so on tensor cores bytes and flops bound it about equally.  This
// first kernel computes on CUDA-core float32 FMAs (67 TFLOP/s peak), so
// it is bound by operations, far above the byte bound; tensor cores are
// later work.  At dl = 512 the accumulator [Hq, dl] (256 KB of float32)
// does not fit one block, so the heads are split: one block per (group of
// R = 32 heads, row), the row's groups adjacent in the grid so they read
// the same latent tiles out of L2.  The block walks only the row's
// min(length, P * page) tokens, 32 positions at a time (table entries
// clamped into the pool); a row of length 0 reads nothing and writes
// zeros.  See mla_common.cuh for the block's work.
//
// Layouts: q_lat [B,Hq,dl], q_rope [B,Hq,dr]; latent pages [N,page,dl+dr];
// block tables [B,P] int32; lengths [B] int32; out [B,Hq,dl] in q's type.
#include "mla_common.cuh"

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

// dtype codes: 0 = float32, 1 = bfloat16.
extern "C" int mla_paged_decode(const void* q_lat, const void* q_rope,
                                const void* pages, const void* tables,
                                const void* lengths, void* out, int B, int Hq,
                                int dl, int dr, int N, int page, int P,
                                float scale, int q_dtype, int kv_dtype,
                                void* stream) {
  if (B == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (q_dtype == 1 && kv_dtype == 1)
    return by_width<__nv_bfloat16, __nv_bfloat16>(
        q_lat, q_rope, pages, tables, lengths, out, B, Hq, dl, dr, N, page,
        P, scale, st);
  if (q_dtype == 0 && kv_dtype == 1)
    return by_width<float, __nv_bfloat16>(q_lat, q_rope, pages, tables,
                                          lengths, out, B, Hq, dl, dr, N,
                                          page, P, scale, st);
  if (q_dtype == 0 && kv_dtype == 0)
    return by_width<float, float>(q_lat, q_rope, pages, tables, lengths, out,
                                  B, Hq, dl, dr, N, page, P, scale, st);
  return (int)cudaErrorInvalidValue;
}
