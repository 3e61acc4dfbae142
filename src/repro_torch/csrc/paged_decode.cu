// Paged decode attention for GQA / MHA / MQA on Hopper, over bf16 or
// float32 pages and over int8 pages with per-token-head scales.
//
// Replaces the Pallas TPU kernels `paged_decode_attention` and
// `paged_decode_attention_int8` (src/repro/kernels/paged_attention.py).
// One query per batch row attends the row's pool tokens < length
// through its block table.
//
// Bound on the H100: HBM bytes.  Each row reads length * Hkv * hd
// elements of K and as many of V, and does 4 * length * Hq * hd flops:
// one flop per byte in bf16, far below the ~295 the card needs before
// the tensor cores limit.  So the design reads every K/V byte once:
// one block per (row, KV head) holds all G = Hq / Hkv query heads of
// the group, so a page of K and V is staged into shared memory once and
// serves the whole group.  The block walks only ceil(length / page)
// pages (table entries clamped into [0, N-1]); the sequential page loop
// replaces the TPU grid's page axis, with the online-softmax state
// (m, l, acc) in shared memory.  A row of length 0 reads nothing and
// writes zeros.
//
// The int8 instantiation is the same body: its pages hold one byte an
// element, half of bf16's (the reason the TPU kernel exists), plus one
// bf16 scale per (token, KV head) for K and for V; each element is
// dequantized as float(int8) * float(scale) while the page is staged.
//
// Layouts: q [B,Hq,hd]; k/v pages [N,page,Hkv,hd]; int8 scales
// [N,page,Hkv,1] bf16; block tables [B,P] int32; lengths [B] int32;
// out [B,Hq,hd] in q's type.
#include "paged_common.cuh"

template <typename TQ, typename TKV, bool SCALED>
__global__ void paged_decode_kernel(const TQ* __restrict__ q,
                                    const TKV* __restrict__ k_pages,
                                    const TKV* __restrict__ v_pages,
                                    const __nv_bfloat16* __restrict__ k_scales,
                                    const __nv_bfloat16* __restrict__ v_scales,
                                    const int* __restrict__ tables,
                                    const int* __restrict__ lengths,
                                    TQ* __restrict__ out, int Hq, int Hkv,
                                    int hd, int N, int page, int P,
                                    float scale) {
  extern __shared__ float smem[];
  const int b = blockIdx.x, h = blockIdx.y;
  const int G = Hq / Hkv, R = G, KT = page;
  Tile t = carve_tile(smem, R, KT, hd);

  const size_t q_base = ((size_t)b * Hq + (size_t)h * G) * hd;
  for (int i = threadIdx.x; i < R * hd; i += blockDim.x)
    t.q[i] = to_f(q[q_base + i]);
  tile_init(t, R, hd);
  __syncthreads();

  const int len = lengths[b];
  const int n_pages = len > 0 ? min(P, (len + page - 1) / page) : 0;
  for (int p = 0; p < n_pages; ++p) {
    const int pid = min(max(tables[(size_t)b * P + p], 0), N - 1);
    const size_t base = (size_t)pid * page * Hkv * hd;
    const auto row_offset = [&](int j) {
      return base + ((size_t)j * Hkv + h) * hd;
    };
    if constexpr (SCALED) {
      const size_t sbase = (size_t)pid * page * Hkv + h;
      tile_load_kv(t, k_pages, v_pages, KT, hd, KT, row_offset, [&](int j) {
        const size_t s = sbase + (size_t)j * Hkv;
        return make_float2(to_f(k_scales[s]), to_f(v_scales[s]));
      });
    } else {
      tile_load_kv(t, k_pages, v_pages, KT, hd, KT, row_offset);
    }
    const int start = p * page;
    tile_scores(t, R, KT, hd, scale,
                [&](int, int j) { return start + j < len; });
    tile_update(t, R, KT, hd);
  }

  for (int i = threadIdx.x; i < R * hd; i += blockDim.x) {
    const int r = i / hd;
    out[q_base + i] = from_f<TQ>(t.acc[i] / fmaxf(t.l[r], 1e-30f));
  }
}

template <typename TQ, typename TKV, bool SCALED>
static int launch(const void* q, const void* kp, const void* vp,
                  const void* ks, const void* vs, const void* tables,
                  const void* lengths, void* out, int B, int Hq, int Hkv,
                  int hd, int N, int page, int P, float scale,
                  cudaStream_t stream) {
  const int R = Hq / Hkv;
  const size_t smem = tile_floats(R, page, hd) * sizeof(float);
  auto kernel = paged_decode_kernel<TQ, TKV, SCALED>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B, Hkv);
  kernel<<<grid, 256, smem, stream>>>(
      (const TQ*)q, (const TKV*)kp, (const TKV*)vp,
      (const __nv_bfloat16*)ks, (const __nv_bfloat16*)vs, (const int*)tables,
      (const int*)lengths, (TQ*)out, Hq, Hkv, hd, N, page, P, scale);
  return (int)cudaGetLastError();
}

// dtype codes: 0 = float32, 1 = bfloat16.
extern "C" int paged_decode(const void* q, const void* k_pages,
                            const void* v_pages, const void* tables,
                            const void* lengths, void* out, int B, int Hq,
                            int Hkv, int hd, int N, int page, int P,
                            float scale, int q_dtype, int kv_dtype,
                            void* stream) {
  if (B == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (q_dtype == 1 && kv_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16, false>(
        q, k_pages, v_pages, nullptr, nullptr, tables, lengths, out, B, Hq,
        Hkv, hd, N, page, P, scale, st);
  if (q_dtype == 0 && kv_dtype == 1)
    return launch<float, __nv_bfloat16, false>(
        q, k_pages, v_pages, nullptr, nullptr, tables, lengths, out, B, Hq,
        Hkv, hd, N, page, P, scale, st);
  if (q_dtype == 0 && kv_dtype == 0)
    return launch<float, float, false>(q, k_pages, v_pages, nullptr, nullptr,
                                       tables, lengths, out, B, Hq, Hkv, hd,
                                       N, page, P, scale, st);
  return (int)cudaErrorInvalidValue;
}

// int8 pages, bf16 scales; q_dtype as above.
extern "C" int paged_decode_int8(const void* q, const void* k_pages,
                                 const void* v_pages, const void* k_scales,
                                 const void* v_scales, const void* tables,
                                 const void* lengths, void* out, int B,
                                 int Hq, int Hkv, int hd, int N, int page,
                                 int P, float scale, int q_dtype,
                                 void* stream) {
  if (B == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (q_dtype == 1)
    return launch<__nv_bfloat16, int8_t, true>(
        q, k_pages, v_pages, k_scales, v_scales, tables, lengths, out, B, Hq,
        Hkv, hd, N, page, P, scale, st);
  if (q_dtype == 0)
    return launch<float, int8_t, true>(q, k_pages, v_pages, k_scales,
                                       v_scales, tables, lengths, out, B, Hq,
                                       Hkv, hd, N, page, P, scale, st);
  return (int)cudaErrorInvalidValue;
}
