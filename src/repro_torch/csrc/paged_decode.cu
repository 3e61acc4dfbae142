// Paged decode attention for GQA / MHA / MQA on Hopper.
//
// Replaces the Pallas TPU kernel `paged_decode_attention`
// (src/repro/kernels/paged_attention.py).  One query per batch row
// attends the row's pool tokens < length through its block table.
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
// Layouts: q [B,Hq,hd]; k/v pages [N,page,Hkv,hd]; block tables [B,P]
// int32; lengths [B] int32; out [B,Hq,hd] in q's type.
#include "paged_common.cuh"

template <typename TQ, typename TKV>
__global__ void paged_decode_kernel(const TQ* __restrict__ q,
                                    const TKV* __restrict__ k_pages,
                                    const TKV* __restrict__ v_pages,
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
    tile_load_kv(t, k_pages, v_pages, KT, hd, KT, [&](int j) {
      return base + ((size_t)j * Hkv + h) * hd;
    });
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

template <typename TQ, typename TKV>
static int launch(const void* q, const void* kp, const void* vp,
                  const void* tables, const void* lengths, void* out, int B,
                  int Hq, int Hkv, int hd, int N, int page, int P,
                  float scale, cudaStream_t stream) {
  const int R = Hq / Hkv;
  const size_t smem = tile_floats(R, page, hd) * sizeof(float);
  auto kernel = paged_decode_kernel<TQ, TKV>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B, Hkv);
  kernel<<<grid, 256, smem, stream>>>(
      (const TQ*)q, (const TKV*)kp, (const TKV*)vp, (const int*)tables,
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
    return launch<__nv_bfloat16, __nv_bfloat16>(
        q, k_pages, v_pages, tables, lengths, out, B, Hq, Hkv, hd, N, page,
        P, scale, st);
  if (q_dtype == 0 && kv_dtype == 1)
    return launch<float, __nv_bfloat16>(q, k_pages, v_pages, tables,
                                        lengths, out, B, Hq, Hkv, hd, N,
                                        page, P, scale, st);
  if (q_dtype == 0 && kv_dtype == 0)
    return launch<float, float>(q, k_pages, v_pages, tables, lengths, out, B,
                                Hq, Hkv, hd, N, page, P, scale, st);
  return (int)cudaErrorInvalidValue;
}
