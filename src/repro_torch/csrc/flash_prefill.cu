// Causal flash attention over one dense sequence (monolithic prefill) for
// GQA / MHA / MQA on Hopper.
//
// Replaces the Pallas TPU kernel `flash_prefill`
// (src/repro/kernels/flash_prefill.py), which computes
// `models/attention.causal_attention` with no query offset: query i of a
// sequence of S tokens attends keys j <= i, and query head h reads KV
// head h / (Hq / Hkv).
//
// Bound on the H100: at the serving path's prompt lengths (a few hundred
// tokens) the bytes.  A sequence does 4 * S(S+1)/2 * Hq * hd flops over
// (2 * S * Hq + 2 * S * Hkv) * hd elements moved: about 0.4 * S flops per
// bf16 byte at Hq = 32, Hkv = 8, so the card's ~295 is crossed only near
// S = 740.  This first kernel computes on CUDA-core float32 FMAs out of
// shared memory (tensor cores are later work).
//
// Design: one block per (query tile of QT rows, query head, sequence).
// The block keeps the online-softmax state (m, l, acc) of its rows in
// shared memory and walks key tiles of KT keys from 0 up to the tile
// holding its last row's diagonal, in order (the loop replaces the TPU
// grid's sequential key axis); tiles above the diagonal are never read.
// A ragged last tile (S not a multiple of QT) masks rows and keys >= S,
// so any S is handled; the Pallas kernel computes S / block_q tiles and
// leaves the rows of a partial tile unwritten.
//
// Layouts: q [B,S,Hq,hd]; k/v [B,S,Hkv,hd]; out [B,S,Hq,hd]; one type
// for all four (float32 or bfloat16); float32 arithmetic throughout.
#include "paged_common.cuh"

template <typename T>
__global__ void flash_prefill_kernel(const T* __restrict__ q,
                                     const T* __restrict__ k,
                                     const T* __restrict__ v,
                                     T* __restrict__ out, int S, int Hq,
                                     int Hkv, int hd, int QT, int KT,
                                     float scale) {
  extern __shared__ float smem[];
  const int i0 = blockIdx.x * QT, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int nq = min(QT, S - i0);
  Tile t = carve_tile(smem, QT, KT, hd);

  for (int i = threadIdx.x; i < QT * hd; i += blockDim.x) {
    const int r = i / hd, d = i - (i / hd) * hd;
    t.q[i] = r < nq ? to_f(q[(((size_t)b * S + i0 + r) * Hq + h) * hd + d])
                    : 0.f;
  }
  tile_init(t, QT, hd);
  __syncthreads();

  // key tiles up to the one holding the last row's diagonal
  const int last = i0 + nq - 1;
  for (int j0 = 0; j0 <= last; j0 += KT) {
    const int rows = min(KT, S - j0);
    tile_load_kv(t, k, v, KT, hd, rows, [&](int j) {
      return (((size_t)b * S + j0 + j) * Hkv + hk) * hd;
    });
    tile_scores(t, QT, KT, hd, scale, [&](int r, int j) {
      return r < nq && j0 + j <= i0 + r;
    });
    tile_update(t, QT, KT, hd);
  }

  for (int i = threadIdx.x; i < nq * hd; i += blockDim.x) {
    const int r = i / hd, d = i - (i / hd) * hd;
    out[(((size_t)b * S + i0 + r) * Hq + h) * hd + d] =
        from_f<T>(t.acc[i] / fmaxf(t.l[r], 1e-30f));
  }
}

template <typename T>
static int launch(const void* q, const void* k, const void* v, void* out,
                  int B, int S, int Hq, int Hkv, int hd, float scale,
                  cudaStream_t stream) {
  // 64 x 64 tiles up to hd 128 (148 KB of shared memory), 32 x 32 above
  const int QT = hd <= 128 ? 64 : 32, KT = QT;
  const size_t smem = tile_floats(QT, KT, hd) * sizeof(float);
  auto kernel = flash_prefill_kernel<T>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((S + QT - 1) / QT, Hq, B);
  kernel<<<grid, 256, smem, stream>>>((const T*)q, (const T*)k, (const T*)v,
                                      (T*)out, S, Hq, Hkv, hd, QT, KT, scale);
  return (int)cudaGetLastError();
}

// dtype codes: 0 = float32, 1 = bfloat16.
extern "C" int flash_prefill(const void* q, const void* k, const void* v,
                             void* out, int B, int S, int Hq, int Hkv, int hd,
                             float scale, int dtype, void* stream) {
  if (B == 0 || S == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, out, B, S, Hq, Hkv, hd, scale, st);
  if (dtype == 0)
    return launch<float>(q, k, v, out, B, S, Hq, Hkv, hd, scale, st);
  return (int)cudaErrorInvalidValue;
}
