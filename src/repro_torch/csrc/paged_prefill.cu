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
//             variants run the same arithmetic and agree bit for bit.
//
// Bound on the H100: at C = 64 the chunk does 4 * C * T * Hq * hd flops
// over T resident tokens while reading T * Hkv * hd * 2 elements of K/V:
// C * Hq / Hkv flops per element, below the card's balance point, so the
// pool bytes bound it.  One block per (row, KV head, tile of queries)
// keeps the tile's G = Hq / Hkv heads together, so each staged page
// serves every head of the group; the page walk is a loop inside the
// block (the TPU's sequential grid axis), with the online-softmax state
// in shared memory and float32 throughout.
//
// Layouts: q [B,C,Hq,hd]; k/v chunk [B,C,Hkv,hd] (q's type); k/v pages
// [N,page,Hkv,hd]; tables [B,P] int32; offsets [B] or chunk_positions
// [B,C] int32; out [B,C,Hq,hd] in q's type.
#include "paged_common.cuh"

// Start of the trailing contiguous run of valid positions (0 when the
// row has none): `_pool_limits` of the JAX package, one row.
__device__ inline int row_pool_limit(const int* cp, int C) {
  int last = -1;
  for (int i = C - 1; i >= 0; --i)
    if (cp[i] >= 0) {
      last = i;
      break;
    }
  if (last < 0) return 0;
  const int d = cp[last] - last;
  int lim = cp[last];
  for (int i = last; i >= 0 && cp[i] >= 0 && cp[i] - i == d; --i)
    lim = cp[i];
  return lim;
}

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

template <bool SEG>
static int dispatch(const void* q, const void* kc, const void* vc,
                    const void* kp, const void* vp, const void* tables,
                    const void* where, void* out, int B, int C, int Hq,
                    int Hkv, int hd, int N, int page, int P, float scale,
                    int q_dtype, int kv_dtype, void* stream) {
  if (B == 0 || C == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
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
