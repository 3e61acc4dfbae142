// Tensor-core pieces of the GQA paged kernels on Hopper (bf16 queries and
// pool), shared by the paged decode body (`paged_decode_tc`,
// paged_decode.cu) and the chunk / segment prefill body
// (`paged_prefill_tc`, paged_prefill.cu).
//
// Block layout: 4 warps and RM = 16 query rows that all read one KV head
// (decode: the G = Hq / Hkv heads of one query; prefill: 16 / G queries
// of G heads; rows past them are zero).  Key tiles of KT = 64 positions
// arrive as bf16 by 16-byte `cp.async` into a ring of three stages of
// [K tile; V tile] with rows of (hd + 8) bf16 (conflict-free `ldmatrix`,
// mma_common.cuh).  Warp w takes keys 16w .. 16w+15 of every tile and
// keeps its own online-softmax state (m, l, o) in registers: scores and
// P V on `mma.sync.m16n8k16` bf16 with float32 fragments, P rounded to
// bf16 in registers as the A operand, V read by `ldmatrix.trans`.  The
// four states are merged once at the end, in warp order, through shared
// memory.
//
// The int8 paged decode (`paged_decode_int8_tc`, paged_decode.cu) runs
// the same tile code on bf16 copies of its int8 tiles, with its value
// scales put into P through `warp_fold`'s hook.
#pragma once

#include "mma_common.cuh"

namespace gqa_tc {
constexpr int NT = 128;     // threads: 4 warps
constexpr int KT = 64;      // key positions a tile, 16 a warp
constexpr int STAGES = 3;   // tiles: one scored, two in flight
constexpr int RM = 16;      // query rows of the mma tile

// Three stages of [K tile; V tile], [2 * KT][hd + 8] bf16 each.
inline size_t ring_bytes(int hd) {
  return (size_t)STAGES * 2 * KT * (hd + 8) * 2;
}

// The tensor-core bodies take hd 16 / 32 / 64 / 128 and at most RM query
// heads a KV head.
inline bool width_ok(int Hq, int Hkv, int hd) {
  return Hkv > 0 && Hq % Hkv == 0 && Hq / Hkv <= RM &&
         (hd == 16 || hd == 32 || hd == 64 || hd == 128);
}

// Scores of this warp's keys k0 .. k0+15 of the staged key tile `kt`:
// s[n] holds keys k0 + 8n .. k0 + 8n + 7 (float32, unscaled).
template <int HD>
__device__ __forceinline__ void warp_scores(const uint32_t (&qa)[HD / 16][4],
                                            const __nv_bfloat16* kt, int k0,
                                            int lane, float (&s)[2][4]) {
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    uint32_t bk[4];
    mma::ldsm_x4(bk, mma::bk_frag_addr(kt, HD + 8, k0, kk * 16, lane));
    mma::mma_bf16(s[0], qa[kk], bk[0], bk[1]);
    mma::mma_bf16(s[1], qa[kk], bk[2], bk[3]);
  }
}

// The identity hook of `warp_fold`: bf16 pools carry no value scale.
struct NoProbScale {
  __device__ __forceinline__ void operator()(float (&)[2][4]) const {}
};

// Fold the warp's masked scores (log2 units, masked keys -inf) into its
// state: online softmax, then o = o * alpha + P V over keys k0 .. k0+15
// of the staged value tile `vt`.  `prob_scale(p)` runs on the
// probabilities after the softmax update (l already holds their
// unscaled sum) and before they are rounded to bf16 as the A operand:
// the int8 decode folds each key's value scale into P there.  The
// default hook does nothing, so the bf16 kernels compile as without it.
template <int HD, typename ProbScale = NoProbScale>
__device__ __forceinline__ void warp_fold(float (&s)[2][4],
                                          const __nv_bfloat16* vt, int k0,
                                          int lane, float (&m)[2],
                                          float (&l)[2],
                                          float (&o)[HD / 8][4],
                                          ProbScale prob_scale = ProbScale()) {
  float alpha[2];
  mma::softmax_update<2>(s, m, l, alpha);
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] *= alpha[e >> 1];
  prob_scale(s);
  uint32_t pa[4];
  mma::probs_to_a<2>(s, 0, pa);
#pragma unroll
  for (int np = 0; np < HD / 16; ++np) {
    uint32_t bv[4];
    mma::ldsm_x4_trans(bv, mma::bv_frag_addr(vt, HD + 8, k0, np * 16, lane));
    mma::mma_bf16(o[2 * np], pa, bv[0], bv[1]);
    mma::mma_bf16(o[2 * np + 1], pa, bv[2], bv[3]);
  }
}

// Merge the NW = NT / 32 warps' states in warp order through `scratch`
// (float32: m [NW][RM], l [NW][RM], o [NW][RM][HD], which the ring holds
// once every copy has landed): w_w = 2^(m_w - max m), value = sum w_w
// o_w / max(sum w_w l_w, 1e-30), so a row with no valid key gets zeros.
// store(r, d, value) for rows r < rows.  A non-null `lse` receives row
// r's log-sum-exp at lse[r], once a row, in natural-log units: (max m +
// log2(sum w_w l_w)) ln 2 (m is in log2 units), NEG_INF = -1e30 for a
// row with no valid key (never -inf or NaN, so a merge of slices by
// their log-sum-exps gives such a slice zero weight).
template <int HD, typename Store>
__device__ __forceinline__ void merge_warps(float* scratch,
                                            const float (&m)[2],
                                            const float (&l)[2],
                                            const float (&o)[HD / 8][4],
                                            int rows, Store store,
                                            float* lse = nullptr) {
  constexpr int NW = NT / 32;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  mma::cp_async_wait<0>();
  __syncthreads();
  float* cm = scratch;
  float* cl = cm + NW * RM;
  float* co = cl + NW * RM;
  const float lsum[2] = {mma::quad_sum(l[0]), mma::quad_sum(l[1])};
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int r = g + 8 * u;
    if (tq == 0) {
      cm[warp * RM + r] = m[u];
      cl[warp * RM + r] = lsum[u];
    }
    float* orow = co + (warp * RM + r) * HD + 2 * tq;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
      *reinterpret_cast<float2*>(orow + n * 8) =
          make_float2(o[n][2 * u], o[n][2 * u + 1]);
  }
  __syncthreads();
  for (int i = tid; i < rows * HD; i += NT) {
    const int r = i / HD, d = i - r * HD;
    float mx = cm[r];
#pragma unroll
    for (int w = 1; w < NW; ++w) mx = fmaxf(mx, cm[w * RM + r]);
    const float base = mx == mma::neg_inf() ? 0.f : mx;
    float den = 0.f, acc = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float wt = exp2f(cm[w * RM + r] - base);
      den += wt * cl[w * RM + r];
      acc += wt * co[(w * RM + r) * HD + d];
    }
    store(r, d, acc / fmaxf(den, 1e-30f));
    if (lse != nullptr && d == 0)
      lse[r] = mx == mma::neg_inf()
                   ? -1e30f
                   : (mx + log2f(den)) * 0.6931471805599453f;
  }
}
}  // namespace gqa_tc
