// Tensor-core building blocks for the bf16 attention kernels on Hopper
// (forward and backward): 16-byte `cp.async` copies into shared memory
// (whole 64-row tiles with `stage_rows`; 4-byte ones for row
// statistics), `ldmatrix` loads of bf16 fragments (`.trans` for a tile
// stored [key][column] that is the B operand of a product over keys),
// and the warp-level `mma.sync.m16n8k16` bf16 product with float32
// accumulators.
//
// Fragment layouts of m16n8k16 (PTX ISA), g = lane / 4, t = lane % 4:
//   A [16 x 16] row-major, 4 registers of two bf16:
//     a0 (g, 2t..2t+1)  a1 (g+8, 2t..)  a2 (g, 2t+8..)  a3 (g+8, 2t+8..)
//   B [16 x 8] column-major, 2 registers: b0 (k 2t..2t+1, n g),
//     b1 (k 2t+8.., n g)
//   C / D [16 x 8] float32: c0 c1 (g, 2t..2t+1), c2 c3 (g+8, 2t..2t+1)
// So the C fragments of two neighbouring 8-key score tiles, rounded to
// bf16 in pairs, are the A fragment of the 16-key product with V.
//
// Shared-memory tiles keep a row stride of (width + 8) bf16: the eight
// 16-byte rows an `ldmatrix` matrix reads then fall in eight distinct
// bank groups for every width that is a multiple of 16.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace mma {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Copy 16 bytes global -> shared, or write 16 zero bytes when !pred
// (src is then not read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(pred ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Copy 4 bytes global -> shared, or write 4 zero bytes when !pred.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(pred ? 4 : 0));
}

// Wait until at most N committed groups of this thread are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows r0 .. r0+63 of one head (W bf16 a row, `stride` elements from one
// token to the next) into a [64][W + 8] tile, 16 bytes a `cp.async`, by
// the block's NT threads; rows >= S are zero-filled.
template <int W, int NT>
__device__ __forceinline__ void stage_rows(__nv_bfloat16* dst,
                                           const __nv_bfloat16* src,
                                           size_t stride, int r0, int S) {
  constexpr int CH = W / 8, LD = W + 8;
  for (int c = threadIdx.x; c < 64 * CH; c += NT) {
    const int r = c / CH, col = (c - r * CH) * 8;
    const bool ok = r0 + r < S;
    cp_async16(dst + r * LD + col,
               ok ? src + (size_t)(r0 + r) * stride + col : src, ok);
  }
}

// Four 8x8 bf16 matrices; lane l gives the row address of matrix l / 8.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d += a * b on the tensor cores.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ... with f16 operands.
__device__ __forceinline__ void mma_f16(float (&d)[4], const uint32_t (&a)[4],
                                        uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// Two floats as one register of bf16 (lo in the low half).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Address inside a [rows][ld] bf16 tile that lane `lane` gives
// `ldsm_x4` for the A fragment of rows r0..r0+15, columns c0..c0+15.
__device__ __forceinline__ const __nv_bfloat16* a_frag_addr(
    const __nv_bfloat16* tile, int ld, int r0, int c0, int lane) {
  return tile + (r0 + (lane & 15)) * ld + c0 + (lane >> 4) * 8;
}

// ... for the B fragments of two 8-key score tiles: keys n0..n0+15 of a
// tile stored [key][column], columns c0..c0+15 (r[0], r[1] -> keys
// n0..n0+7; r[2], r[3] -> keys n0+8..n0+15).
__device__ __forceinline__ const __nv_bfloat16* bk_frag_addr(
    const __nv_bfloat16* tile, int ld, int n0, int c0, int lane) {
  return tile + (n0 + (lane & 7) + ((lane >> 4) << 3)) * ld + c0 +
         ((lane >> 3) & 1) * 8;
}

// ... for `ldsm_x4_trans` of the value B fragments: keys k0..k0+15 of a
// tile stored [key][column], columns c0..c0+15 (r[0], r[1] -> columns
// c0..c0+7; r[2], r[3] -> columns c0+8..c0+15).
__device__ __forceinline__ const __nv_bfloat16* bv_frag_addr(
    const __nv_bfloat16* tile, int ld, int k0, int c0, int lane) {
  return tile + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld + c0 +
         (lane >> 4) * 8;
}

// Max and sum over the four lanes (t = 0..3) that hold one row.
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ float neg_inf() {
  return __int_as_float(0xff800000);
}

// Online softmax over one warp's [16 x 8*NS] score fragment `s` (scores
// in log2 units, masked entries -inf).  m[u] / l[u] are the running max
// and this thread's share of the denominator of rows g (u = 0) and g+8
// (u = 1); `s` becomes the probabilities exp2(s - m) and alpha[u] the
// factor by which the row's accumulator and l were rescaled.  A row with
// no valid key so far keeps m = -inf, l = 0 and probabilities 0.
template <int NS>
__device__ __forceinline__ void softmax_update(float (&s)[NS][4],
                                               float (&m)[2], float (&l)[2],
                                               float (&alpha)[2]) {
  float base[2];
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    float mx = m[u];
#pragma unroll
    for (int n = 0; n < NS; ++n)
      mx = fmaxf(mx, fmaxf(s[n][2 * u], s[n][2 * u + 1]));
    mx = quad_max(mx);
    base[u] = mx == neg_inf() ? 0.f : mx;
    alpha[u] = exp2f(m[u] - base[u]);
    m[u] = mx;
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < NS; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[n][e] = exp2f(s[n][e] - base[e >> 1]);
      sum[e >> 1] += s[n][e];
    }
#pragma unroll
  for (int u = 0; u < 2; ++u) l[u] = l[u] * alpha[u] + sum[u];
}

// The A fragment of probabilities for keys 16 kk .. 16 kk + 15 from the
// score fragments of 8-key tiles 2 kk and 2 kk + 1, rounded to bf16.
template <int NS>
__device__ __forceinline__ void probs_to_a(const float (&p)[NS][4], int kk,
                                           uint32_t (&a)[4]) {
  a[0] = pack_bf16(p[2 * kk][0], p[2 * kk][1]);
  a[1] = pack_bf16(p[2 * kk][2], p[2 * kk][3]);
  a[2] = pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]);
  a[3] = pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3]);
}

}  // namespace mma
