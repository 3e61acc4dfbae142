// Paged decode attention for GQA / MHA / MQA on Hopper, over bf16 or
// float32 pages and over int8 pages with per-token-head scales.
//
// Replaces the Pallas TPU kernels `paged_decode_attention` and
// `paged_decode_attention_int8` (src/repro/kernels/paged_attention.py,
// the latter's body `_decode_kernel_int8`).  One query per batch row
// attends the row's pool tokens < length through its block table.
//
// Bound on the H100: HBM bytes.  Each row reads length * Hkv * hd
// elements of K and as many of V, and does 4 * length * Hq * hd flops:
// one flop per byte in bf16 (two in int8), far below the ~295 the card
// needs before the tensor cores limit.  So the design reads every K/V
// byte once: one block per (row, KV head) holds all G = Hq / Hkv query
// heads of the group, so each key and value row is staged once and
// serves the whole group.  The block walks only the row's
// min(length, P * page) tokens (table entries clamped into [0, N-1]);
// the sequential walk replaces the TPU grid's page axis.  A row of
// length 0 reads nothing and writes zeros; a key at or past the length
// is never loaded (its tile row and its scales are zero-filled), so
// stale or non-finite slots cannot reach the output.  Five bodies,
// chosen by type, width, page size and table window in `decode_body` /
// `paged_decode_int8` below (never a retry after a failure):
//
// * bf16 q and pages, hd 64 / 128, G <= 16, pages of 16 / 32 / 64
//   tokens and a table window of 512 to 4096 tokens -- the Hopper body
//   (`paged_decode_wg`).  Block (split, KV head, row), 160 threads; the
//   host cuts a (row, KV head)'s walk into splits of whole 64-key tiles
//   from the shapes alone (`decode_split_plan`, kernels/
//   paged_attention.py), and only while the grid has fewer blocks than
//   the card has SMs: a split's start and merge cost more than a
//   shorter walk saves once every SM holds blocks (one split at the
//   serving shape, 512 blocks; 4 at the VLM's 4 rows).  Warp 4, the
//   producer, reads the split's table entries once, up front and in
//   flight with the row's length, then issues each 16-key chunk of a
//   tile that starts below the row's end as TMA boxes ([16 rows][64
//   columns] of one head, 128-byte swizzle, from a rank-4 map over the
//   pool [N, page, Hkv, hd] with the page id as its outer coordinate)
//   into an `mbarrier` ring of up to three K / V stages.  Warps 0-3
//   keep the bandwidth body's walk: Q as A fragments loaded straight
//   into registers, warp w takes keys 16w .. 16w+15 of every tile on
//   `mma.sync` (at ~1 flop a byte `wgmma` would not help), `ldmatrix`
//   reading the swizzled tiles without conflicts, its own online softmax
//   in log2 units; slots at or past the length that landed with their
//   chunk are zeroed in V and replaced in S, so stale or non-finite
//   values there leave the output bit for bit.  The four warps merge in
//   warp order in shared memory; with one live split that is the
//   output, else a row's splits are one thread block cluster (splits,
//   1, 1) and merge their float32 partials in split order through
//   distributed shared memory (no scratch, no atomics: two calls agree
//   bit for bit).  A block whose split starts past the row's end leaves
//   at once when the row has one live split; otherwise it shares the
//   merge.  Four blocks an SM at hd 64 (96 registers, three stages),
//   two at hd 128.
// * bf16 q over int8 pages under the same gate -- the same Hopper body
//   (`paged_decode_wg<HD, true>`): the same plan, producer, ring, warps
//   and merges over int8 tiles of half the bytes.  The producer's boxes
//   are [16 rows][64 bytes] in 64-byte swizzle from a uint8 map; its
//   lanes also copy the tile's 128 bf16 scales (a scale lies at a stride
//   of Hkv * 2 bytes, out of reach of TMA's 16-byte strides), 4 a lane
//   from the table entries they hold, each as the 4-byte word that holds
//   it by `cp.async`, whose completion arrives on the stage's `full`
//   barrier (33 arrivals: the TMA bytes' and the 32 lanes'), so the
//   producer never waits on a scale; a scale at or past the row's end is
//   zero-filled and never loaded.  The consumers widen their K and V
//   bytes to bf16 in registers, exactly, from permuted conflict-free
//   shared loads (see `decode_wg::v_key`), K to f16 instead when every
//   query value is exact in f16 (a third of the integer work: 7 % off
//   the 64-slot call), and put the scales into the products as the int8
//   body below does.  Three stages, as kernel 1.
// * bf16 q and pages, hd 16 / 32 / 64 / 128 and G <= 16 otherwise -- the
//   bandwidth body (`paged_decode_tc`, on the block layout of
//   gqa_tc.cuh, which the bf16 chunk prefill shares): 4 warps; tiles of
//   KT = 64 key positions (each row found through the block table, so
//   any page size) arrive as bf16 by 16-byte `cp.async` into a
//   three-stage ring of K and V
//   tiles, two tiles in flight while one is scored, one barrier a tile.
//   Warp w takes keys 16w .. 16w+15 of every tile and keeps its own
//   online-softmax state; the four are merged once at the end, in warp
//   order, through shared memory.  Scores and P V run on `mma.sync`
//   m16n8k16 with the G query rows padded to 16 (zero rows): at 1 flop
//   a byte the tensor cores idle either way, and the fragments give the
//   per-row max and sum with two quad shuffles, keep Q (hd/16 x 4
//   registers) and P (bf16, as the A operand) in registers, and read K
//   and V out of shared memory with `ldmatrix` without conflicts.  56 KB
//   of shared memory at hd 64 (Q shares the third stage until the walk
//   starts), so four blocks an SM hold the 512 blocks of a 64-row batch
//   at llama3.2-1b width in one wave.
// * bf16 q over int8 pages at the same widths otherwise -- the int8 body
//   (`paged_decode_int8_tc`), on the same block layout, warps and tile
//   code.  Its pages hold one byte an element, half of bf16's (the
//   reason the TPU kernel exists), plus one bf16 scale per (token, KV
//   head) for K and for V.  The K and V tiles arrive as int8 by 16-byte
//   `cp.async` into a three-stage ring of rows of hd bytes (a tile is
//   read in order, so no padding is needed); each key's two scales ride
//   one tile behind in registers (a 2-byte scale lies at a stride of Hkv
//   elements, out of `cp.async`'s reach) and land in the stage as
//   float32 before its barrier.  Every int8 value, -127..127, is exact in
//   bf16, so each warp widens its own 16 keys of K and V into a private
//   bf16 buffer of rows of (hd + 8) with no rounding and no scale (four
//   bytes at a time, through the float 2^23 + u) and runs the bf16
//   body's `warp_scores` / `warp_fold` on it unchanged.  The scales go
//   into the products in float32: the K scale multiplies the score
//   fragment before masking, the V scale multiplies P after the online
//   softmax update (l keeps the unscaled sum) and before P is rounded to
//   bf16 as the A operand -- the body's only rounding beyond the bf16
//   body's.  No dequantized copy of a page exists anywhere.
// * float32 q (with float32, bf16 or int8 pages) and the other widths --
//   the CUDA-core body (`paged_decode_kernel`): one block per (row, KV
//   head) stages each page into shared memory as float32 (int8 values
//   times their scales) and keeps the online-softmax state (m, l, acc)
//   there.
//
// Every body also writes, when the caller passes an `lse` buffer, each
// (row, query head)'s log-sum-exp of its scaled scores, float32 [B,Hq]
// in natural-log units (NEG_INF = -1e30 for a row with no attendable
// key): the weights by which the split decode over a sequence-split
// cache merges its slices.  Once a row, after the walk; 4 bytes beside
// the row's K/V reads.
//
// Layouts: q [B,Hq,hd]; k/v pages [N,page,Hkv,hd]; int8 scales
// [N,page,Hkv,1] bf16; block tables [B,P] int32; lengths [B] int32;
// out [B,Hq,hd] in q's type; lse [B,Hq] float32 or null.
#include <cuda_fp16.h>

#include <type_traits>

#include "gqa_tc.cuh"
#include "hopper_common.cuh"
#include "paged_common.cuh"

template <typename TQ, typename TKV, bool SCALED>
__global__ void paged_decode_kernel(const TQ* __restrict__ q,
                                    const TKV* __restrict__ k_pages,
                                    const TKV* __restrict__ v_pages,
                                    const __nv_bfloat16* __restrict__ k_scales,
                                    const __nv_bfloat16* __restrict__ v_scales,
                                    const int* __restrict__ tables,
                                    const int* __restrict__ lengths,
                                    TQ* __restrict__ out,
                                    float* __restrict__ lse, int Hq,
                                    int Hkv, int hd, int N, int page, int P,
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
    const int start = p * page;
    const int rows = min(KT, len - start);  // slots past the length stay 0
    if constexpr (SCALED) {
      const size_t sbase = (size_t)pid * page * Hkv + h;
      tile_load_kv(t, k_pages, v_pages, KT, hd, rows, row_offset, [&](int j) {
        const size_t s = sbase + (size_t)j * Hkv;
        return make_float2(to_f(k_scales[s]), to_f(v_scales[s]));
      });
    } else {
      tile_load_kv(t, k_pages, v_pages, KT, hd, rows, row_offset);
    }
    tile_scores(t, R, KT, hd, scale,
                [&](int, int j) { return start + j < len; });
    tile_update(t, R, KT, hd);
  }

  for (int i = threadIdx.x; i < R * hd; i += blockDim.x) {
    const int r = i / hd;
    out[q_base + i] = from_f<TQ>(t.acc[i] / fmaxf(t.l[r], 1e-30f));
  }
  // m is in natural-log units here (tile_update runs expf)
  if (lse != nullptr)
    for (int r = threadIdx.x; r < R; r += blockDim.x)
      lse[(size_t)b * Hq + (size_t)h * G + r] =
          t.l[r] > 0.f ? t.m[r] + logf(t.l[r]) : PAGED_NEG_INF;
}

template <typename TQ, typename TKV, bool SCALED>
static int launch(const void* q, const void* kp, const void* vp,
                  const void* ks, const void* vs, const void* tables,
                  const void* lengths, void* out, float* lse, int B,
                  int Hq, int Hkv, int hd, int N, int page, int P,
                  float scale, cudaStream_t stream) {
  const int R = Hq / Hkv;
  const size_t smem = tile_floats(R, page, hd) * sizeof(float);
  auto kernel = paged_decode_kernel<TQ, TKV, SCALED>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B, Hkv);
  kernel<<<grid, 256, smem, stream>>>(
      (const TQ*)q, (const TKV*)kp, (const TKV*)vp,
      (const __nv_bfloat16*)ks, (const __nv_bfloat16*)vs, (const int*)tables,
      (const int*)lengths, (TQ*)out, lse, Hq, Hkv, hd, N, page, P, scale);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bandwidth body (bf16 q and pages; block layout and tile code in
// gqa_tc.cuh)
// ---------------------------------------------------------------------------
template <int HD>
__global__ void __launch_bounds__(gqa_tc::NT, 4)
    paged_decode_tc(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k_pages,
                    const __nv_bfloat16* __restrict__ v_pages,
                    const int* __restrict__ tables,
                    const int* __restrict__ lengths,
                    __nv_bfloat16* __restrict__ out,
                    float* __restrict__ lse, int Hq, int Hkv, int N,
                    int page, int P, float scale_log2) {
  using namespace gqa_tc;
  using bf16 = __nv_bfloat16;
  constexpr int LD = HD + 8, CH = HD / 8;  // row stride; 16-byte chunks
  constexpr int TILE = 2 * KT * LD;        // one stage: K then V
  extern __shared__ float4 gqa_smem[];
  bf16* ring = reinterpret_cast<bf16*>(gqa_smem);
  bf16* sq = ring + 2 * TILE;  // Q in the third stage
  const int b = blockIdx.x, h = blockIdx.y, G = Hq / Hkv;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int tq = lane & 3;
  const int end = min(max(lengths[b], 0), P * page);
  const int nt = (end + KT - 1) / KT;
  const int* trow = tables + (size_t)b * P;
  const size_t q0 = ((size_t)b * Hq + (size_t)h * G) * HD;

  for (int c = tid; c < RM * CH; c += NT) {
    const int r = c / CH, col = (c - r * CH) * 8;
    mma::cp_async16(sq + r * LD + col, q + q0 + (r < G ? r * HD + col : 0),
                    r < G);
  }
  auto stage = [&](int t) {
    bf16* dst = ring + (t % STAGES) * TILE;
    for (int c = tid; c < KT * CH; c += NT) {
      const int j = c / CH, cc = c - j * CH, pos = t * KT + j;
      const bool ok = pos < end;
      size_t off = 0;
      if (ok) {
        const int pid = min(max(trow[pos / page], 0), N - 1);
        off = (((size_t)pid * page + pos % page) * Hkv + h) * HD + cc * 8;
      }
      mma::cp_async16(dst + j * LD + cc * 8, k_pages + off, ok);
      mma::cp_async16(dst + (KT + j) * LD + cc * 8, v_pages + off, ok);
    }
  };
  stage(0);
  mma::cp_async_commit();  // Q and tile 0
  if (nt > 1) stage(1);
  mma::cp_async_commit();

  uint32_t qa[HD / 16][4];  // Q as A fragments, rows >= G zero
  float o[HD / 8][4], m[2], l[2];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  m[0] = m[1] = mma::neg_inf();
  l[0] = l[1] = 0.f;
  mma::cp_async_wait<1>();
  __syncthreads();
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
    mma::ldsm_x4(qa[kk], mma::a_frag_addr(sq, LD, 0, kk * 16, lane));

  const int k0 = warp * 16;  // this warp's keys of a tile
  for (int t = 0; t < nt; ++t) {
    mma::cp_async_wait<1>();
    __syncthreads();  // tile t staged; every warp is done with t - 1
    if (t + 2 < nt) stage(t + 2);
    mma::cp_async_commit();
    const bf16* kt = ring + (t % STAGES) * TILE;
    float s[2][4];
    gqa_tc::warp_scores<HD>(qa, kt, k0, lane, s);
    const int kpos = t * KT + k0 + 2 * tq;
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[n][e] = kpos + n * 8 + (e & 1) < end ? s[n][e] * scale_log2
                                               : mma::neg_inf();
    gqa_tc::warp_fold<HD>(s, kt + KT * LD, k0, lane, m, l, o);
  }

  gqa_tc::merge_warps<HD>(
      reinterpret_cast<float*>(ring), m, l, o, G,
      [&](int r, int d, float x) {
        out[q0 + r * HD + d] = __float2bfloat16(x);
      },
      lse == nullptr ? nullptr : lse + (size_t)b * Hq + (size_t)h * G);
}

template <int HD>
static int launch_tc(const void* q, const void* kp, const void* vp,
                     const void* tables, const void* lengths, void* out,
                     float* lse, int B, int Hq, int Hkv, int N, int page,
                     int P, float scale, cudaStream_t stream) {
  const size_t smem = gqa_tc::ring_bytes(HD);
  auto kernel = paged_decode_tc<HD>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  using bf16 = __nv_bfloat16;
  kernel<<<dim3(B, Hkv), gqa_tc::NT, smem, stream>>>(
      (const bf16*)q, (const bf16*)kp, (const bf16*)vp, (const int*)tables,
      (const int*)lengths, (bf16*)out, lse, Hq, Hkv, N, page, P,
      scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

static int decode_tc(const void* q, const void* kp, const void* vp,
                     const void* tables, const void* lengths, void* out,
                     float* lse, int B, int Hq, int Hkv, int hd, int N,
                     int page, int P, float scale, cudaStream_t st) {
  switch (hd) {
    case 16:
      return launch_tc<16>(q, kp, vp, tables, lengths, out, lse, B, Hq, Hkv,
                           N, page, P, scale, st);
    case 32:
      return launch_tc<32>(q, kp, vp, tables, lengths, out, lse, B, Hq, Hkv,
                           N, page, P, scale, st);
    case 64:
      return launch_tc<64>(q, kp, vp, tables, lengths, out, lse, B, Hq, Hkv,
                           N, page, P, scale, st);
    case 128:
      return launch_tc<128>(q, kp, vp, tables, lengths, out, lse, B, Hq,
                            Hkv, N, page, P, scale, st);
  }
  return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// int8 to bf16, exactly: each byte, offset to unsigned u = x + 128, is the
// low mantissa byte of the float 2^23 + u, and subtracting 2^23 + 128
// leaves x, whose top 16 bits are its bf16 (|x| <= 128 needs at most 8
// significant bits).  Shared by the int8 bodies.
// ---------------------------------------------------------------------------
namespace widen {
// Byte `byte` of `w` (already offset by 128) as that float32.
__device__ __forceinline__ uint32_t one(uint32_t w, int byte) {
  return __float_as_uint(
      __uint_as_float(__byte_perm(w, 0x4b000000u, 0x7650 + byte)) -
      8388736.f);
}
// Two such floats as one register of two bf16 (lo in the low half).
__device__ __forceinline__ uint32_t pair(uint32_t lo, uint32_t hi) {
  return __byte_perm(lo, hi, 0x7632);
}
// Four int8 values (one word, lowest byte first) as four bf16.
__device__ __forceinline__ uint2 four(uint32_t w) {
  w ^= 0x80808080u;
  return make_uint2(pair(one(w, 0), one(w, 1)), pair(one(w, 2), one(w, 3)));
}
// ... as four f16, two a register: 1024 + u is the f16 0x6400 | u, and
// subtracting 1152 in f16 leaves x -- a third of four()'s integer work.
__device__ __forceinline__ uint2 four_f16(uint32_t w) {
  w ^= 0x80808080u;
  const uint32_t a = __byte_perm(w, 0x64646464u, 0x5140);
  const uint32_t b = __byte_perm(w, 0x64646464u, 0x7362);
  const __half2 off = __float2half2_rn(1152.f);
  const __half2 lo = __hsub2(*reinterpret_cast<const __half2*>(&a), off);
  const __half2 hi = __hsub2(*reinterpret_cast<const __half2*>(&b), off);
  return make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                    *reinterpret_cast<const uint32_t*>(&hi));
}
}  // namespace widen

// ---------------------------------------------------------------------------
// Hopper body (bf16 q; bf16 or int8 pages at hd 64 / 128, G <= 16, pages
// of 16 / 32 / 64 tokens)
// ---------------------------------------------------------------------------
namespace decode_wg {
constexpr int KT = 64;          // keys a tile, 16 a consumer warp
constexpr int RM = 16;          // query rows of the mma tile: G <= 16
constexpr int NT = 160;         // warps 0-3 the consumers, 4 the producer
constexpr int MAX_SPLITS = 8;   // splits a plan may have: a portable cluster
constexpr int CHUNK = 16;       // keys a TMA box: the rows past the end
                                // of a row's last page stay unread

// Byte offsets in the block's shared memory (from a 1024-byte boundary):
// the K ring [stages][HD/64][KT][64] elements (bf16 or int8), the V ring
// the same, with int8 pages each stage's K and V scales [2][KT] (the
// words that hold them), then the barriers (full, then empty, a stage).
// Once the walk is over the space holds each warp's state -- o
// [4][RM][HD + 8] (the padding puts a warp's 64-bit stores of a row
// pair in distinct banks), m [4][RM], l [4][RM] float32 -- and the
// block's partial merged from them, o [RM][HD] and (m, l) [RM] float2,
// which the cluster's merge reads.
template <int HD, bool INT8>
struct Smem {
  // stages of the ring (a split of fewer tiles takes fewer): bf16 at hd
  // 64, three keep four blocks an SM (shared memory and MIN_BLOCKS); an
  // int8 tile is half as large, and four or six stages fit the same
  // blocks but read no faster (three beat them on full 512-token rows)
  static constexpr int STAGES = 3;
  static constexpr int MIN_BLOCKS = HD == 64 ? 4 : 2;
  static constexpr size_t tile = (size_t)KT * HD * (INT8 ? 1 : 2);
  static constexpr size_t scales = INT8 ? 2 * KT * 4 : 0;
  static constexpr int WO_STRIDE = HD + 8;  // a warp state's row
  static constexpr size_t wm = (size_t)4 * RM * WO_STRIDE * 4;
  static constexpr size_t wl = wm + 4 * RM * 4;
  static constexpr size_t bo = wl + 4 * RM * 4;
  static constexpr size_t bml = bo + (size_t)RM * HD * 4;
  static constexpr size_t merge = bml + RM * 8;
  __host__ __device__ static size_t bars(int stages) {
    const size_t ring = stages * (2 * tile + scales);
    return ring > merge ? ring : merge;
  }
  static size_t bytes(int stages) { return bars(stages) + 16 * stages + 1024; }
};

inline bool page_ok(int page) {
  return page == 16 || page == 32 || page == 64;
}

// Table windows the Hopper body takes: 8 to 64 tiles.  Below, a walk of a
// few tiles is latency and the bandwidth body's `cp.async` starts sooner
// than a TMA load (whisper-tiny's 448-token slots); above, one block
// streams a (row, KV head) at the card's bytes either way and the
// bandwidth body reads ~2 % faster (the dry run's 32768-token window).
inline bool window_ok(int window) {
  return window >= 8 * KT && window <= 64 * KT;
}

// Element offset of (row, col) in a tile of KT rows stored as HD / 64
// regions of [KT][64] bf16 in 128-byte swizzle (hopper_common.cuh): the
// 16-byte chunk c of a row lies at chunk c ^ (row % 8).
__device__ __forceinline__ int swz(int row, int col) {
  return (col >> 6) * KT * 64 + row * 64 +
         ((((col >> 3) & 7) ^ (row & 7)) << 3) + (col & 7);
}

// Scores of this warp's keys k0 .. k0+15 of the swizzled key tile `kt`:
// s[n] holds keys k0 + 8n .. k0 + 8n + 7 (float32, unscaled); `ldmatrix`
// reads eight rows of one logical chunk from eight distinct banks.
template <int HD>
__device__ __forceinline__ void scores(const uint32_t (&qa)[HD / 16][4],
                                       const __nv_bfloat16* kt, int k0,
                                       int lane, float (&s)[2][4]) {
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
  const int row = k0 + (lane & 7) + ((lane >> 4) << 3);
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    uint32_t bk[4];
    mma::ldsm_x4(bk, kt + swz(row, kk * 16 + ((lane >> 3) & 1) * 8));
    mma::mma_bf16(s[0], qa[kk], bk[0], bk[1]);
    mma::mma_bf16(s[1], qa[kk], bk[2], bk[3]);
  }
}

// o += P V over this warp's keys k0 .. k0+15 of the swizzled value tile
// `vt`, P the A fragment of the probabilities.
template <int HD>
__device__ __forceinline__ void values(const uint32_t (&pa)[4],
                                       const __nv_bfloat16* vt, int k0,
                                       int lane, float (&o)[HD / 8][4]) {
  const int row = k0 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int np = 0; np < HD / 16; ++np) {
    uint32_t bv[4];
    mma::ldsm_x4_trans(bv, vt + swz(row, np * 16 + (lane >> 4) * 8));
    mma::mma_bf16(o[2 * np], pa, bv[0], bv[1]);
    mma::mma_bf16(o[2 * np + 1], pa, bv[2], bv[3]);
  }
}

// ---- int8 pages --------------------------------------------------------
// An int8 tile holds HD / 64 regions of [KT][64 bytes] in 64-byte swizzle
// (hopper_common.cuh `make_map_i8`).  No int8 operand exists for a bf16
// product, and `ldmatrix` has no 8-bit transpose on sm_90, so each thread
// reads the bytes its fragments need with plain shared loads and widens
// them in registers, exactly (`widen`); both sums of the walk are free to
// run in any order, so the layouts are permuted to make those loads wide
// and free of bank conflicts:
//
// * Q K^T sums over hd: thread (g, t) of step kk (hd 16 kk ..) reads the
//   16-byte chunk t of its key row (one load gives steps 4j .. 4j + 3 of
//   region j); byte 4i .. 4i+3 of it are B rows 2t, 2t+1, 2t+8, 2t+9 of
//   step 4j + i, so Q's A fragments are loaded from the same permuted
//   columns (`q_col`).
// * P V sums over keys: thread (g, t) reads keys `v_key(t, i)`, i = 0..3,
//   as B rows 2t, 2t+1, 2t+8, 2t+9, 8 bytes each at columns 8g .. 8g+7
//   of region j, and each byte column is one n8 block's B column g
//   (`o_col` maps the blocks back to hd).  The score tile's column c of
//   n8 block n must then hold key v_key(c / 2, 2n + c % 2) (`k_key`).
// Chunk (row r, c) lies at c ^ (r / 2 % 4): with these key maps each
// 8-lane phase of a 16-byte K load covers two whole rows of opposite
// parity, and each 16-lane phase of an 8-byte V load eight distinct
// 8-byte bank groups.
__device__ __forceinline__ int v_key(int t, int i) {
  return ((i ^ t) & 1) + 2 * (t & 1) + 4 * (t >> 1) + 8 * (i >> 1);
}
__device__ __forceinline__ int k_key(int n, int c) {
  return v_key(c >> 1, 2 * n + (c & 1));
}
__device__ __forceinline__ int q_col(int kk, int t, int x) {
  return 64 * (kk >> 2) + 16 * t + 4 * (kk & 3) + 2 * (x >> 1);
}
__device__ __forceinline__ int o_col(int n, int c) {
  return 64 * (n >> 3) + 8 * c + (n & 7);
}
// The fragment position 8 n + c of hd column d = o_col(n, c).
__device__ __forceinline__ int o_pos(int d) {
  return (d & ~63) + 8 * (d & 7) + ((d >> 3) & 7);
}
// Both bf16 of `x` are exact in f16: 0, or normal in f16 (2^-14 <= |v|
// <= 65280, the largest bf16 below f16's 65504).
__device__ __forceinline__ bool f16_exact(uint32_t x) {
  const uint32_t a = x & 0x7fffu, b = (x >> 16) & 0x7fffu;
  return (a == 0 || (a >= 0x3880u && a <= 0x477fu)) &&
         (b == 0 || (b >= 0x3880u && b <= 0x477fu));
}
// Two bf16 as two f16 (exact where f16_exact).
__device__ __forceinline__ uint32_t to_f16(uint32_t x) {
  const __half2 h = __floats2half2_rn(__uint_as_float(x << 16),
                                      __uint_as_float(x & 0xffff0000u));
  return *reinterpret_cast<const uint32_t*>(&h);
}

// Byte offset of (row, byte b) in an int8 region of [KT][64 bytes].
__device__ __forceinline__ int swz8(int row, int b) {
  return row * 64 + ((((b >> 4) ^ (row >> 1)) & 3) << 4) + (b & 15);
}

// The float32 scales of an even key and the next from the staged words
// that hold them: a key's scale lies in the high half of its word when
// its element index (slot * Hkv + h, slot of the key's parity: pages are
// even) is odd.
__device__ __forceinline__ float2 scale_pair(uint2 w, int h, int Hkv) {
  const int odd0 = h & 1, odd1 = (h + (Hkv & 1)) & 1;
  return make_float2(
      __uint_as_float(odd0 ? w.x & 0xffff0000u : w.x << 16),
      __uint_as_float(odd1 ? w.y & 0xffff0000u : w.y << 16));
}

// Scores of this warp's keys of the int8 key tile `kt` (unscaled): s[n]
// column c holds key k0 + k_key(n, c).  F16: Q's fragments and K widened
// as f16 (`widen::four_f16`), else as bf16.
template <int HD, bool F16>
__device__ __forceinline__ void scores_i8(const uint32_t (&qa)[HD / 16][4],
                                          const unsigned char* kt, int k0,
                                          int lane, float (&s)[2][4]) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
  for (int j = 0; j < HD / 64; ++j) {
    uint4 w[2];
#pragma unroll
    for (int n = 0; n < 2; ++n)
      w[n] = *reinterpret_cast<const uint4*>(
          kt + j * KT * 64 + swz8(k0 + k_key(n, g), 16 * t));
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const uint32_t x = i == 0   ? w[n].x
                           : i == 1 ? w[n].y
                           : i == 2 ? w[n].z
                                    : w[n].w;
        if constexpr (F16) {
          const uint2 b = widen::four_f16(x);
          mma::mma_f16(s[n], qa[4 * j + i], b.x, b.y);
        } else {
          const uint2 b = widen::four(x);
          mma::mma_bf16(s[n], qa[4 * j + i], b.x, b.y);
        }
      }
  }
}

// o += P V over this warp's keys of the int8 value tile `vt` (P's key
// order is the scores'): o[n] column c holds hd column o_col(n, c).
template <int HD>
__device__ __forceinline__ void values_i8(const uint32_t (&pa)[4],
                                          const unsigned char* vt, int k0,
                                          int lane, float (&o)[HD / 8][4]) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < HD / 64; ++j) {
    uint32_t w[2][4];  // [low / high 4 bytes][key i]
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint2 x = *reinterpret_cast<const uint2*>(
          vt + j * KT * 64 + swz8(k0 + v_key(t, i), 8 * g));
      w[0][i] = x.x ^ 0x80808080u;
      w[1][i] = x.y ^ 0x80808080u;
    }
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const uint32_t(&h)[4] = w[c >> 2];
      mma::mma_bf16(
          o[8 * j + c], pa,
          widen::pair(widen::one(h[0], c & 3), widen::one(h[1], c & 3)),
          widen::pair(widen::one(h[2], c & 3), widen::one(h[3], c & 3)));
    }
  }
}
}  // namespace decode_wg

// Block (split sp, KV head h, row b), 160 threads: warps 0-3 the
// consumers (16 keys of every 64-key tile each), warp 4 the producer.  A
// row's splits are one cluster (splits, 1, 1); block sp is its rank sp.
// INT8: int8 pages with bf16 scales [N, page, Hkv, 1] (`k_scales`,
// `v_scales`, else null).  `stages` of the ring: min(tiles, STAGES).
template <int HD, bool INT8>
__global__ void __launch_bounds__(decode_wg::NT,
                                  decode_wg::Smem<HD, INT8>::MIN_BLOCKS)
    paged_decode_wg(const __grid_constant__ CUtensorMap tkp,
                    const __grid_constant__ CUtensorMap tvp,
                    const __nv_bfloat16* __restrict__ q,
                    const unsigned short* __restrict__ k_scales,
                    const unsigned short* __restrict__ v_scales,
                    const int* __restrict__ tables,
                    const int* __restrict__ lengths,
                    __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                    int Hq, int Hkv, int N, int page, int P, int tps,
                    int stages, float scale_log2) {
  using namespace decode_wg;
  using L = Smem<HD, INT8>;
  using bf16 = __nv_bfloat16;
  using T = typename std::conditional<INT8, unsigned char, bf16>::type;
  extern __shared__ unsigned char decode_wg_smem[];
  unsigned char* base = hop::align1024(decode_wg_smem);
  T* sk = reinterpret_cast<T*>(base);
  T* sv = reinterpret_cast<T*>(base + stages * L::tile);
  // int8: stage s's K scales [KT] then its V scales [KT], each the
  // 4-byte word of the scale tensor that holds the key's bf16 scale
  uint32_t* ssc = reinterpret_cast<uint32_t*>(base + 2 * stages * L::tile);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + L::bars(stages));
  uint64_t* empty = full + stages;
  float* wo = reinterpret_cast<float*>(base);  // after the walk
  float* wm = reinterpret_cast<float*>(base + L::wm);
  float* wl = reinterpret_cast<float*>(base + L::wl);
  float* bo = reinterpret_cast<float*>(base + L::bo);
  float2* bml = reinterpret_cast<float2*>(base + L::bml);

  const int sp = blockIdx.x, splits = gridDim.x;
  const int h = blockIdx.y, b = blockIdx.z, G = Hq / Hkv;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // the producer's first 32 table entries of the split, in flight with
  // the row's length
  const int* trow = tables + (size_t)b * P;
  const int ppt = KT / page;
  int first = sp * tps * ppt;  // page of lane 0's entry
  int pid = 0;
  if (warp == 4 && first + lane < P) pid = trow[first + lane];
  const int end = min(max(lengths[b], 0), P * page);
  const int span = tps * KT;
  // the splits that start below the row's end (at least split 0); with
  // one, block 0 writes the output and the others leave at once
  const int n_live = max(1, (end + span - 1) / span);
  if (n_live == 1 && sp > 0) return;
  const int t0 = sp * tps;                           // the split's tile 0
  const int nt = min(tps, (end + KT - 1) / KT - t0);  // tiles it walks
  const size_t q0 = ((size_t)b * Hq + (size_t)h * G) * HD;
  if (tid == 128) {
    for (int s = 0; s < stages; ++s) {
      // int8: the TMA bytes' arrival, then the producer's 32 lanes'
      // once their scale copies have landed
      hop::mbar_init(full + s, INT8 ? 33 : 1);
      hop::mbar_init(empty + s, 4);  // lane 0 of each consumer warp
    }
    hop::fence_barrier_init();
  }
  __syncthreads();

  if (warp == 4) {
    // the producer: the split's table entries, 32 pages a batch (the
    // first read before the row's length is known), then each 16-key
    // chunk of a tile that starts below the row's end as one TMA box a
    // 64-column region ([16 rows][64 columns] of head h, chunk c of a
    // tile at row 16 c; lane c issues it with its page's entry), a
    // stage a tile, reusing a stage once its four consumer warps have
    // released it.  int8: lane l also copies the K and V scales of the
    // tile's keys 2l and 2l + 1 into the stage by 4-byte `cp.async`
    // (zeros at or past the row's end, never loaded: a stale scale may be
    // inf or NaN), whose completion arrives on the stage's `full` barrier,
    // so the producer never waits on them.
    if (nt > 0) {
      if (lane == 0) {
        hop::prefetch_map(&tkp);
        hop::prefetch_map(&tvp);
      }
      for (int t = 0; t < nt; ++t) {
        const int s = t % stages;
        if (t >= stages) hop::mbar_wait(empty + s, (t / stages - 1) & 1);
        const int p0 = (t0 + t) * ppt;  // the tile's first page
        if (p0 - first >= 32) {
          first = p0;
          pid = p0 + lane < P ? trow[p0 + lane] : 0;
        }
        // chunks below the end, >= 1 (their pages are < P)
        const int nc = min(KT / CHUNK, (end - p0 * page + CHUNK - 1) / CHUNK);
        if (lane == 0)
          hop::mbar_expect_tx(full + s,
                              (uint32_t)(nc * CHUNK * HD * sizeof(T) * 2));
        const int pc = __shfl_sync(0xffffffffu, pid,
                                   p0 - first + lane * CHUNK / page);
        if (lane < nc) {
          const int pg = min(max(pc, 0), N - 1);
          const int r = lane * CHUNK;  // the chunk's row of the tile
#pragma unroll
          for (int c = 0; c < HD / 64; ++c) {
            hop::tma_load(sk + s * KT * HD + c * KT * 64 + r * 64, &tkp,
                          full + s, c * 64, h, r % page, pg);
            hop::tma_load(sv + s * KT * HD + c * KT * 64 + r * 64, &tvp,
                          full + s, c * 64, h, r % page, pg);
          }
        }
        if constexpr (INT8) {
          // keys 2 lane + k's scales, each as the 4-byte aligned word
          // that holds it (a tensor of N * page * Hkv bf16, page even,
          // holds that word); zero-filled at or past the row's end
          const int pk = __shfl_sync(0xffffffffu, pid,
                                     p0 - first + 2 * lane / page);
          uint32_t* sw = ssc + s * 2 * KT + 2 * lane;
#pragma unroll
          for (int k = 0; k < 2; ++k) {
            const int pos = (t0 + t) * KT + 2 * lane + k;
            size_t at = 0;
            if (pos < end)
              at = (((size_t)min(max(pk, 0), N - 1) * page + pos % page) *
                        Hkv + h) & ~(size_t)1;
            mma::cp_async4(sw + k, k_scales + at, pos < end);
            mma::cp_async4(sw + KT + k, v_scales + at, pos < end);
          }
          hop::cp_async_arrive_noinc(full + s);
        }
      }
    }
  } else {
    // the consumers: Q as A fragments straight from global memory (rows
    // g, g + 8 of the G heads, zero past them; int8: at the columns
    // `q_col` permutes), then the split's tiles
    const int g = lane >> 2, tq = lane & 3, k0 = warp * 16;
    uint32_t qa[HD / 16][4];
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int r = g + 8 * (x & 1);
        const int col = INT8 ? q_col(kk, tq, x)
                             : kk * 16 + 2 * tq + 8 * (x >> 1);
        qa[kk][x] = r < G ? *reinterpret_cast<const uint32_t*>(
                                q + q0 + (size_t)r * HD + col)
                          : 0u;
      }
    // int8: the scores in f16 when every query value is exact in f16
    // (products and sums are those of bf16), so that K widens with a third
    // of the integer work; the warps' votes agree (each holds all of Q)
    bool f16 = false;
    if constexpr (INT8) {
      bool exact = true;
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
#pragma unroll
        for (int x = 0; x < 4; ++x) exact = exact && f16_exact(qa[kk][x]);
      f16 = __all_sync(0xffffffffu, exact);
      if (f16)
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk)
#pragma unroll
          for (int x = 0; x < 4; ++x) qa[kk][x] = to_f16(qa[kk][x]);
    }
    float o[HD / 8][4], m[2], l[2];
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
    m[0] = m[1] = mma::neg_inf();
    l[0] = l[1] = 0.f;
    for (int t = 0; t < nt; ++t) {
      const int s = t % stages;
      const T* kt = sk + s * KT * HD;
      T* vt = sv + s * KT * HD;
      const int key0 = (t0 + t) * KT + k0;  // this warp's first key
      hop::mbar_wait(full + s, (t / stages) & 1);
      // this warp's keys < valid are read; the rest of its 16 landed
      // with their chunk (or hold an earlier tile): their scores are
      // replaced and, bf16, their V rows zeroed before P V, so a stale or
      // non-finite slot never reaches a product (int8: every value is
      // finite and its P and scale are 0).  A warp with no key left
      // leaves its state as it is (what the update would do).
      const int valid = end - key0;
      if (valid > 0) {
        float sc[2][4];
        if constexpr (INT8) {
          // the K scale multiplies the score before masking, the V scale
          // P after the online-softmax update (l keeps the unscaled sum)
          // and before P is rounded to bf16; s[n] column 2 tq + e holds
          // key kb + (e ^ tq % 2), kb = k_key(n, 2 tq) - tq % 2 (even)
          const uint32_t* ws = ssc + s * 2 * KT + k0;
          float2 kv[2], vv[2];
#pragma unroll
          for (int n = 0; n < 2; ++n) {
            const int kb = k_key(n, 2 * tq) - (tq & 1);
            kv[n] = scale_pair(*reinterpret_cast<const uint2*>(ws + kb), h,
                               Hkv);
            vv[n] = scale_pair(
                *reinterpret_cast<const uint2*>(ws + KT + kb), h, Hkv);
          }
          if (f16)
            decode_wg::scores_i8<HD, true>(qa, kt, k0, lane, sc);
          else
            decode_wg::scores_i8<HD, false>(qa, kt, k0, lane, sc);
#pragma unroll
          for (int n = 0; n < 2; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const bool hi = ((e & 1) ^ (tq & 1)) != 0;
              sc[n][e] = k_key(n, 2 * tq + (e & 1)) < valid
                             ? sc[n][e] * (hi ? kv[n].y : kv[n].x) *
                                   scale_log2
                             : mma::neg_inf();
            }
          float alpha[2];
          mma::softmax_update<2>(sc, m, l, alpha);
#pragma unroll
          for (int n = 0; n < HD / 8; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) o[n][e] *= alpha[e >> 1];
#pragma unroll
          for (int n = 0; n < 2; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              sc[n][e] *= ((e & 1) ^ (tq & 1)) ? vv[n].y : vv[n].x;
          uint32_t pa[4];
          mma::probs_to_a<2>(sc, 0, pa);
          decode_wg::values_i8<HD>(pa, vt, k0, lane, o);
        } else {
          if (valid < 16) {
            for (int c = lane; c < 16 * (HD / 8); c += 32) {
              const int i = c / (HD / 8);
              if (i >= valid)
                *reinterpret_cast<uint4*>(
                    vt + decode_wg::swz(k0 + i, (c - i * (HD / 8)) * 8)) =
                    make_uint4(0u, 0u, 0u, 0u);
            }
            hop::fence_proxy_async();  // before TMA refills the stage
            __syncwarp();
          }
          decode_wg::scores<HD>(qa, kt, k0, lane, sc);
#pragma unroll
          for (int n = 0; n < 2; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              sc[n][e] = n * 8 + 2 * tq + (e & 1) < valid
                             ? sc[n][e] * scale_log2
                             : mma::neg_inf();
          float alpha[2];
          mma::softmax_update<2>(sc, m, l, alpha);
#pragma unroll
          for (int n = 0; n < HD / 8; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) o[n][e] *= alpha[e >> 1];
          uint32_t pa[4];
          mma::probs_to_a<2>(sc, 0, pa);
          decode_wg::values<HD>(pa, vt, k0, lane, o);
        }
      }
      __syncwarp();
      if (lane == 0) hop::mbar_arrive(empty + s);
    }
    // each warp's state into the space of the ring, once every consumer
    // is done with it, in fragment order (int8: column 8 n + c holds hd
    // column o_col(n, c))
    hop::named_sync(1, 128);
    const float ls[2] = {mma::quad_sum(l[0]), mma::quad_sum(l[1])};
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int r = g + 8 * u;
      if (tq == 0) {
        wm[warp * RM + r] = m[u];
        wl[warp * RM + r] = ls[u];
      }
      float* orow = wo + (warp * RM + r) * L::WO_STRIDE + 2 * tq;
#pragma unroll
      for (int n = 0; n < HD / 8; ++n)
        *reinterpret_cast<float2*>(orow + n * 8) =
            make_float2(o[n][2 * u], o[n][2 * u + 1]);
    }
  }
  __syncthreads();

  // The block's four warps merged in warp order: w_w = 2^(m_w - max m),
  // acc = sum w_w o_w, den = sum w_w l_w (m in log2 units).  With one
  // live split that is the output, acc / max(den, 1e-30) (zeros for a
  // row with no valid key), and the log-sum-exp (max m + log2 den) ln 2
  // (-1e30 for such a row); otherwise the block's partial.
  for (int i = tid; i < G * HD; i += NT) {
    const int r = i / HD, d = i - r * HD, dp = INT8 ? o_pos(d) : d;
    float mx = wm[r];
#pragma unroll
    for (int w = 1; w < 4; ++w) mx = fmaxf(mx, wm[w * RM + r]);
    const float mbase = mx == mma::neg_inf() ? 0.f : mx;
    float den = 0.f, acc = 0.f;
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const float wt = exp2f(wm[w * RM + r] - mbase);
      den += wt * wl[w * RM + r];
      acc += wt * wo[(w * RM + r) * L::WO_STRIDE + dp];
    }
    if (n_live == 1) {
      out[q0 + (size_t)r * HD + d] = __float2bfloat16(acc / fmaxf(den, 1e-30f));
      if (lse != nullptr && d == 0)
        lse[(size_t)b * Hq + (size_t)h * G + r] =
            mx == mma::neg_inf() ? -1e30f
                                 : (mx + log2f(den)) * 0.6931471805599453f;
    } else {
      bo[r * HD + d] = acc;
      if (d == 0) bml[r] = make_float2(mx, den);
    }
  }
  if (n_live == 1) return;

  // The merge, shared by the cluster: block sp takes four columns at a
  // time, sp, sp + splits, ... of the G x HD / 4; each reads the live
  // splits' partials from their blocks' shared memory and sums them in
  // split order, as the warps were.
  hop::cluster_sync();
  for (int i = sp * NT + tid; i < G * HD / 4; i += splits * NT) {
    const int r = 4 * i / HD, d = 4 * i - r * HD;
    float2 ml[MAX_SPLITS];
    float4 x[MAX_SPLITS];
#pragma unroll
    for (int k = 0; k < MAX_SPLITS; ++k)
      if (k < n_live) {
        ml[k] = hop::ld_cluster2(hop::at_rank(bml + r, k));
        x[k] = hop::ld_cluster4(hop::at_rank(bo + r * HD + d, k));
      }
    float mx = mma::neg_inf();
#pragma unroll
    for (int k = 0; k < MAX_SPLITS; ++k)
      if (k < n_live) mx = fmaxf(mx, ml[k].x);
    const float mbase = mx == mma::neg_inf() ? 0.f : mx;
    float den = 0.f, acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int k = 0; k < MAX_SPLITS; ++k)
      if (k < n_live) {
        const float w = exp2f(ml[k].x - mbase);
        den += w * ml[k].y;
        acc[0] += w * x[k].x;
        acc[1] += w * x[k].y;
        acc[2] += w * x[k].z;
        acc[3] += w * x[k].w;
      }
    const float dn = fmaxf(den, 1e-30f);
    *reinterpret_cast<uint2*>(out + q0 + (size_t)r * HD + d) =
        make_uint2(hop::pack_bf16(acc[0] / dn, acc[1] / dn),
                   hop::pack_bf16(acc[2] / dn, acc[3] / dn));
    if (lse != nullptr && d == 0)
      lse[(size_t)b * Hq + (size_t)h * G + r] =
          mx == mma::neg_inf() ? -1e30f
                               : (mx + log2f(den)) * 0.6931471805599453f;
  }
  // no block leaves while another still reads its shared memory
  hop::cluster_sync();
}

// Launch the Hopper body over a plan of `splits` splits of `tps` tiles;
// int8 with `k_scales` / `v_scales`, else those are null.
template <int HD, bool INT8>
static int launch_wg(const void* q, const void* kp, const void* vp,
                     const void* ks, const void* vs, const void* tables,
                     const void* lengths, void* out, float* lse, int B,
                     int Hq, int Hkv, int N, int page, int P, int tps,
                     int splits, float scale, cudaStream_t stream) {
  using namespace decode_wg;
  CUtensorMap tkp, tvp;
  const auto map = INT8 ? make_map_i8 : make_map;
  int rc = map(&tkp, kp, N, page, Hkv, HD, CHUNK);
  if (rc == 0) rc = map(&tvp, vp, N, page, Hkv, HD, CHUNK);
  if (rc != 0) return rc;
  // the scales are copied a 4-byte word at a time
  if (((uintptr_t)q | (uintptr_t)out) & 7 ||
      ((uintptr_t)ks | (uintptr_t)vs) & 3)
    return (int)cudaErrorMisalignedAddress;
  const int stages = min(Smem<HD, INT8>::STAGES, tps);
  const size_t smem = Smem<HD, INT8>::bytes(stages);
  auto kernel = paged_decode_wg<HD, INT8>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, Hkv, B);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = splits > 1 ? 1 : 0;  // one split: no cluster, no merge
  using bf16 = __nv_bfloat16;
  using u16 = unsigned short;
  err = cudaLaunchKernelEx(&cfg, kernel, tkp, tvp, (const bf16*)q,
                           (const u16*)ks, (const u16*)vs,
                           (const int*)tables, (const int*)lengths,
                           (bf16*)out, lse, Hq, Hkv, N, page, P, tps, stages,
                           scale * 1.4426950408889634f);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The Hopper plan check shared by both C entries: the plan must cover
// the window in at most a portable cluster.
static bool plan_ok(int tps, int splits, int page, int P) {
  return tps >= 1 && splits >= 1 && splits <= decode_wg::MAX_SPLITS &&
         (long long)splits * tps * decode_wg::KT >= (long long)P * page;
}

// The body `paged_decode` runs: 2, the Hopper body (`paged_decode_wg`:
// bf16 at hd 64 / 128, G <= 16, pages of 16 / 32 / 64, a window of 512 to
// 4096 tokens); 1, the bandwidth body (`paged_decode_tc`: bf16 at hd 16 -
// 128, G <= 16, any page and window); 0, the CUDA-core body.
static int decode_body(int Hq, int Hkv, int hd, int page, int P,
                       int q_dtype, int kv_dtype) {
  if (q_dtype != 1 || kv_dtype != 1 || !gqa_tc::width_ok(Hq, Hkv, hd))
    return 0;
  return (hd == 64 || hd == 128) && decode_wg::page_ok(page) &&
                 decode_wg::window_ok(P * page)
             ? 2
             : 1;
}

// ---------------------------------------------------------------------------
// int8 body (bf16 q, int8 pages, bf16 scales; block layout and tile code
// in gqa_tc.cuh)
// ---------------------------------------------------------------------------
namespace int8_tc {
using bf16 = __nv_bfloat16;

// Widen keys k0 .. k0+15 of the staged int8 K and V tiles (rows of HD
// bytes) into the warp's bf16 buffer: K in rows 0-15, V in rows 16-31,
// rows of HD + 8 (the `ldmatrix` stride of gqa_tc.cuh).
template <int HD>
__device__ __forceinline__ void widen_rows(const int8_t* kt, const int8_t* vt,
                                           int k0, bf16* buf, int lane) {
  constexpr int CH = HD / 16;  // 16-byte chunks of an int8 row
#pragma unroll
  for (int i = 0; i < CH; ++i) {
    const int c = lane + 32 * i, r = c / CH, cc = c - r * CH;
    const int8_t* src =
        (r < 16 ? kt + (k0 + r) * HD : vt + (k0 + r - 16) * HD) + cc * 16;
    const uint4 w = *reinterpret_cast<const uint4*>(src);
    const uint2 a = widen::four(w.x), b = widen::four(w.y),
                c2 = widen::four(w.z), d = widen::four(w.w);
    uint4* dst = reinterpret_cast<uint4*>(buf + r * (HD + 8) + cc * 16);
    dst[0] = make_uint4(a.x, a.y, b.x, b.y);
    dst[1] = make_uint4(c2.x, c2.y, d.x, d.y);
  }
}

// `warp_fold`'s hook: P' = p * (value scale of its key).  v[n] holds the
// scales of keys 8n + 2t and 8n + 2t + 1 of the warp's 16 (t = lane % 4),
// the keys of the fragment's columns.
struct ValueScale {
  float2 v[2];
  __device__ __forceinline__ void operator()(float (&p)[2][4]) const {
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) p[n][e] *= (e & 1) ? v[n].y : v[n].x;
  }
};

// Tiles of gqa_tc::KT = 64 keys, 16 a warp, as the bf16 body's.
constexpr int SC = 2 * gqa_tc::KT / gqa_tc::NT;  // scales a thread stages
static_assert(SC * gqa_tc::NT == 2 * gqa_tc::KT, "scales split evenly");

// One stage: K [KT][HD] int8, V [KT][HD] int8, then the tile's K and V
// scales [2][KT] float32.
template <int HD>
constexpr int tile_bytes = 2 * gqa_tc::KT * HD + 8 * gqa_tc::KT;

// The ring, then each warp's bf16 buffer of [K 16; V 16] rows of HD + 8;
// the merge reuses the space.
template <int HD>
constexpr size_t smem_bytes() {
  const size_t walk = gqa_tc::STAGES * (size_t)tile_bytes<HD> +
                      (size_t)(gqa_tc::NT / 32) * 32 * (HD + 8) * 2;
  const size_t merge = (size_t)(gqa_tc::NT / 32) * gqa_tc::RM * (HD + 2) * 4;
  return walk > merge ? walk : merge;
}
}  // namespace int8_tc

// Four blocks an SM up to hd 64; at hd 128 shared memory holds two, and
// a bound of four would cap the registers at 128 and spill.
template <int HD>
__global__ void __launch_bounds__(gqa_tc::NT, HD == 128 ? 2 : 4)
    paged_decode_int8_tc(const __nv_bfloat16* __restrict__ q,
                         const int8_t* __restrict__ k_pages,
                         const int8_t* __restrict__ v_pages,
                         const unsigned short* __restrict__ k_scales,
                         const unsigned short* __restrict__ v_scales,
                         const int* __restrict__ tables,
                         const int* __restrict__ lengths,
                         __nv_bfloat16* __restrict__ out,
                         float* __restrict__ lse, int Hq, int Hkv, int N,
                         int page, int P, float scale_log2) {
  using namespace gqa_tc;
  using bf16 = __nv_bfloat16;
  constexpr int SC = int8_tc::SC, TILE = int8_tc::tile_bytes<HD>;
  constexpr int LD = HD + 8, CH = HD / 16;  // bf16 row stride; int8 chunks
  extern __shared__ float4 gqa_smem[];
  char* ring = reinterpret_cast<char*>(gqa_smem);
  bf16* bufs = reinterpret_cast<bf16*>(ring + STAGES * TILE);
  const int b = blockIdx.x, h = blockIdx.y, G = Hq / Hkv;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int tq = lane & 3;
  bf16* wbuf = bufs + warp * 32 * LD;  // this warp's [K 16; V 16] rows
  bf16* sq = bufs;                     // Q in warp 0's buffer until the walk
  const int end = min(max(lengths[b], 0), P * page);
  const int nt = (end + KT - 1) / KT;
  const int* trow = tables + (size_t)b * P;
  const size_t q0 = ((size_t)b * Hq + (size_t)h * G) * HD;

  for (int c = tid; c < RM * (HD / 8); c += NT) {
    const int r = c / (HD / 8), col = (c - r * (HD / 8)) * 8;
    mma::cp_async16(sq + r * LD + col, q + q0 + (r < G ? r * HD + col : 0),
                    r < G);
  }
  const auto slot = [&](int pos) {
    const int pid = min(max(trow[pos / page], 0), N - 1);
    return ((size_t)pid * page + pos % page) * Hkv + h;
  };
  auto stage = [&](int t) {
    int8_t* dst = reinterpret_cast<int8_t*>(ring + (t % STAGES) * TILE);
    for (int c = tid; c < KT * CH; c += NT) {
      const int j = c / CH, cc = c - j * CH, pos = t * KT + j;
      const bool ok = pos < end;
      const size_t off = ok ? slot(pos) * HD + cc * 16 : 0;
      mma::cp_async16(dst + j * HD + cc * 16, k_pages + off, ok);
      mma::cp_async16(dst + (KT + j) * HD + cc * 16, v_pages + off, ok);
    }
  };
  // Entry i < KT of a tile's scales is key i's K scale, entry KT + i its
  // V scale; thread tid holds entries tid + NT u as raw bf16 (0 past the
  // length: never loaded), so the loads stay in flight until the store.
  auto load_scales = [&](int t, unsigned short (&r)[SC]) {
#pragma unroll
    for (int u = 0; u < SC; ++u) {
      const int i = tid + NT * u, j = i % KT, pos = t * KT + j;
      r[u] = 0;
      if (pos < end) r[u] = (i < KT ? k_scales : v_scales)[slot(pos)];
    }
  };
  auto store_scales = [&](int t, const unsigned short (&r)[SC]) {
    float* dst = reinterpret_cast<float*>(ring + (t % STAGES) * TILE +
                                          2 * KT * HD);
#pragma unroll
    for (int u = 0; u < SC; ++u)
      dst[tid + NT * u] = __uint_as_float((uint32_t)r[u] << 16);
  };
  stage(0);
  mma::cp_async_commit();  // Q and tile 0
  if (nt > 1) stage(1);
  mma::cp_async_commit();
  unsigned short sc_next[SC];  // tile t + 1's scales, stored after tile t
  load_scales(0, sc_next);
  store_scales(0, sc_next);
  load_scales(1, sc_next);

  uint32_t qa[HD / 16][4];  // Q as A fragments, rows >= G zero
  float o[HD / 8][4], m[2], l[2];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  m[0] = m[1] = mma::neg_inf();
  l[0] = l[1] = 0.f;
  mma::cp_async_wait<1>();
  __syncthreads();
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
    mma::ldsm_x4(qa[kk], mma::a_frag_addr(sq, LD, 0, kk * 16, lane));

  for (int t = 0; t < nt; ++t) {
    mma::cp_async_wait<1>();
    __syncthreads();  // tile t and its scales staged; tile t - 1 done
    if (t + 2 < nt) stage(t + 2);
    mma::cp_async_commit();
    unsigned short sc_after[SC];
    load_scales(t + 2, sc_after);
    const char* st = ring + (t % STAGES) * TILE;
    const int8_t* kt8 = reinterpret_cast<const int8_t*>(st);
    const float* ksc = reinterpret_cast<const float*>(st + 2 * KT * HD);
    const int k0 = warp * 16;  // this warp's keys of the tile
    __syncwarp();  // the warp is done with its buffer's previous keys
    int8_tc::widen_rows<HD>(kt8, kt8 + KT * HD, k0, wbuf, lane);
    __syncwarp();
    float s[2][4];
    gqa_tc::warp_scores<HD>(qa, wbuf, 0, lane, s);
    const int kpos = t * KT + k0 + 2 * tq;
    int8_tc::ValueScale vs;
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      const float2 ks =
          *reinterpret_cast<const float2*>(ksc + k0 + n * 8 + 2 * tq);
      vs.v[n] =
          *reinterpret_cast<const float2*>(ksc + KT + k0 + n * 8 + 2 * tq);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[n][e] = kpos + n * 8 + (e & 1) < end
                      ? s[n][e] * ((e & 1) ? ks.y : ks.x) * scale_log2
                      : mma::neg_inf();
    }
    gqa_tc::warp_fold<HD>(s, wbuf + 16 * LD, 0, lane, m, l, o, vs);
    if (t + 1 < nt) store_scales(t + 1, sc_next);
#pragma unroll
    for (int u = 0; u < SC; ++u) sc_next[u] = sc_after[u];
  }

  gqa_tc::merge_warps<HD>(
      reinterpret_cast<float*>(ring), m, l, o, G,
      [&](int r, int d, float x) {
        out[q0 + r * HD + d] = __float2bfloat16(x);
      },
      lse == nullptr ? nullptr : lse + (size_t)b * Hq + (size_t)h * G);
}

template <int HD>
static int launch_int8_tc(const void* q, const void* kp, const void* vp,
                          const void* ks, const void* vs, const void* tables,
                          const void* lengths, void* out, float* lse,
                          int B, int Hq, int Hkv, int N, int page, int P,
                          float scale, cudaStream_t stream) {
  const size_t smem = int8_tc::smem_bytes<HD>();
  auto kernel = paged_decode_int8_tc<HD>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  using bf16 = __nv_bfloat16;
  kernel<<<dim3(B, Hkv), gqa_tc::NT, smem, stream>>>(
      (const bf16*)q, (const int8_t*)kp, (const int8_t*)vp,
      (const unsigned short*)ks, (const unsigned short*)vs,
      (const int*)tables, (const int*)lengths, (bf16*)out, lse, Hq, Hkv, N,
      page, P, scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

static int decode_int8_tc(const void* q, const void* kp, const void* vp,
                          const void* ks, const void* vs, const void* tables,
                          const void* lengths, void* out, float* lse, int B,
                          int Hq, int Hkv, int hd, int N, int page, int P,
                          float scale, cudaStream_t st) {
  // the 16-byte copies need 16-byte aligned q and pages
  if (((uintptr_t)q | (uintptr_t)kp | (uintptr_t)vp) & 15)
    return (int)cudaErrorMisalignedAddress;
  switch (hd) {
    case 16:
      return launch_int8_tc<16>(q, kp, vp, ks, vs, tables, lengths, out, lse,
                                B, Hq, Hkv, N, page, P, scale, st);
    case 32:
      return launch_int8_tc<32>(q, kp, vp, ks, vs, tables, lengths, out, lse,
                                B, Hq, Hkv, N, page, P, scale, st);
    case 64:
      return launch_int8_tc<64>(q, kp, vp, ks, vs, tables, lengths, out, lse,
                                B, Hq, Hkv, N, page, P, scale, st);
    case 128:
      return launch_int8_tc<128>(q, kp, vp, ks, vs, tables, lengths, out, lse,
                                 B, Hq, Hkv, N, page, P, scale, st);
  }
  return (int)cudaErrorInvalidValue;
}

// dtype codes: 0 = float32, 1 = bfloat16.  `lse_out` is NULL or [B,Hq]
// float32.  tps / splits: the host's split plan (kernels/
// paged_attention.py `decode_split_plan`), read by the Hopper body alone.
extern "C" int paged_decode(const void* q, const void* k_pages,
                            const void* v_pages, const void* tables,
                            const void* lengths, void* out, void* lse_out,
                            int B, int Hq, int Hkv, int hd, int N, int page,
                            int P, int tps, int splits, float scale,
                            int q_dtype, int kv_dtype, void* stream) {
  if (B == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  float* lse = (float*)lse_out;
  if (q_dtype == 1 && kv_dtype == 1) {
    const int body = decode_body(Hq, Hkv, hd, page, P, q_dtype, kv_dtype);
    if (body == 2) {
      if (!plan_ok(tps, splits, page, P)) return (int)cudaErrorInvalidValue;
      if (hd == 64)
        return launch_wg<64, false>(q, k_pages, v_pages, nullptr, nullptr,
                                    tables, lengths, out, lse, B, Hq, Hkv, N,
                                    page, P, tps, splits, scale, st);
      return launch_wg<128, false>(q, k_pages, v_pages, nullptr, nullptr,
                                   tables, lengths, out, lse, B, Hq, Hkv, N,
                                   page, P, tps, splits, scale, st);
    }
    if (body == 1)
      return decode_tc(q, k_pages, v_pages, tables, lengths, out, lse, B, Hq,
                       Hkv, hd, N, page, P, scale, st);
    return launch<__nv_bfloat16, __nv_bfloat16, false>(
        q, k_pages, v_pages, nullptr, nullptr, tables, lengths, out, lse, B,
        Hq, Hkv, hd, N, page, P, scale, st);
  }
  if (q_dtype == 0 && kv_dtype == 1)
    return launch<float, __nv_bfloat16, false>(
        q, k_pages, v_pages, nullptr, nullptr, tables, lengths, out, lse, B,
        Hq, Hkv, hd, N, page, P, scale, st);
  if (q_dtype == 0 && kv_dtype == 0)
    return launch<float, float, false>(q, k_pages, v_pages, nullptr, nullptr,
                                       tables, lengths, out, lse, B, Hq, Hkv,
                                       hd, N, page, P, scale, st);
  return (int)cudaErrorInvalidValue;
}

// int8 pages, bf16 scales; q_dtype and `lse_out` as above; tps / splits
// the Hopper body's plan as for paged_decode.
extern "C" int paged_decode_int8(const void* q, const void* k_pages,
                                 const void* v_pages, const void* k_scales,
                                 const void* v_scales, const void* tables,
                                 const void* lengths, void* out,
                                 void* lse_out, int B, int Hq, int Hkv,
                                 int hd, int N, int page, int P, int tps,
                                 int splits, float scale, int q_dtype,
                                 void* stream) {
  if (B == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  float* lse = (float*)lse_out;
  // the bf16 decode's gate, with a bf16 query
  const int body = decode_body(Hq, Hkv, hd, page, P, q_dtype, 1);
  if (body == 2) {
    if (!plan_ok(tps, splits, page, P)) return (int)cudaErrorInvalidValue;
    if (hd == 64)
      return launch_wg<64, true>(q, k_pages, v_pages, k_scales, v_scales,
                                 tables, lengths, out, lse, B, Hq, Hkv, N,
                                 page, P, tps, splits, scale, st);
    return launch_wg<128, true>(q, k_pages, v_pages, k_scales, v_scales,
                                tables, lengths, out, lse, B, Hq, Hkv, N,
                                page, P, tps, splits, scale, st);
  }
  if (body == 1)
    return decode_int8_tc(q, k_pages, v_pages, k_scales, v_scales, tables,
                          lengths, out, lse, B, Hq, Hkv, hd, N, page, P,
                          scale, st);
  if (q_dtype == 1)
    return launch<__nv_bfloat16, int8_t, true>(
        q, k_pages, v_pages, k_scales, v_scales, tables, lengths, out, lse, B,
        Hq, Hkv, hd, N, page, P, scale, st);
  if (q_dtype == 0)
    return launch<float, int8_t, true>(q, k_pages, v_pages, k_scales,
                                       v_scales, tables, lengths, out, lse, B,
                                       Hq, Hkv, hd, N, page, P, scale, st);
  return (int)cudaErrorInvalidValue;
}

// The body paged_decode runs: 2 the Hopper body (`paged_decode_wg`), 1
// the bandwidth body (`paged_decode_tc`), 0 the CUDA cores.
extern "C" int paged_decode_body(int Hq, int Hkv, int hd, int page, int P,
                                 int q_dtype, int kv_dtype) {
  return decode_body(Hq, Hkv, hd, page, P, q_dtype, kv_dtype);
}

// 1 when paged_decode runs a tensor-core body (the Hopper body or the
// bandwidth body, bf16 mma.sync) for these types and widths.
extern "C" int paged_decode_tensor_core(int Hq, int Hkv, int hd, int q_dtype,
                                        int kv_dtype) {
  return q_dtype == 1 && kv_dtype == 1 && gqa_tc::width_ok(Hq, Hkv, hd);
}

// The body paged_decode_int8 runs: 2 the Hopper body
// (`paged_decode_wg<HD, true>`), 1 the int8 body (`paged_decode_int8_tc`),
// 0 the CUDA cores.
extern "C" int paged_decode_int8_body(int Hq, int Hkv, int hd, int page,
                                      int P, int q_dtype) {
  return decode_body(Hq, Hkv, hd, page, P, q_dtype, 1);
}

// 1 when paged_decode_int8 runs a tensor-core body (the Hopper body or
// the int8 body, bf16 mma.sync over tiles widened from int8) for this
// query type and these widths.
extern "C" int paged_decode_int8_tensor_core(int Hq, int Hkv, int hd,
                                             int q_dtype) {
  return q_dtype == 1 && gqa_tc::width_ok(Hq, Hkv, hd);
}
