"""Chunked prefill and segment prefill over the paged pool: the CUDA
kernels in ``csrc/paged_prefill.cu`` (GQA / MHA / MQA) and
``csrc/mla_paged_prefill.cu`` (absorbed MLA over the latent pool) and
their wrappers.

Replace the Pallas TPU kernels ``paged_prefill_attention``,
``paged_prefill_segments``, ``mla_paged_prefill`` and
``mla_paged_prefill_segments`` (``repro/kernels/paged_prefill.py``).  A
chunk of C queries attends resident pool tokens through the block table
plus its own densely passed keys, causally by index; the caller
scatters the chunk's KV into the pool afterwards.  The GQA kernels are
bound by the HBM bytes of the pool pages they read (at the serving
path's sizes by the latency of their dependent reads and of the key
tiles a block walks in turn), the MLA ones by their operations; bf16
inputs run tensor-core bodies (see the source notes).  On CPU tensors
the wrappers run the plain versions in ``kernels/ref.py``.

The GQA kernels' bodies by type, width and page size (``body`` asks the
C entry):

=====================================  ==============================
inputs                                 body
=====================================  ==============================
bf16, hd 64 / 128, G <= 16, pages of   ``wgmma`` (``paged_prefill_wg``:
16 / 32 / 64 tokens                    TMA page gathers, a split walk)
bf16, hd 16 - 128, G <= 16, other      ``tensor_core``
pages (hd 16 / 32: every page)         (``paged_prefill_tc``,
                                       ``mma.sync``)
float32; bf16 otherwise                ``cuda_core``
=====================================  ==============================

The ``wgmma`` body cuts each query block's key walk into splits chosen
on the host by ``prefill_split_plan`` from B, C, Hq, Hkv, hd, page and
the table window alone (the host never reads the offsets or positions):
pool splits of ``tiles`` 64-key tiles, then the chunk's own keys in
splits of their own.  The splits of a query block run as one thread
block cluster: each block keeps its float32 partial in its shared
memory and the cluster merges them in split order through distributed
shared memory, so the wrapper allocates no scratch.

The MLA kernels' bodies (``mla_body``): bf16 at DeepSeek-V3's widths
(dl 512, dr 64) over 64-token pages run ``wgmma`` (``mla_prefill_wg``:
the MLA decode's Hopper block walking one query's 64-token pool pages
and 64-row chunk tiles, no split); bf16 at other widths or pages
``tensor_core`` (``mla_tc_kernel``, ``mma.sync``); float32
``cuda_core``.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Tuple

import torch

from repro_torch.kernels import abstract, build, ref
from repro_torch.kernels.backend import resolve_backend
from repro_torch.kernels.flash_prefill import _tma_ready
from repro_torch.kernels.mla_paged_decode import check_mla_args
from repro_torch.kernels.paged_attention import (DTYPE_CODES, FLT, INT,
                                                 PTR, check_args, stream_ptr)

# q, k/v chunk, k/v pages, tables, offsets or positions, out; B, C, Hq,
# Hkv, hd, N, page, P, tiles a split, pool splits, splits; scale; q and
# kv dtype codes; stream
PREFILL_ARGS = [PTR] * 8 + [INT] * 11 + [FLT, INT, INT, PTR]
BODIES = {0: "cuda_core", 1: "tensor_core", 2: "wgmma"}

# The `wgmma` body's split plan: a block holds QUERY_ROWS rows (64 // G
# queries x G heads of one KV head, the M of one `wgmma` warpgroup) and
# walks whole tiles of KEY_TILE keys; a split takes the fewest tiles, at
# least MIN_SPLIT_TILES, that keep the grid within SPLIT_BLOCKS[hd]
# blocks (half of what the H100's 132 SMs hold at once: three blocks an
# SM at hd 64, two at hd 128, by shared memory) and each query block
# within MAX_SPLITS splits (one portable cluster)
KEY_TILE = 64
QUERY_ROWS = 64
SPLIT_BLOCKS = {64: 192, 128: 132}
MIN_SPLIT_TILES = 2
MAX_SPLITS = 8


class PrefillPlan(NamedTuple):
    """How the `wgmma` body cuts the key walk of a chunk call: per query
    block, ``pool_splits`` splits of ``tiles`` pool tiles over the table
    window, then ``chunk_splits`` of the chunk's own keys."""
    tiles: int              # 64-key tiles a split
    pool_splits: int
    chunk_splits: int
    queries: int            # queries a block: 64 // G
    query_blocks: int
    groups: int             # B * Hkv * query_blocks: one cluster each
    window: int             # P * page
    c: int
    hd: int

    @property
    def splits(self) -> int:
        return self.pool_splits + self.chunk_splits

    @property
    def blocks(self) -> int:
        return self.groups * self.splits

    @property
    def partial_bytes(self) -> int:
        """The float32 partials (each block's unnormalised output and (m,
        l) for its 64 rows) held in shared memory and merged across each
        cluster."""
        return self.blocks * QUERY_ROWS * (self.hd + 2) * 4

    def split_keys(self, split: int) -> Tuple[str, int, int]:
        """("pool", start, stop) pool positions or ("chunk", start, stop)
        chunk indices of split ``split``'s keys."""
        span = self.tiles * KEY_TILE
        if split < self.pool_splits:
            return ("pool", split * span, min((split + 1) * span,
                                              self.window))
        k = split - self.pool_splits
        return ("chunk", k * span, min((k + 1) * span, self.c))

    def live_splits(self, end: int, query_block: int) -> int:
        """Splits a block of query block ``query_block`` walks when its
        row reads pool positions < ``end`` (the offset, or the segment
        chunk's pool limit); the others walk nothing."""
        span = self.tiles * KEY_TILE
        end = min(max(end, 0), self.window)
        n_keys = min(self.c, (query_block + 1) * self.queries)
        return -(-end // span) + -(-n_keys // span)


@functools.lru_cache(maxsize=None)
def prefill_split_plan(b: int, c: int, hq: int, hkv: int, hd: int,
                       page: int, p: int) -> PrefillPlan:
    """The `wgmma` body's split plan for a call on q [b, c, hq, hd] over
    k/v pages [N, page, hkv, hd] with tables [b, p]: ints only, so the
    host reads nothing of the device."""
    args = (b, c, hq, hkv, hd, page, p)
    if not all(isinstance(x, int) for x in args):
        raise TypeError("prefill_split_plan takes ints (the shapes), "
                        f"got {[type(x).__name__ for x in args]}")
    queries = QUERY_ROWS // (hq // hkv)
    query_blocks = -(-c // queries)
    groups = b * hkv * query_blocks
    window = p * page
    pool_tiles, chunk_tiles = -(-window // KEY_TILE), -(-c // KEY_TILE)
    # narrower widths (the CPU emulation's) plan as hd 64
    limit = SPLIT_BLOCKS[128 if hd > 64 else 64]
    tiles = MIN_SPLIT_TILES
    while True:
        splits = -(-pool_tiles // tiles) + -(-chunk_tiles // tiles)
        if splits <= 2 or (splits <= MAX_SPLITS
                           and groups * splits <= limit):
            break
        tiles += 1
    return PrefillPlan(tiles=tiles, pool_splits=-(-pool_tiles // tiles),
                       chunk_splits=-(-chunk_tiles // tiles),
                       queries=queries, query_blocks=query_blocks,
                       groups=groups, window=window, c=c, hd=hd)


@functools.lru_cache(maxsize=None)
def body(hq: int, hkv: int, hd: int, page: int, q_dtype: int,
         kv_dtype: int) -> str:
    """The body the GQA chunk prefill's C entries run: "wgmma",
    "tensor_core" (``mma.sync``) or "cuda_core"."""
    fn = build.entry("paged_prefill", "paged_prefill_body",
                     [ctypes.c_int] * 6)
    return BODIES[fn(hq, hkv, hd, page, q_dtype, kv_dtype)]


def _launch(entry: str, q, k_chunk, v_chunk, k_pages, v_pages,
            block_tables, where, plan: PrefillPlan | None = None
            ) -> torch.Tensor:
    """Launch C entry ``entry``; ``plan`` replaces the `wgmma` body's
    default split plan (an A/B of plans passes one)."""
    b, c, hq, hd = q.shape
    n, page, hkv, _ = k_pages.shape
    if (q.dim() != 4 or k_chunk.shape != (b, c, hkv, hd)
            or v_chunk.shape != k_chunk.shape
            or block_tables.shape[0] != b):
        raise ValueError(f"{entry}: q [B,C,Hq,hd], k/v chunk [B,C,Hkv,hd], "
                         f"tables [B,P]")
    qd, kd = DTYPE_CODES[q.dtype], DTYPE_CODES[k_pages.dtype]
    p = block_tables.shape[1]
    ints = (0, 0, 0)
    if body(hq, hkv, hd, page, qd, kd) == "wgmma":
        plan = plan or prefill_split_plan(b, c, hq, hkv, hd, page, p)
        q, k_chunk, v_chunk, k_pages, v_pages = _tma_ready(
            q, k_chunk, v_chunk, k_pages, v_pages)
        ints = (plan.tiles, plan.pool_splits, plan.splits)
    out = torch.empty_like(q)
    fn = build.entry("paged_prefill", entry, PREFILL_ARGS)
    rc = fn(*(t.data_ptr() for t in (q, k_chunk, v_chunk, k_pages, v_pages,
                                     block_tables, where, out)),
            b, c, hq, hkv, hd, n, page, p, *ints, 1.0 / math.sqrt(hd), qd,
            kd, stream_ptr(q.device))
    build.check(rc, "paged_prefill", entry)
    return out


def paged_prefill_attention(q: torch.Tensor, k_chunk: torch.Tensor,
                            v_chunk: torch.Tensor, k_pages: torch.Tensor,
                            v_pages: torch.Tensor, block_tables: torch.Tensor,
                            offsets: torch.Tensor,
                            backend: str | None = None) -> torch.Tensor:
    """q [B,C,Hq,hd]; k/v_chunk [B,C,Hkv,hd]; k/v_pages [N,page,Hkv,hd];
    block_tables [B,P] int32; offsets [B] int32 -> [B,C,Hq,hd].  Query i
    of row b sits at offsets[b] + i: it attends pool tokens < offsets[b]
    plus chunk tokens j <= i."""
    be = resolve_backend(backend, q)
    if be == "abstract":
        return abstract.paged_prefill("paged_prefill", q, k_chunk, k_pages,
                                      block_tables)
    if be == "torch":
        return ref.paged_prefill_attention(q, k_chunk, v_chunk, k_pages,
                                           v_pages, block_tables, offsets)
    check_args("paged_prefill", q, k_pages, v_pages, block_tables, offsets,
               tensors=(k_chunk, v_chunk))
    if offsets.shape != (q.shape[0],):
        raise ValueError("paged_prefill: offsets [B]")
    out = _launch("paged_prefill", q, k_chunk, v_chunk, k_pages, v_pages,
                  block_tables, offsets)
    paged_prefill_attention.launches += 1
    return out


def paged_prefill_segments(q: torch.Tensor, k_chunk: torch.Tensor,
                           v_chunk: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, block_tables: torch.Tensor,
                           chunk_positions: torch.Tensor,
                           backend: str | None = None) -> torch.Tensor:
    """As ``paged_prefill_attention`` with per-query absolute positions
    (``chunk_positions`` [B,C] int32, ascending among valid entries,
    negative = padding): query i attends pool tokens below its own
    position except the slots the chunk will fill, plus chunk tokens
    j <= i.  The row's page walk stops at ``ref.pool_limits``."""
    be = resolve_backend(backend, q)
    if be == "abstract":
        return abstract.paged_prefill("paged_prefill_seg", q, k_chunk,
                                      k_pages, block_tables)
    if be == "torch":
        return ref.paged_prefill_segments(q, k_chunk, v_chunk, k_pages,
                                          v_pages, block_tables,
                                          chunk_positions)
    check_args("paged_prefill_seg", q, k_pages, v_pages, block_tables,
               chunk_positions, tensors=(k_chunk, v_chunk))
    if chunk_positions.shape != q.shape[:2]:
        raise ValueError("paged_prefill_seg: chunk_positions [B,C]")
    out = _launch("paged_prefill_seg", q, k_chunk, v_chunk, k_pages,
                  v_pages, block_tables, chunk_positions)
    paged_prefill_segments.launches += 1
    return out


# q_lat, q_rope, lat_chunk, pages, tables, offsets or positions, out;
# B, C, Hq, dl, dr, N, page, P; scale; the `wgmma` body's launch order;
# q and pool dtype codes; stream
MLA_PREFILL_ARGS = [PTR] * 7 + [INT] * 8 + [FLT, INT, INT, INT, PTR]


@functools.lru_cache(maxsize=None)
def mla_body(dl: int, dr: int, n_cp: int, page: int, q_dtype: int,
             kv_dtype: int) -> str:
    """The body the MLA chunk prefill's C entries run (``n_cp``: the
    chunk length of a segment call, 0 for the offset one): "wgmma"
    (``mla_prefill_wg``: dl 512, dr 64, 64-token pages), "tensor_core"
    (``mma.sync``) or "cuda_core"."""
    fn = build.entry("mla_paged_prefill", "mla_paged_prefill_tensor_core",
                     [ctypes.c_int] * 6)
    return BODIES[fn(dl, dr, n_cp, page, q_dtype, kv_dtype)]


def _launch_mla(entry: str, q_lat, q_rope, lat_chunk, latent_pages,
                block_tables, where, d_latent, scale,
                longest_first: int = -1) -> torch.Tensor:
    """Launch C entry ``entry``; ``longest_first`` 1 / 0 fixes the
    `wgmma` body's launch order (query C - 1 or 0 first) where -1 lets
    the entry choose by shape (an A/B of orders passes one)."""
    b, c, hq, dl = q_lat.shape
    dr = q_rope.shape[-1]
    n, page, _ = latent_pages.shape
    if (q_lat.dim() != 4 or lat_chunk.shape != (b, c, dl + dr)
            or block_tables.shape[0] != b):
        raise ValueError(f"{entry}: q_lat [B,C,Hq,dl], lat_chunk "
                         f"[B,C,dl+dr], tables [B,P]")
    qd, kd = DTYPE_CODES[q_lat.dtype], DTYPE_CODES[latent_pages.dtype]
    n_cp = c if entry == "mla_paged_prefill_seg" else 0
    if mla_body(dl, dr, n_cp, page, qd, kd) == "wgmma":
        q_lat, q_rope, lat_chunk, latent_pages = _tma_ready(
            q_lat, q_rope, lat_chunk, latent_pages)
    out = torch.empty_like(q_lat)
    fn = build.entry("mla_paged_prefill", entry, MLA_PREFILL_ARGS)
    rc = fn(*(t.data_ptr() for t in (q_lat, q_rope, lat_chunk, latent_pages,
                                     block_tables, where, out)),
            b, c, hq, dl, dr, n, page, block_tables.shape[1],
            ref.mla_scale(dl, dr, scale), longest_first, qd, kd,
            stream_ptr(q_lat.device))
    build.check(rc, "mla_paged_prefill", entry)
    return out


def mla_paged_prefill(q_lat: torch.Tensor, q_rope: torch.Tensor,
                      lat_chunk: torch.Tensor, latent_pages: torch.Tensor,
                      block_tables: torch.Tensor, offsets: torch.Tensor, *,
                      d_latent: int, scale: float | None = None,
                      backend: str | None = None) -> torch.Tensor:
    """q_lat [B,C,Hq,dl]; q_rope [B,C,Hq,dr]; lat_chunk [B,C,dl+dr];
    latent_pages [N,page,dl+dr]; block_tables [B,P] int32; offsets [B]
    int32 -> ctx [B,C,Hq,dl].  Query i of row b sits at offsets[b] + i:
    it attends pool tokens < offsets[b] plus chunk tokens j <= i."""
    be = resolve_backend(backend, q_lat)
    if be == "abstract":
        return abstract.mla("mla_paged_prefill", q_lat, q_rope,
                            latent_pages, block_tables, offsets, lat_chunk)
    if be == "torch":
        return ref.mla_paged_prefill(q_lat, q_rope, lat_chunk, latent_pages,
                                     block_tables, offsets, d_latent, scale)
    check_mla_args("mla_paged_prefill", q_lat, q_rope, latent_pages,
                   block_tables, d_latent, offsets, tensors=(lat_chunk,))
    if offsets.shape != (q_lat.shape[0],):
        raise ValueError("mla_paged_prefill: offsets [B]")
    out = _launch_mla("mla_paged_prefill", q_lat, q_rope, lat_chunk,
                      latent_pages, block_tables, offsets, d_latent, scale)
    mla_paged_prefill.launches += 1
    return out


def mla_paged_prefill_segments(q_lat: torch.Tensor, q_rope: torch.Tensor,
                               lat_chunk: torch.Tensor,
                               latent_pages: torch.Tensor,
                               block_tables: torch.Tensor,
                               chunk_positions: torch.Tensor, *,
                               d_latent: int, scale: float | None = None,
                               backend: str | None = None) -> torch.Tensor:
    """As ``mla_paged_prefill`` with per-query absolute positions
    (``chunk_positions`` [B,C] int32, ascending among valid entries,
    negative = padding), the semantics of ``paged_prefill_segments``."""
    be = resolve_backend(backend, q_lat)
    if be == "abstract":
        return abstract.mla("mla_paged_prefill_seg", q_lat, q_rope,
                            latent_pages, block_tables, chunk_positions,
                            lat_chunk)
    if be == "torch":
        return ref.mla_paged_prefill_segments(
            q_lat, q_rope, lat_chunk, latent_pages, block_tables,
            chunk_positions, d_latent, scale)
    check_mla_args("mla_paged_prefill_seg", q_lat, q_rope, latent_pages,
                   block_tables, d_latent, chunk_positions,
                   tensors=(lat_chunk,))
    if chunk_positions.shape != q_lat.shape[:2]:
        raise ValueError("mla_paged_prefill_seg: chunk_positions [B,C]")
    out = _launch_mla("mla_paged_prefill_seg", q_lat, q_rope, lat_chunk,
                      latent_pages, block_tables, chunk_positions, d_latent,
                      scale)
    mla_paged_prefill_segments.launches += 1
    return out


paged_prefill_attention.launches = 0
paged_prefill_segments.launches = 0
mla_paged_prefill.launches = 0
mla_paged_prefill_segments.launches = 0
