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
path's sizes by the latency of a short walk of key tiles), the MLA ones
by their operations; bf16 inputs run tensor-core bodies (see the source
notes).  On CPU tensors the wrappers run the plain versions in
``kernels/ref.py``.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import abstract, build, ref
from repro_torch.kernels.backend import resolve_backend
from repro_torch.kernels.mla_paged_decode import check_mla_args
from repro_torch.kernels.paged_attention import (DTYPE_CODES, FLT, INT,
                                                 PTR, check_args, stream_ptr)

# q, k/v chunk, k/v pages, tables, offsets or positions, out;
# B, C, Hq, Hkv, hd, N, page, P; scale; q and kv dtype codes; stream
PREFILL_ARGS = [PTR] * 8 + [INT] * 8 + [FLT, INT, INT, PTR]


def _launch(entry: str, q, k_chunk, v_chunk, k_pages, v_pages,
            block_tables, where) -> torch.Tensor:
    b, c, hq, hd = q.shape
    n, page, hkv, _ = k_pages.shape
    if (q.dim() != 4 or k_chunk.shape != (b, c, hkv, hd)
            or v_chunk.shape != k_chunk.shape
            or block_tables.shape[0] != b):
        raise ValueError(f"{entry}: q [B,C,Hq,hd], k/v chunk [B,C,Hkv,hd], "
                         f"tables [B,P]")
    out = torch.empty_like(q)
    fn = build.entry("paged_prefill", entry, PREFILL_ARGS)
    rc = fn(*(t.data_ptr() for t in (q, k_chunk, v_chunk, k_pages, v_pages,
                                     block_tables, where, out)),
            b, c, hq, hkv, hd, n, page, block_tables.shape[1],
            1.0 / math.sqrt(hd), DTYPE_CODES[q.dtype],
            DTYPE_CODES[k_pages.dtype], stream_ptr(q.device))
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
# B, C, Hq, dl, dr, N, page, P; scale; q and pool dtype codes; stream
MLA_PREFILL_ARGS = [PTR] * 7 + [INT] * 8 + [FLT, INT, INT, PTR]


def _launch_mla(entry: str, q_lat, q_rope, lat_chunk, latent_pages,
                block_tables, where, d_latent, scale) -> torch.Tensor:
    b, c, hq, dl = q_lat.shape
    dr = q_rope.shape[-1]
    n, page, _ = latent_pages.shape
    if (q_lat.dim() != 4 or lat_chunk.shape != (b, c, dl + dr)
            or block_tables.shape[0] != b):
        raise ValueError(f"{entry}: q_lat [B,C,Hq,dl], lat_chunk "
                         f"[B,C,dl+dr], tables [B,P]")
    out = torch.empty_like(q_lat)
    fn = build.entry("mla_paged_prefill", entry, MLA_PREFILL_ARGS)
    rc = fn(*(t.data_ptr() for t in (q_lat, q_rope, lat_chunk, latent_pages,
                                     block_tables, where, out)),
            b, c, hq, dl, dr, n, page, block_tables.shape[1],
            ref.mla_scale(dl, dr, scale), DTYPE_CODES[q_lat.dtype],
            DTYPE_CODES[latent_pages.dtype], stream_ptr(q_lat.device))
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
