"""Absorbed-MLA paged decode: the CUDA kernel ``csrc/mla_paged_decode.cu``
and its wrapper.

Replaces the Pallas TPU kernel ``mla_paged_decode``
(``repro/kernels/mla_paged_decode.py``).  Each batch row's query heads,
with ``W_uk`` absorbed into them (``q_lat`` [B,Hq,dl]) beside their RoPE
part (``q_rope`` [B,Hq,dr]), attend the row's latent pool tokens below
its length through the block table and return the latent-space context
[B,Hq,dl]; the caller applies ``W_uv`` and the output projection.  On
CPU tensors the wrapper runs the plain version in ``kernels/ref.py``.

For bf16 at the tensor-core widths the kernel splits each row's key walk
into splits of ``decode_split_tokens(P * page)`` tokens, chosen from the
table window alone (the host never reads ``lengths``), and merges the
float32 partials of a row of several splits in a second kernel; the
wrapper allocates those partials.  ``body`` names the body the C entry
runs: "wgmma" (``mla_decode_wg``: DeepSeek-V3's widths, dl 512 and dr
64, over 64-token pages), "tensor_core" (``mla_tc_kernel``, `mma.sync`,
the other tensor-core widths and pages) or "cuda_core".
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import abstract, build, ref
from repro_torch.kernels.backend import resolve_backend
from repro_torch.kernels.paged_attention import (DTYPE_CODES, FLT, INT, PTR,
                                                 SUPPORTED, stream_ptr)

# the kernels keep dl / 256 value columns a thread in registers
MAX_D_LATENT = 512
# q_lat, q_rope, pages, tables, lengths, out, partials; B, Hq, dl, dr, N,
# page, P; scale; tokens a split; q and pool dtype codes; stream
MLA_DECODE_ARGS = [PTR] * 7 + [INT] * 7 + [FLT, INT, INT, INT, PTR]
# the tensor-core bodies' split plan: 512 tokens (8 of the `wgmma` body's
# 64-token pages) a split, at most 16 splits a row (longer windows take
# longer splits)
SPLIT_TOKENS = 512
MAX_SPLITS = 16


def decode_split_tokens(window: int) -> int:
    """Tokens a split of the key walk over a table window of ``window``
    (= P * page) tokens."""
    return SPLIT_TOKENS * max(1, -(-window // (SPLIT_TOKENS * MAX_SPLITS)))


def decode_splits(window: int) -> int:
    """Splits of the grid (a row uses ceil(min(length, window) / split)
    of them, at least one)."""
    return max(1, -(-window // decode_split_tokens(window)))


BODIES = {0: "cuda_core", 1: "tensor_core", 2: "wgmma"}


@functools.lru_cache(maxsize=None)
def body(dl: int, dr: int, page: int, q_dtype: int, kv_dtype: int) -> str:
    """The body the C entry runs for these widths, page size and dtype
    codes: "wgmma", "tensor_core" (``mma.sync``) or "cuda_core"."""
    fn = build.entry("mla_paged_decode", "mla_paged_decode_body",
                     [ctypes.c_int] * 5)
    return BODIES[fn(dl, dr, page, q_dtype, kv_dtype)]


def check_mla_args(name: str, q_lat: torch.Tensor, q_rope: torch.Tensor,
                   latent_pages: torch.Tensor, block_tables: torch.Tensor,
                   d_latent: int, *ints: torch.Tensor, tensors=()) -> None:
    """Device, dtype, contiguity and width checks shared by the MLA
    kernels; raises ``ValueError`` on what a kernel does not take."""
    dev = q_lat.device
    for t in (q_lat, q_rope, latent_pages, block_tables, *ints, *tensors):
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
    if (q_lat.dtype, latent_pages.dtype) not in SUPPORTED:
        raise ValueError(f"{name}: unsupported dtypes q={q_lat.dtype} "
                         f"pages={latent_pages.dtype}")
    for t in (q_rope, *tensors):
        if t.dtype != q_lat.dtype:
            raise ValueError(f"{name}: q_rope and the chunk latent must "
                             f"have q_lat's dtype")
    for t in (block_tables, *ints):
        if t.dtype != torch.int32:
            raise ValueError(f"{name}: tables/lengths/positions must be "
                             f"int32, got {t.dtype}")
    if latent_pages.dim() != 3 or block_tables.dim() != 2:
        raise ValueError(f"{name}: pages [N,page,dl+dr], tables [B,P]")
    dl, dr = q_lat.shape[-1], q_rope.shape[-1]
    if (dl != d_latent or latent_pages.shape[-1] != dl + dr
            or q_rope.shape[:-1] != q_lat.shape[:-1]):
        raise ValueError(f"{name}: widths q_lat {tuple(q_lat.shape)}, "
                         f"q_rope {tuple(q_rope.shape)}, pages "
                         f"{tuple(latent_pages.shape)}, d_latent {d_latent}")
    if dl > MAX_D_LATENT:
        raise ValueError(f"{name}: d_latent {dl} > {MAX_D_LATENT}")


def mla_paged_decode(q_lat: torch.Tensor, q_rope: torch.Tensor,
                     latent_pages: torch.Tensor, block_tables: torch.Tensor,
                     lengths: torch.Tensor, *, d_latent: int,
                     scale: float | None = None,
                     backend: str | None = None) -> torch.Tensor:
    """q_lat [B,Hq,dl]; q_rope [B,Hq,dr]; latent_pages [N,page,dl+dr];
    block_tables [B,P] int32; lengths [B] int32 -> ctx [B,Hq,dl] in
    q_lat's dtype.  ``scale=None`` is ``1/sqrt(dl//4 + dr)``."""
    be = resolve_backend(backend, q_lat)
    if be == "abstract":
        return abstract.mla("mla_paged_decode", q_lat, q_rope, latent_pages,
                            block_tables, lengths)
    if be == "torch":
        return ref.mla_paged_decode(q_lat, q_rope, latent_pages,
                                    block_tables, lengths, d_latent, scale)
    check_mla_args("mla_paged_decode", q_lat, q_rope, latent_pages,
                   block_tables, d_latent, lengths)
    b, hq, dl = q_lat.shape
    n, page, _ = latent_pages.shape
    if q_lat.dim() != 3 or block_tables.shape[0] != b \
            or lengths.shape != (b,):
        raise ValueError("mla_paged_decode: q_lat [B,Hq,dl], tables [B,P], "
                         "lengths [B]")
    dr, qd, kd = q_rope.shape[-1], DTYPE_CODES[q_lat.dtype], \
        DTYPE_CODES[latent_pages.dtype]
    window = block_tables.shape[1] * page
    part = None
    which = body(dl, dr, page, qd, kd)
    if which == "wgmma":
        from repro_torch.kernels.flash_prefill import _tma_ready
        q_lat, q_rope, latent_pages = _tma_ready(q_lat, q_rope, latent_pages)
    if which != "cuda_core":
        # float32 partials: o [B, S, Hq, dl], then (m, l) [B, S, Hq, 2]
        part = torch.empty(b * decode_splits(window) * hq * (dl + 2),
                           dtype=torch.float32, device=q_lat.device)
    out = torch.empty_like(q_lat)
    fn = build.entry("mla_paged_decode", "mla_paged_decode", MLA_DECODE_ARGS)
    rc = fn(q_lat.data_ptr(), q_rope.data_ptr(), latent_pages.data_ptr(),
            block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            None if part is None else part.data_ptr(),
            b, hq, dl, dr, n, page, block_tables.shape[1],
            ref.mla_scale(dl, dr, scale), decode_split_tokens(window), qd,
            kd, stream_ptr(q_lat.device))
    build.check(rc, "mla_paged_decode", "mla_paged_decode")
    mla_paged_decode.launches += 1
    return out


mla_paged_decode.launches = 0
