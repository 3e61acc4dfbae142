"""Paged decode attention: the CUDA kernel ``csrc/paged_decode.cu`` and
its wrapper.

Replaces the Pallas TPU kernel ``paged_decode_attention``
(``repro/kernels/paged_attention.py``).  One query per batch row attends
the row's pool tokens below its length through the block table; the
kernel is bound by the HBM bytes of the K and V pages it reads (see the
source note in ``csrc/paged_decode.cu``).  On CPU tensors the wrapper
runs the plain version in ``kernels/ref.py``.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.backend import resolve_backend

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# (q, kv) dtype pairs the kernels are instantiated for
SUPPORTED = {(torch.bfloat16, torch.bfloat16), (torch.float32, torch.bfloat16),
             (torch.float32, torch.float32)}


def check_args(name: str, q: torch.Tensor, k_pages: torch.Tensor,
               v_pages: torch.Tensor, block_tables: torch.Tensor,
               *ints: torch.Tensor, tensors=()) -> None:
    """Device, dtype, contiguity and head-layout checks shared by the
    paged kernels; raises ``ValueError`` on what a kernel does not take."""
    dev = q.device
    for t in (q, k_pages, v_pages, block_tables, *ints, *tensors):
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
    if (q.dtype, k_pages.dtype) not in SUPPORTED:
        raise ValueError(f"{name}: unsupported dtypes q={q.dtype} "
                         f"pages={k_pages.dtype}")
    if v_pages.dtype != k_pages.dtype or v_pages.shape != k_pages.shape:
        raise ValueError(f"{name}: k/v pages differ in dtype or shape")
    for t in tensors:
        if t.dtype != q.dtype:
            raise ValueError(f"{name}: chunk KV must have q's dtype")
    for t in (block_tables, *ints):
        if t.dtype != torch.int32:
            raise ValueError(f"{name}: tables/lengths/positions must be "
                             f"int32, got {t.dtype}")
    if k_pages.dim() != 4 or block_tables.dim() != 2:
        raise ValueError(f"{name}: pages [N,page,Hkv,hd], tables [B,P]")
    hq, hd = q.shape[-2], q.shape[-1]
    hkv = k_pages.shape[2]
    if k_pages.shape[3] != hd or hq % hkv != 0:
        raise ValueError(f"{name}: head layout q {tuple(q.shape)} vs "
                         f"pages {tuple(k_pages.shape)}")


PTR, INT, FLT = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# q, k_pages, v_pages, tables, lengths, out; B, Hq, Hkv, hd, N, page, P;
# scale; q and kv dtype codes; stream
DECODE_ARGS = [PTR] * 6 + [INT] * 7 + [FLT, INT, INT, PTR]


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def paged_decode_attention(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, block_tables: torch.Tensor,
                           lengths: torch.Tensor,
                           backend: str | None = None) -> torch.Tensor:
    """q [B,Hq,hd]; k/v_pages [N,page,Hkv,hd]; block_tables [B,P] int32;
    lengths [B] int32 -> [B,Hq,hd] in q's dtype."""
    if resolve_backend(backend, q) == "torch":
        return ref.paged_decode_attention(q, k_pages, v_pages, block_tables,
                                          lengths)
    check_args("paged_decode", q, k_pages, v_pages, block_tables, lengths)
    b, hq, hd = q.shape
    n, page, hkv, _ = k_pages.shape
    if q.dim() != 3 or block_tables.shape[0] != b or lengths.shape != (b,):
        raise ValueError("paged_decode: q [B,Hq,hd], tables [B,P], "
                         "lengths [B]")
    out = torch.empty_like(q)
    fn = build.entry("paged_decode", "paged_decode", DECODE_ARGS)
    rc = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            b, hq, hkv, hd, n, page, block_tables.shape[1],
            1.0 / math.sqrt(hd), DTYPE_CODES[q.dtype],
            DTYPE_CODES[k_pages.dtype], stream_ptr(q.device))
    build.check(rc, "paged_decode", "paged_decode")
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0
