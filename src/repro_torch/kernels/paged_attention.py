"""Paged decode attention: the CUDA kernels of ``csrc/paged_decode.cu``
and their wrappers.

Replace the Pallas TPU kernels ``paged_decode_attention`` and
``paged_decode_attention_int8`` (``repro/kernels/paged_attention.py``).
One query per batch row attends the row's pool tokens below its length
through the block table; the kernels are bound by the HBM bytes of the
K and V pages they read (see the source note in
``csrc/paged_decode.cu``), which the int8 version halves: with bf16 q it
widens its int8 tiles to bf16 exactly and applies the one scale per
(token, KV head) to the scores (K) and the probabilities (V).  With
``with_lse`` every body also writes each head's log-sum-exp, by which
the split decode merges its slices.  On CPU tensors the wrappers run the
plain versions in ``kernels/ref.py``.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import abstract, build, ref
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
# q, k_pages, v_pages, tables, lengths, out, lse (or NULL); B, Hq, Hkv, hd,
# N, page, P; scale; q and kv dtype codes; stream
DECODE_ARGS = [PTR] * 7 + [INT] * 7 + [FLT, INT, INT, PTR]


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _lse_out(q: torch.Tensor, with_lse: bool):
    """The kernel's log-sum-exp output [B,Hq] float32 when asked for,
    else None (the kernel then writes none)."""
    return (torch.empty(q.shape[:2], dtype=torch.float32, device=q.device)
            if with_lse else None)


def paged_decode_attention(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, block_tables: torch.Tensor,
                           lengths: torch.Tensor,
                           backend: str | None = None,
                           with_lse: bool = False) -> torch.Tensor:
    """q [B,Hq,hd]; k/v_pages [N,page,Hkv,hd]; block_tables [B,P] int32;
    lengths [B] int32 -> [B,Hq,hd] in q's dtype; with ``with_lse`` also
    each head's log-sum-exp [B,Hq] float32 in natural-log units, NEG_INF
    (-1e30) for a row with no attendable key (the split decode's merge
    weights, ``abstract.merge_slices``)."""
    be = resolve_backend(backend, q)
    if be == "abstract":
        return abstract.paged_decode(q, k_pages, v_pages, block_tables,
                                     lengths, with_lse=with_lse)
    if be == "torch":
        out = ref.paged_decode_attention(q, k_pages, v_pages, block_tables,
                                         lengths)
        return (out, ref.paged_decode_lse(q, k_pages, block_tables,
                                          lengths)) if with_lse else out
    check_args("paged_decode", q, k_pages, v_pages, block_tables, lengths)
    b, hq, hd = q.shape
    n, page, hkv, _ = k_pages.shape
    if q.dim() != 3 or block_tables.shape[0] != b or lengths.shape != (b,):
        raise ValueError("paged_decode: q [B,Hq,hd], tables [B,P], "
                         "lengths [B]")
    out = torch.empty_like(q)
    lse = _lse_out(q, with_lse)
    fn = build.entry("paged_decode", "paged_decode", DECODE_ARGS)
    rc = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(),
            b, hq, hkv, hd, n, page, block_tables.shape[1],
            1.0 / math.sqrt(hd), DTYPE_CODES[q.dtype],
            DTYPE_CODES[k_pages.dtype], stream_ptr(q.device))
    build.check(rc, "paged_decode", "paged_decode")
    paged_decode_attention.launches += 1
    return (out, lse) if with_lse else out


paged_decode_attention.launches = 0

# q, k_pages, v_pages, k_scales, v_scales, tables, lengths, out, lse (or
# NULL); B, Hq, Hkv, hd, N, page, P; scale; q dtype code; stream
DECODE_INT8_ARGS = [PTR] * 9 + [INT] * 7 + [FLT, INT, PTR]


def paged_decode_attention_int8(q: torch.Tensor, k_pages: torch.Tensor,
                                v_pages: torch.Tensor, k_scales: torch.Tensor,
                                v_scales: torch.Tensor,
                                block_tables: torch.Tensor,
                                lengths: torch.Tensor,
                                backend: str | None = None,
                                with_lse: bool = False) -> torch.Tensor:
    """q [B,Hq,hd]; k/v_pages int8 [N,page,Hkv,hd]; k/v_scales bf16
    [N,page,Hkv,1]; block_tables [B,P] int32; lengths [B] int32 ->
    [B,Hq,hd] in q's dtype; ``with_lse`` as in
    ``paged_decode_attention``."""
    be = resolve_backend(backend, q)
    if be == "abstract":
        return abstract.paged_decode_int8(q, k_pages, v_pages, k_scales,
                                          v_scales, block_tables, lengths,
                                          with_lse=with_lse)
    if be == "torch":
        out = ref.paged_decode_attention_int8(q, k_pages, v_pages, k_scales,
                                              v_scales, block_tables,
                                              lengths)
        return (out, ref.paged_decode_lse(q, k_pages, block_tables, lengths,
                                          k_scales)) if with_lse else out
    name = "paged_decode_int8"
    for t in (q, k_pages, v_pages, k_scales, v_scales, block_tables,
              lengths):
        if t.device != q.device:
            raise ValueError(f"{name}: tensors on {t.device} and {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
    if q.dtype not in DTYPE_CODES or k_pages.dtype != torch.int8 or \
            v_pages.dtype != torch.int8:
        raise ValueError(f"{name}: unsupported dtypes q={q.dtype} "
                         f"pages={k_pages.dtype}/{v_pages.dtype}")
    if k_scales.dtype != torch.bfloat16 or v_scales.dtype != torch.bfloat16:
        raise ValueError(f"{name}: scales must be bfloat16")
    if block_tables.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise ValueError(f"{name}: tables/lengths must be int32")
    b, hq, hd = q.shape
    n, page, hkv, _ = k_pages.shape
    if (q.dim() != 3 or k_pages.dim() != 4 or v_pages.shape != k_pages.shape
            or k_pages.shape[3] != hd or hq % hkv != 0
            or k_scales.shape != (n, page, hkv, 1)
            or v_scales.shape != k_scales.shape
            or block_tables.dim() != 2 or block_tables.shape[0] != b
            or lengths.shape != (b,)):
        raise ValueError(f"{name}: q [B,Hq,hd], pages [N,page,Hkv,hd], "
                         f"scales [N,page,Hkv,1], tables [B,P], lengths [B]")
    out = torch.empty_like(q)
    lse = _lse_out(q, with_lse)
    fn = build.entry("paged_decode", name, DECODE_INT8_ARGS)
    rc = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            k_scales.data_ptr(), v_scales.data_ptr(),
            block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(),
            b, hq, hkv, hd, n, page, block_tables.shape[1],
            1.0 / math.sqrt(hd), DTYPE_CODES[q.dtype], stream_ptr(q.device))
    build.check(rc, "paged_decode", name)
    paged_decode_attention_int8.launches += 1
    return (out, lse) if with_lse else out


paged_decode_attention_int8.launches = 0
