"""Causal flash attention over a dense sequence: the CUDA kernel
``csrc/flash_prefill.cu`` and its wrapper.

Replaces the Pallas TPU kernel ``flash_prefill``
(``repro/kernels/flash_prefill.py``): query i attends keys j <= i, the
computation of ``models/attention.causal_attention`` with no query
offset, which the monolithic prefill runs for a prompt without a prefix
hit.  The kernel is bound by the bytes of q, k, v and the output at the
serving path's prompt lengths (see the source note); it handles any
sequence length, a ragged last tile included.  On CPU tensors the
wrapper runs the plain version in ``kernels/ref.py``.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.backend import resolve_backend
from repro_torch.kernels.paged_attention import DTYPE_CODES, stream_ptr

PTR, INT, FLT = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# q, k, v, out; B, S, Hq, Hkv, hd; scale; dtype code; stream
FLASH_ARGS = [PTR] * 4 + [INT] * 5 + [FLT, INT, PTR]


def flash_prefill(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  backend: str | None = None) -> torch.Tensor:
    """q [B,S,Hq,hd]; k/v [B,S,Hkv,hd] -> [B,S,Hq,hd] in q's dtype."""
    if resolve_backend(backend, q) == "torch":
        return ref.flash_prefill(q, k, v)
    for t in (q, k, v):
        if t.device != q.device:
            raise ValueError(f"flash_prefill: tensors on {t.device} and "
                             f"{q.device}")
        if not t.is_contiguous():
            raise ValueError("flash_prefill: inputs must be contiguous")
        if t.dtype != q.dtype or t.dtype not in DTYPE_CODES:
            raise ValueError(f"flash_prefill: q/k/v must share one dtype of "
                             f"{tuple(DTYPE_CODES)}, got {q.dtype}, "
                             f"{k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
        raise ValueError("flash_prefill: q [B,S,Hq,hd], k/v [B,S,Hkv,hd]")
    b, s, hq, hd = q.shape
    hkv = k.shape[2]
    if k.shape[:2] != (b, s) or k.shape[3] != hd or hq % hkv != 0:
        raise ValueError(f"flash_prefill: head layout q {tuple(q.shape)} "
                         f"vs k {tuple(k.shape)}")
    out = torch.empty_like(q)
    fn = build.entry("flash_prefill", "flash_prefill", FLASH_ARGS)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, s, hq, hkv, hd, 1.0 / math.sqrt(hd), DTYPE_CODES[q.dtype],
            stream_ptr(q.device))
    build.check(rc, "flash_prefill", "flash_prefill")
    flash_prefill.launches += 1
    return out


flash_prefill.launches = 0
