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

The bf16 decode's bodies by width and page size (``body`` asks the C
entry):

=====================================  ==============================
inputs                                 body
=====================================  ==============================
bf16, hd 64 / 128, G <= 16, pages of   ``hopper`` (``paged_decode_wg``:
16 / 32 / 64 tokens, a table window    TMA page loads, a split walk
of 512 to 4096 tokens                  merged in a cluster)
bf16, hd 16 - 128, G <= 16, other      ``tensor_core``
pages or windows (hd 16 / 32: every    (``paged_decode_tc``)
page)
float32 q; bf16 otherwise              ``cuda_core``
=====================================  ==============================

The int8 decode's bodies (``int8_body``): with a bf16 query under the
same gate, ``hopper`` (``paged_decode_wg<HD, true>``: the same block
over int8 tiles, its producer staging each tile's scales); with a bf16
query otherwise ``tensor_core`` (``paged_decode_int8_tc``); with a
float32 query ``cuda_core``.

The Hopper body cuts each row's key walk into splits of whole 64-key
tiles, planned on the host by ``decode_split_plan`` from the shapes
alone (the host never reads ``lengths``).  The splits of a (row, KV
head) run as one thread block cluster and merge their float32 partials
in split order through distributed shared memory, so the wrapper
allocates no scratch.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

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
# N, page, P, tiles a split, splits; scale; q and kv dtype codes; stream
DECODE_ARGS = [PTR] * 7 + [INT] * 9 + [FLT, INT, INT, PTR]
BODIES = {0: "cuda_core", 1: "tensor_core", 2: "hopper"}

# The Hopper body's split plan: a (row, KV head)'s walk over the table
# window is cut into splits of whole KEY_TILE-key tiles, as many as keep
# the grid within SPLIT_BLOCKS blocks (one an SM of the H100's 132: a
# split's start and its cluster's merge cost more than a shorter walk
# saves once every SM has a block) and one portable cluster (MAX_SPLITS)
KEY_TILE = 64
MAX_SPLITS = 8
SPLIT_BLOCKS = 132


class DecodePlan(NamedTuple):
    """How the Hopper body cuts a decode call's key walk: per (row, KV
    head), ``splits`` splits of ``tiles`` 64-key tiles over the table
    window, one thread block cluster."""
    tiles: int          # 64-key tiles a split
    splits: int
    groups: int         # B * Hkv: one cluster each
    window: int         # P * page
    g: int              # query heads a KV head
    hd: int

    @property
    def blocks(self) -> int:
        return self.groups * self.splits

    @property
    def partial_bytes(self) -> int:
        """The float32 partials (each block's unnormalised output and (m,
        l) for its G rows) held in shared memory and merged across each
        cluster."""
        return self.blocks * self.g * (self.hd + 2) * 4

    def split_keys(self, split: int) -> tuple:
        """(start, stop) pool positions of split ``split``'s keys."""
        span = self.tiles * KEY_TILE
        return split * span, min((split + 1) * span, self.window)

    def live_splits(self, length: int) -> int:
        """Splits a row of ``length`` tokens walks (at least split 0,
        which writes zeros for a row of length 0); with one, the other
        blocks leave at once, else they share the merge."""
        end = min(max(length, 0), self.window)
        return max(1, -(-end // (self.tiles * KEY_TILE)))


@functools.lru_cache(maxsize=None)
def decode_split_plan(b: int, hq: int, hkv: int, hd: int, page: int,
                      p: int) -> DecodePlan:
    """The Hopper body's split plan for a call on q [b, hq, hd] over k/v
    pages [N, page, hkv, hd] with tables [b, p]: ints only, so the host
    reads nothing of the device.  As many splits a (row, KV head) as keep
    the grid within SPLIT_BLOCKS blocks (at least one, at most
    MAX_SPLITS), each the fewest whole tiles that cover the window."""
    args = (b, hq, hkv, hd, page, p)
    if not all(isinstance(x, int) for x in args):
        raise TypeError("decode_split_plan takes ints (the shapes), "
                        f"got {[type(x).__name__ for x in args]}")
    window = p * page
    n_tiles = max(1, -(-window // KEY_TILE))
    splits = min(MAX_SPLITS, max(1, SPLIT_BLOCKS // max(1, b * hkv)))
    tiles = -(-n_tiles // splits)
    return DecodePlan(tiles=tiles, splits=-(-n_tiles // tiles),
                      groups=b * hkv, window=window, g=hq // hkv, hd=hd)


@functools.lru_cache(maxsize=None)
def body(hq: int, hkv: int, hd: int, page: int, p: int, q_dtype: int,
         kv_dtype: int) -> str:
    """The body the GQA decode's C entry runs over tables of ``p`` pages:
    "hopper" (``paged_decode_wg``: TMA, an `mbarrier` ring, a cluster;
    its products are `mma.sync`), "tensor_core" (``paged_decode_tc``) or
    "cuda_core"."""
    fn = build.entry("paged_decode", "paged_decode_body",
                     [ctypes.c_int] * 7)
    return BODIES[fn(hq, hkv, hd, page, p, q_dtype, kv_dtype)]


@functools.lru_cache(maxsize=None)
def int8_body(hq: int, hkv: int, hd: int, page: int, p: int,
              q_dtype: int) -> str:
    """The body the int8 decode's C entry runs over tables of ``p``
    pages: "hopper" (``paged_decode_wg<HD, true>``), "tensor_core"
    (``paged_decode_int8_tc``) or "cuda_core"."""
    fn = build.entry("paged_decode", "paged_decode_int8_body",
                     [ctypes.c_int] * 6)
    return BODIES[fn(hq, hkv, hd, page, p, q_dtype)]


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _lse_out(q: torch.Tensor, with_lse: bool):
    """The kernel's log-sum-exp output [B,Hq] float32 when asked for,
    else None (the kernel then writes none)."""
    return (torch.empty(q.shape[:2], dtype=torch.float32, device=q.device)
            if with_lse else None)


def _launch_decode(q, k_pages, v_pages, block_tables, lengths, lse,
                   plan: DecodePlan | None = None) -> torch.Tensor:
    """Launch C entry ``paged_decode``; ``plan`` replaces the Hopper
    body's default split plan (an A/B of plans passes one)."""
    b, hq, hd = q.shape
    n, page, hkv, _ = k_pages.shape
    p = block_tables.shape[1]
    qd, kd = DTYPE_CODES[q.dtype], DTYPE_CODES[k_pages.dtype]
    ints = (0, 0)
    if body(hq, hkv, hd, page, p, qd, kd) == "hopper":
        from repro_torch.kernels.flash_prefill import _tma_ready
        plan = plan or decode_split_plan(b, hq, hkv, hd, page, p)
        q, k_pages, v_pages = _tma_ready(q, k_pages, v_pages)
        ints = (plan.tiles, plan.splits)
    out = torch.empty_like(q)
    fn = build.entry("paged_decode", "paged_decode", DECODE_ARGS)
    rc = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(),
            b, hq, hkv, hd, n, page, p, *ints, 1.0 / math.sqrt(hd), qd, kd,
            stream_ptr(q.device))
    build.check(rc, "paged_decode", "paged_decode")
    return out


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
    lse = _lse_out(q, with_lse)
    out = _launch_decode(q, k_pages, v_pages, block_tables, lengths, lse)
    paged_decode_attention.launches += 1
    return (out, lse) if with_lse else out


paged_decode_attention.launches = 0

# q, k_pages, v_pages, k_scales, v_scales, tables, lengths, out, lse (or
# NULL); B, Hq, Hkv, hd, N, page, P, tiles a split, splits; scale; q
# dtype code; stream
DECODE_INT8_ARGS = [PTR] * 9 + [INT] * 9 + [FLT, INT, PTR]


def _launch_int8(q, k_pages, v_pages, k_scales, v_scales, block_tables,
                 lengths, lse, plan: DecodePlan | None = None) -> torch.Tensor:
    """Launch C entry ``paged_decode_int8``; ``plan`` replaces the Hopper
    body's default split plan (a test of plans passes one)."""
    b, hq, hd = q.shape
    n, page, hkv, _ = k_pages.shape
    p = block_tables.shape[1]
    qd = DTYPE_CODES[q.dtype]
    ints = (0, 0)
    if int8_body(hq, hkv, hd, page, p, qd) == "hopper":
        from repro_torch.kernels.flash_prefill import _tma_ready
        plan = plan or decode_split_plan(b, hq, hkv, hd, page, p)
        q, k_pages, v_pages, k_scales, v_scales = _tma_ready(
            q, k_pages, v_pages, k_scales, v_scales)
        ints = (plan.tiles, plan.splits)
    out = torch.empty_like(q)
    fn = build.entry("paged_decode", "paged_decode_int8", DECODE_INT8_ARGS)
    rc = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            k_scales.data_ptr(), v_scales.data_ptr(),
            block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(),
            b, hq, hkv, hd, n, page, p, *ints,
            1.0 / math.sqrt(hd), qd, stream_ptr(q.device))
    build.check(rc, "paged_decode", "paged_decode_int8")
    return out


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
    lse = _lse_out(q, with_lse)
    out = _launch_int8(q, k_pages, v_pages, k_scales, v_scales,
                       block_tables, lengths, lse)
    paged_decode_attention_int8.launches += 1
    return (out, lse) if with_lse else out


paged_decode_attention_int8.launches = 0
