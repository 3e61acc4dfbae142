"""Causal flash attention over a dense sequence: the CUDA kernels
``csrc/flash_prefill.cu`` (forward) and ``csrc/flash_prefill_bwd.cu``
(backward), their wrappers, and the autograd function that joins them.

Replaces the Pallas TPU kernel ``flash_prefill``
(``repro/kernels/flash_prefill.py``): query i attends keys j <= i, the
computation of ``models/attention.causal_attention`` with no query
offset, which the monolithic prefill runs for a prompt without a prefix
hit and the training forward runs for every layer.  Any sequence length
is taken, a ragged last tile included.  With ``with_lse`` the forward
also returns each row's log-sum-exp of its scaled scores (float32
[B,Hq,S], natural-log units), which the backward recomputes the
probabilities from.

Q and K share one width dk, V and the output one width dv: dv == dk, or
MLA's training pair (192, 128), the non-absorbed form the JAX package
trains (K = [c_kv W_uk ; k_rope], V = c_kv W_uv per head; scale
1/sqrt(dk) as ever).  Any other pair is refused on the card
(``check_widths``); the plain versions take any.

Bodies by type and width (``body`` / ``bwd_body`` ask the C entries):

=============  ==========================  =============================
inputs         forward                     backward
=============  ==========================  =============================
bf16 64/64     ``wgmma`` (192- or 128-row  ``wgmma`` (dK/dV 128-key
               tiles by grid size)         blocks, dQ 128-key tiles)
bf16 128/128   ``wgmma`` (128-row tiles)   ``wgmma`` (dK/dV split over
                                           the consumers, 64 keys)
bf16 192/128   ``wgmma`` (128-row tiles)   ``wgmma`` (as 128; dQ 32-key
                                           tiles)
bf16 16, 32    ``mma_sync``                ``mma_sync`` (16 only)
float32,       ``cuda_core``               ``cuda_core`` (float32)
bf16 256
=============  ==========================  =============================

The ``wgmma`` bodies are Hopper's: a producer warpgroup whose one thread
issues TMA loads into an ``mbarrier`` ring of two stages, and two (three
at hd 64's 192-row tiles) consumer warpgroups that run every product
with ``wgmma`` and keep the softmax and the accumulators in registers
(the source notes give tiles, ring and register split).  TMA reads from
16-byte aligned bases, so a view at an odd offset is copied first
(``_tma_ready``).

The JAX package differentiates this attention in ``jnp`` (``jax.grad``
of ``causal_attention``); it has no backward kernel to translate.
``FlashCausal`` is the port's: its forward runs the forward kernel with
``lse``, its backward ``flash_prefill_bwd`` (dQ, dK, dV without atomics,
so gradients are deterministic).  On CPU tensors every wrapper runs the
plain version in ``kernels/ref.py``.

At small batch the dK/dV kernel cuts each key tile's walk into chunks of
``bwd_kv_chunk`` query tiles, chosen from the shape, the body's key
tile (``bwd_kv_tile``) and the blocks an SM runs (``bwd_per_sm``) alone;
the wrapper allocates the chunks' float32 partials, which a second
kernel sums in a fixed order.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.distributed.sharding import is_dtensor
from repro_torch.kernels import abstract, build, ref
from repro_torch.kernels.backend import resolve_backend
from repro_torch.kernels.paged_attention import DTYPE_CODES, stream_ptr

PTR, INT, FLT = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# q, k, v, out, lse (or NULL); B, S, Hq, Hkv, dk, dv; scale; dtype code;
# stream
FLASH_ARGS = [PTR] * 5 + [INT] * 6 + [FLT, INT, PTR]
# q, k, v, o, dO, lse, D scratch, dq, dk, dv, dK/dV partials (or NULL);
# B, S, Hq, Hkv, dk, dv; scale; query tiles a dK/dV block; dtype code;
# stream
FLASH_BWD_ARGS = [PTR] * 11 + [INT] * 6 + [FLT, INT, INT, PTR]
# (dk, dv) width pairs: the forward takes any dk == dv and MLA's pair;
# the backward the trainable families' (64, 64), (128, 128), their
# reduced configurations' (16, 16) and MLA's
MLA_WIDTHS = (192, 128)
BWD_WIDTHS = ((16, 16), (64, 64), (128, 128), MLA_WIDTHS)
# the dK/dV grid: one block a (key tile, KV head, sequence) when that
# fills the H100's 132 SMs with as many blocks as an SM holds
# (``bwd_per_sm``); else the walks are cut into chunks of at least 2
# query tiles, about 2 x 132 blocks in all.  Key tiles: 128 keys for
# the `wgmma` body at hd 64, else 64 (``bwd_kv_tile``); query tiles of 64
# throughout
BWD_TILE, BWD_SMS, BWD_MIN_CHUNK = 64, 132, 2
BODIES = {0: "cuda_core", 1: "mma_sync", 2: "wgmma"}
# the (dk, dv) pairs with `wgmma` bodies, forward and backward, in bf16
WGMMA_WIDTHS = ((64, 64), (128, 128), MLA_WIDTHS)


def bwd_kv_tile(dk: int, dv: int, dtype_code: int) -> int:
    """Keys a block of the backward's dK/dV kernel takes: 128 for the
    `wgmma` body at hd 64 (bf16), else 64 (the C entry
    ``flash_prefill_bwd_kv_tile`` says the same)."""
    return 128 if dtype_code == 1 and dk == dv == 64 else BWD_TILE


def bwd_per_sm(dk: int, dv: int, dtype_code: int) -> int:
    """dK/dV blocks an SM runs at once: one of a `wgmma` body's (bf16 at
    WGMMA_WIDTHS: 384 threads that take the whole register file), two of
    the `mma.sync` body's 128-thread blocks."""
    return 1 if dtype_code == 1 and (dk, dv) in WGMMA_WIDTHS else 2


def bwd_kv_chunk(b: int, s: int, hq: int, hkv: int,
                 kv_tile: int = BWD_TILE, per_sm: int = 2) -> int:
    """Query-tile iterations a block of the tensor-core dK/dV kernel
    walks.  Of n = ceil(s / 64) query tiles, key tile kt (``kv_tile``
    keys) walks G (n - kt kv_tile / 64) of them (each query head of the
    group over the tiles from the diagonal down); G n means one block a
    key tile, no partials.  That holds from ``per_sm`` x 132 blocks (a
    full wave); below it the chunks make about 2 x 132 blocks for either
    body: at one block an SM a one-wave target leaves the ragged last
    chunks a second wave (the A/B is in PERF.md §6)."""
    n, g = -(-s // BWD_TILE), hq // hkv
    m, r = -(-s // kv_tile), kv_tile // BWD_TILE
    if b * hkv * m >= BWD_SMS * per_sm:
        return g * n
    pairs = b * hkv * g * sum(n - r * kt for kt in range(m))
    return min(g * n, max(BWD_MIN_CHUNK, -(-pairs // (2 * BWD_SMS))))


def bwd_kv_parts(b: int, s: int, hq: int, hkv: int,
                 kv_tile: int = BWD_TILE, per_sm: int = 2) -> int:
    """Chunks of the longest walk (key tile 0): the partials' count."""
    whole = hq // hkv * -(-s // BWD_TILE)
    return -(-whole // bwd_kv_chunk(b, s, hq, hkv, kv_tile, per_sm))


@functools.lru_cache(maxsize=None)
def body(dk: int, dv: int, dtype_code: int) -> str:
    """The body the forward's C entry runs: "wgmma" (bf16 at (64, 64),
    (128, 128), (192, 128)), "mma_sync" (bf16 at hd 16, 32) or
    "cuda_core"."""
    fn = build.entry("flash_prefill", "flash_prefill_tensor_core", [INT] * 3)
    return BODIES[fn(dk, dv, dtype_code)]


@functools.lru_cache(maxsize=None)
def bwd_body(dk: int, dv: int, dtype_code: int) -> str:
    """The body the backward's C entry runs: "wgmma", "mma_sync" (bf16
    at hd 16) or "cuda_core" (float32)."""
    fn = build.entry("flash_prefill_bwd", "flash_prefill_bwd_tensor_core",
                     [INT] * 3)
    return BODIES[fn(dk, dv, dtype_code)]


def _tma_ready(*ts):
    """The tensors with any whose address is not 16-byte aligned (a view
    at an odd offset) copied: TMA reads from 16-byte aligned bases."""
    return [t if t.data_ptr() % 16 == 0 else t.clone() for t in ts]


def check_widths(name: str, dk: int, dv: int, backward: bool = False):
    """Raise ValueError unless the kernels take the (dk, dv) pair: the
    forward dk == dv or MLA_WIDTHS, the backward one of BWD_WIDTHS."""
    if backward and (dk, dv) not in BWD_WIDTHS:
        raise ValueError(f"{name}: the kernel takes head widths (hd, dv) "
                         f"in {BWD_WIDTHS}, got ({dk}, {dv})")
    if not backward and dk != dv and (dk, dv) != MLA_WIDTHS:
        raise ValueError(f"{name}: the kernel takes head widths hd == dv "
                         f"or (hd, dv) = {MLA_WIDTHS}, got ({dk}, {dv})")


def _check_qkv(name: str, q, k, v, *extra) -> None:
    """Device, dtype, contiguity and layout of q [B,S,Hq,dk], k
    [B,S,Hkv,dk], v [B,S,Hkv,dv] and any ``extra`` tensors [B,S,Hq,dv]
    (the output and its cotangent)."""
    for t in (q, k, v) + extra:
        if t.device != q.device:
            raise ValueError(f"{name}: tensors on {t.device} and "
                             f"{q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
        if t.dtype != q.dtype or t.dtype not in DTYPE_CODES:
            raise ValueError(f"{name}: inputs must share one dtype of "
                             f"{tuple(DTYPE_CODES)}, got {t.dtype} beside "
                             f"{q.dtype}")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"{name}: q [B,S,Hq,dk], k [B,S,Hkv,dk], v "
                         f"[B,S,Hkv,dv]")
    b, s, hq, dk = q.shape
    if (k.shape[:2] != (b, s) or k.shape[3] != dk or hq % k.shape[2] != 0
            or v.shape[:3] != k.shape[:3]
            or any(t.shape != q.shape[:3] + v.shape[3:] for t in extra)):
        raise ValueError(f"{name}: head layout q {tuple(q.shape)} vs k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")


def flash_prefill(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  backend: str | None = None, with_lse: bool = False):
    """q [B,S,Hq,dk]; k [B,S,Hkv,dk]; v [B,S,Hkv,dv] -> [B,S,Hq,dv] in
    q's dtype; with ``with_lse`` also the rows' log-sum-exp [B,Hq,S]
    float32.  DTensors run shard by shard (``abstract.sharded_flash``)."""
    if is_dtensor(q):
        return abstract.sharded_flash(flash_prefill, q, k, v, backend,
                                      with_lse)
    be = resolve_backend(backend, q)
    if be == "abstract":
        return abstract.flash_prefill(q, k, v, with_lse)
    if be == "torch":
        out = ref.flash_prefill(q, k, v)
        return (out, ref.flash_prefill_lse(q, k)) if with_lse else out
    _check_qkv("flash_prefill", q, k, v)
    b, s, hq, dk = q.shape
    dv = v.shape[3]
    check_widths("flash_prefill", dk, dv)
    out = q.new_empty((b, s, hq, dv))
    lse = (torch.empty((b, hq, s), dtype=torch.float32, device=q.device)
           if with_lse else None)
    if body(dk, dv, DTYPE_CODES[q.dtype]) == "wgmma":
        q, k, v = _tma_ready(q, k, v)
    fn = build.entry("flash_prefill", "flash_prefill", FLASH_ARGS)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(),
            b, s, hq, k.shape[2], dk, dv, 1.0 / math.sqrt(dk),
            DTYPE_CODES[q.dtype], stream_ptr(q.device))
    build.check(rc, "flash_prefill", "flash_prefill")
    flash_prefill.launches += 1
    return (out, lse) if with_lse else out


flash_prefill.launches = 0


def flash_prefill_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      o: torch.Tensor, do: torch.Tensor,
                      lse: torch.Tensor | None = None,
                      backend: str | None = None):
    """Gradients (dq [B,S,Hq,dk], dk [B,S,Hkv,dk], dv [B,S,Hkv,dv]) in
    q's dtype of causal attention's output o [B,S,Hq,dv] given its
    cotangent do.  The kernel needs the forward's ``lse`` [B,Hq,S]
    float32 and takes the (dk, dv) pairs of BWD_WIDTHS; the plain version
    recomputes the softmax itself."""
    if is_dtensor(q):
        return abstract.sharded_flash_bwd(flash_prefill_bwd, q, k, v, o, do,
                                          lse, backend)
    be = resolve_backend(backend, q)
    if be == "abstract":
        return abstract.flash_prefill_bwd(q, k, v, o, do, lse)
    if be == "torch":
        return ref.flash_prefill_bwd(q, k, v, o, do)
    _check_qkv("flash_prefill_bwd", q, k, v, o, do)
    b, s, hq, hd = q.shape
    hdv = v.shape[3]
    check_widths("flash_prefill_bwd", hd, hdv, backward=True)
    if (lse is None or lse.shape != (b, hq, s)
            or lse.dtype != torch.float32 or lse.device != q.device
            or not lse.is_contiguous()):
        raise ValueError("flash_prefill_bwd: the kernel needs the forward's "
                         "lse [B,Hq,S] float32, contiguous, on q's device")
    hkv, code = k.shape[2], DTYPE_CODES[q.dtype]
    if bwd_body(hd, hdv, code) == "wgmma":
        q, k, v, o, do = _tma_ready(q, k, v, o, do)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty((b, hq, s), dtype=torch.float32, device=q.device)
    plan = (b, s, hq, hkv, bwd_kv_tile(hd, hdv, code),
            bwd_per_sm(hd, hdv, code))
    parts = bwd_kv_parts(*plan)
    # `parts` float32 dK partials, then `parts` dV partials
    part = (torch.empty(parts * (k.numel() + v.numel()), dtype=torch.float32,
                        device=q.device)
            if parts > 1 and bwd_body(hd, hdv, code) != "cuda_core"
            else None)
    fn = build.entry("flash_prefill_bwd", "flash_prefill_bwd", FLASH_BWD_ARGS)
    rc = fn(*(t.data_ptr() for t in (q, k, v, o, do, lse, delta, dq, dk, dv)),
            None if part is None else part.data_ptr(),
            b, s, hq, hkv, hd, hdv, 1.0 / math.sqrt(hd),
            bwd_kv_chunk(*plan), code,
            stream_ptr(q.device))
    build.check(rc, "flash_prefill_bwd", "flash_prefill_bwd")
    flash_prefill_bwd.launches += 1
    return dq, dk, dv


flash_prefill_bwd.launches = 0


class FlashCausal(torch.autograd.Function):
    """Causal attention with a gradient: the forward kernel with ``lse``
    and the backward kernel on the card; the plain versions of both on
    CPU tensors or with ``backend="torch"``."""

    @staticmethod
    def forward(ctx, q, k, v, backend=None):
        if (not is_dtensor(q)
                and resolve_backend(backend, q) == "torch"):
            out, lse = ref.flash_prefill(q, k, v), None
        else:
            out, lse = flash_prefill(q, k, v, backend=backend, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.backend = backend
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_prefill_bwd(q, k, v, out, do.contiguous(), lse,
                                       backend=ctx.backend)
        return dq, dk, dv, None
