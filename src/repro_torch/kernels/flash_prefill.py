"""Causal flash attention over a dense sequence: the CUDA kernels
``csrc/flash_prefill.cu`` (forward) and ``csrc/flash_prefill_bwd.cu``
(backward), their wrappers, and the autograd function that joins them.

Replaces the Pallas TPU kernel ``flash_prefill``
(``repro/kernels/flash_prefill.py``): query i attends keys j <= i, the
computation of ``models/attention.causal_attention`` with no query
offset, which the monolithic prefill runs for a prompt without a prefix
hit.  The forward kernel is bound by the bytes of q, k, v and the output
at the serving path's prompt lengths (see the source note); it handles
any sequence length, a ragged last tile included.  With ``with_lse`` it
also returns each row's log-sum-exp of its scaled scores (float32
[B,Hq,S], natural-log units), which the backward recomputes the
probabilities from.

Q and K share one width dk, V and the output one width dv: dv == dk, or
MLA's training pair (192, 128), the non-absorbed form the JAX package
trains (K = [c_kv W_uk ; k_rope], V = c_kv W_uv per head; scale
1/sqrt(dk) as ever).  Any other pair is refused on the card
(``check_widths``); the plain versions take any.

The JAX package differentiates this attention in ``jnp`` (``jax.grad``
of ``causal_attention``); it has no backward kernel to translate.
``FlashCausal`` is the port's: its forward runs the forward kernel with
``lse``, its backward ``flash_prefill_bwd`` (dQ, dK, dV without atomics,
so gradients are deterministic; bf16 on the tensor cores, float32 on
the CUDA cores).  On CPU tensors every wrapper runs the plain version in
``kernels/ref.py``.

At small batch the tensor-core dK/dV kernel cuts each key tile's walk
into chunks of ``bwd_kv_chunk`` query tiles, chosen from the shape
alone; the wrapper allocates the chunks' float32 partials, which a
second kernel sums in a fixed order.
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
# the dK/dV grid: one block a (64-key tile, KV head, sequence) when that
# gives each of the H100's 132 SMs two; else the walks are cut into
# chunks of at least 2 query tiles, about 2 x 132 blocks in all
BWD_TILE, BWD_SMS, BWD_MIN_CHUNK = 64, 132, 2


def bwd_kv_chunk(b: int, s: int, hq: int, hkv: int) -> int:
    """Query-tile iterations a block of the tensor-core dK/dV kernel
    walks.  Key tile kt of n = ceil(s / 64) walks G (n - kt) of them (each
    query head of the group over the tiles from the diagonal down);
    G n means one block a key tile, no partials."""
    n, g = -(-s // BWD_TILE), hq // hkv
    if b * hkv * n >= 2 * BWD_SMS:
        return g * n
    pairs = b * hkv * g * n * (n + 1) // 2
    return min(g * n, max(BWD_MIN_CHUNK, -(-pairs // (2 * BWD_SMS))))


def bwd_kv_parts(b: int, s: int, hq: int, hkv: int) -> int:
    """Chunks of the longest walk (key tile 0): the partials' count."""
    whole = hq // hkv * -(-s // BWD_TILE)
    return -(-whole // bwd_kv_chunk(b, s, hq, hkv))


@functools.lru_cache(maxsize=None)
def tensor_core(dk: int, dv: int, dtype_code: int) -> bool:
    """Whether the forward's C entry runs the tensor-core body."""
    fn = build.entry("flash_prefill", "flash_prefill_tensor_core", [INT] * 3)
    return bool(fn(dk, dv, dtype_code))


@functools.lru_cache(maxsize=None)
def bwd_tensor_core(dk: int, dv: int, dtype_code: int) -> bool:
    """Whether the backward's C entry runs the tensor-core body."""
    fn = build.entry("flash_prefill_bwd", "flash_prefill_bwd_tensor_core",
                     [INT] * 3)
    return bool(fn(dk, dv, dtype_code))


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
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty((b, hq, s), dtype=torch.float32, device=q.device)
    parts = bwd_kv_parts(b, s, hq, hkv)
    # `parts` float32 dK partials, then `parts` dV partials
    part = (torch.empty(parts * (k.numel() + v.numel()), dtype=torch.float32,
                        device=q.device)
            if parts > 1 and bwd_tensor_core(hd, hdv, code) else None)
    fn = build.entry("flash_prefill_bwd", "flash_prefill_bwd", FLASH_BWD_ARGS)
    rc = fn(*(t.data_ptr() for t in (q, k, v, o, do, lse, delta, dq, dk, dv)),
            None if part is None else part.data_ptr(),
            b, s, hq, hkv, hd, hdv, 1.0 / math.sqrt(hd),
            bwd_kv_chunk(b, s, hq, hkv), code, stream_ptr(q.device))
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
