"""Attention parameters and projections: the MHA / GQA / MQA family and
MLA (latent attention); dense causal and slot-cache decode attention.

The attention itself runs in the kernels (``kernels/ops.py``); this
module declares the weights, projects q/k/v (or, for MLA, the query
heads and the cached latent ``[c_kv ; k_rope]``) with RoPE, masks padded
layout heads, and carries the dense layout's attention:
``causal_attention`` (monolithic prefill: the flash kernel when the
queries start at position 0), ``decode_attention`` over a slot cache
[B,S,Hkv,hd] seen as pages (the paged decode kernels, bf16 or int8 with
``quantize_kv`` scales) and the in-place ``cache_write``.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from repro_torch.config import ModelConfig
from repro_torch.kernels import ops, ref
from repro_torch.models.common import PSpec, apply_rope


def head_mask(cfg: ModelConfig, dtype=torch.bfloat16,
              device=None) -> Optional[torch.Tensor]:
    """[layout_q_heads, 1] multiplicative mask zeroing padded heads.
    Layout: per GQA group, real heads first, pads last — preserves the
    q->kv mapping i // layout_q_group."""
    hp = cfg.layout_q_heads
    if hp == cfg.n_heads:
        return None
    g, gp = cfg.q_group, cfg.layout_q_group
    idx = torch.arange(hp, device=device)
    return ((idx % gp) < g).to(dtype)[:, None]


def attn_pspecs(cfg: ModelConfig) -> Dict[str, PSpec]:
    d, hq, hkv, hd = (cfg.d_model, cfg.layout_q_heads,
                      max(cfg.n_kv_heads, 1), cfg.hd)
    scale = 0.02
    out = {
        "wq": PSpec((d, hq, hd), ("embed", "heads", None), scale=scale),
        "wk": PSpec((d, hkv, hd), ("embed", "kv_heads", None), scale=scale),
        "wv": PSpec((d, hkv, hd), ("embed", "kv_heads", None), scale=scale),
        "wo": PSpec((hq, hd, d), ("heads", None, "embed"),
                    scale=scale / math.sqrt(2 * max(cfg.n_layers, 1))),
    }
    if cfg.qkv_bias:
        out.update(
            bq=PSpec((hq, hd), ("heads", None), init="zeros"),
            bk=PSpec((hkv, hd), ("kv_heads", None), init="zeros"),
            bv=PSpec((hkv, hd), ("kv_heads", None), init="zeros"))
    return out


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhk->bshk") as one matmul."""
    d, h, k = w.shape
    return torch.matmul(x, w.reshape(d, h * k)).unflatten(-1, (h, k))


def project_qkv(p: Dict, x: torch.Tensor, positions: torch.Tensor,
                cfg: ModelConfig, *, rope: bool = True):
    """x [B,S,D] -> q [B,S,Hq,hd], k/v [B,S,Hkv,hd] (RoPE applied)."""
    q, k, v = _proj(x, p["wq"]), _proj(x, p["wk"]), _proj(x, p["wv"])
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    if rope and cfg.rope_theta > 0:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v.contiguous()


def out_proj(o: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """einsum("...hk,hkd->...d") as one matmul."""
    h, k, d = wo.shape
    return torch.matmul(o.flatten(-2), wo.reshape(h * k, d))


# ---------------------------------------------------------------------------
# Exact causal attention (monolithic prefill)
# ---------------------------------------------------------------------------
def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     *, q_offset: int = 0,
                     backend: Optional[str] = None) -> torch.Tensor:
    """q [B,Sq,Hq,hd] at positions q_offset + i; k/v [B,Sk,Hkv,hd]
    -> [B,Sq,Hq,hd]: query i attends keys t <= q_offset + i.

    With no offset over its own keys (Sq == Sk) this is the flash
    prefill kernel (``ops.flash_causal``: the CUDA kernel on the card,
    its plain version on the CPU).  A suffix after a cached prefix
    (q_offset > 0) runs plain PyTorch on both devices, as the JAX
    package runs it in ``jnp``: float32 softmax and accumulation."""
    sq, sk = q.shape[1], k.shape[1]
    if q_offset == 0 and sq == sk:
        return ops.flash_causal(q.contiguous(), k.contiguous(),
                                v.contiguous(), backend=backend)
    mask = ref.causal_mask(sq, sk, q_offset, q.device)
    return ref._attend(q, k, v, mask.expand(q.shape[0], sq, sk))


# ---------------------------------------------------------------------------
# Decode over the dense slot cache [B, S, ...]
# ---------------------------------------------------------------------------
def cache_write(cache: torch.Tensor, new: torch.Tensor,
                lengths: torch.Tensor) -> torch.Tensor:
    """Write one new token per row at its current length, IN PLACE
    (the JAX package returns a new array): cache [B,S,...], new
    [B,1,...], lengths [B].  A length past the cache clamps to its last
    slot, as ``dynamic_update_slice`` clamps its start."""
    rows = torch.arange(cache.shape[0], device=cache.device)
    pos = lengths.long().clamp(0, cache.shape[1] - 1)
    cache[rows, pos] = new[:, 0].to(cache.dtype)
    return cache


def slot_pages(*caches: torch.Tensor):
    """Slot caches [B,S,...] seen as page pools: the free views
    [B*S/page, page, ...] and their shared identity block table
    [B, S/page] int32 (row b's pages are b*S/page + arange(S/page)).
    The page is the largest power of two dividing S, at most 64 (the
    paged path's page)."""
    b, s = caches[0].shape[:2]
    page = math.gcd(s, 64)
    n = s // page
    tables = torch.arange(b * n, dtype=torch.int32,
                          device=caches[0].device).reshape(b, n)
    return [c.view((b * n, page) + c.shape[2:]) for c in caches], tables


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, lengths: torch.Tensor,
                     k_scale: Optional[torch.Tensor] = None,
                     v_scale: Optional[torch.Tensor] = None,
                     backend: Optional[str] = None) -> torch.Tensor:
    """q [B,1,Hq,hd]; caches [B,S,Hkv,hd]; lengths [B] int32 = valid
    tokens (the new one included) -> [B,1,Hq,hd].

    Runs the paged decode kernel over the caches seen as pages
    (``slot_pages``); with int8 caches and their bf16 scales
    [B,S,Hkv,1], the int8 kernel."""
    scales = () if k_scale is None else (k_scale, v_scale)
    (kp, vp, *sp), tables = slot_pages(k_cache, v_cache, *scales)
    q1 = q[:, 0].contiguous()
    if k_scale is None:
        o = ops.paged_decode(q1, kp, vp, tables, lengths, backend=backend)
    else:
        o = ops.paged_decode_int8(q1, kp, vp, *sp, tables, lengths,
                                  backend=backend)
    return o[:, None]


# ---------------------------------------------------------------------------
# int8 KV cache: per-token-per-head symmetric quantization, bf16 scales
# ---------------------------------------------------------------------------
def quantize_kv(x: torch.Tensor):
    """x [..., hd] -> (int8 values, bf16 scale [..., 1]); the values are
    rounded against the float32 scale (half to even, as ``jnp.round``)."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    scale = (amax / 127.0).clamp_min(1e-8)
    q = torch.round(xf / scale).clamp(-127, 127)
    return q.to(torch.int8), scale.to(torch.bfloat16)


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor,
                  dtype: torch.dtype) -> torch.Tensor:
    """int8 values times their bf16 scale, the product rounded to bf16
    (the JAX package's order), then cast to ``dtype``."""
    return (q.to(torch.bfloat16) * scale).to(dtype)


# ---------------------------------------------------------------------------
# MLA: the cache holds only [c_kv ; k_rope], (d_latent + d_rope) per token
# ---------------------------------------------------------------------------
def mla_pspecs(cfg: ModelConfig) -> Dict[str, PSpec]:
    d, hq, hd = cfg.d_model, cfg.n_heads, cfg.hd
    dl, dr = cfg.d_latent, cfg.d_rope
    return {
        "wq": PSpec((d, hq, hd + dr), ("embed", "heads", None)),
        "w_dkv": PSpec((d, dl), ("embed", "latent")),
        "w_kr": PSpec((d, dr), ("embed", None)),
        "w_uk": PSpec((dl, hq, hd), ("latent", "heads", None)),
        "w_uv": PSpec((dl, hq, hd), ("latent", "heads", None)),
        "wo": PSpec((hq, hd, d), ("heads", None, "embed"),
                    scale=0.02 / math.sqrt(2 * max(cfg.n_layers, 1))),
    }


def mla_project(p: Dict, x: torch.Tensor, positions: torch.Tensor,
                cfg: ModelConfig):
    """x [B,S,D] -> q_nope [B,S,H,hd], q_rope [B,S,H,dr] (RoPE applied)
    and the cached latent [B,S,dl+dr] = [c_kv ; RoPE(k_rope)]."""
    dr = cfg.d_rope
    q = _proj(x, p["wq"])
    q_nope, q_rope = q[..., :-dr], q[..., -dr:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    c_kv = torch.matmul(x, p["w_dkv"])
    k_rope = torch.matmul(x, p["w_kr"])
    k_rope = apply_rope(k_rope[:, :, None, :], positions,
                        cfg.rope_theta)[:, :, 0, :]
    return q_nope, q_rope, torch.cat([c_kv, k_rope], dim=-1)
