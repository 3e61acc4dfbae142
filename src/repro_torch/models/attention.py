"""Attention parameters and projections: the MHA / GQA / MQA family and
MLA (latent attention); dense causal and slot-cache decode attention.

The attention itself runs in the kernels (``kernels/ops.py``); this
module declares the weights, projects q/k/v (or, for MLA, the query
heads and the cached latent ``[c_kv ; k_rope]``) with RoPE, masks padded
layout heads, and carries the dense layout's attention:
``full_attention`` (bidirectional: an encoder, and cross-attention to
image patches or encoder output; plain PyTorch, as the JAX package
keeps it),
``causal_attention`` (monolithic prefill: the flash kernel when the
queries start at position 0), ``decode_attention`` over a slot cache
[B,S,Hkv,hd] seen as pages (the paged decode kernels, bf16 or int8 with
``quantize_kv`` scales) and the in-place ``cache_write``.

MLA serves in the absorbed form (``mla_absorbed``): ``W_uk`` folded
into the query, the MLA kernels attend in latent space, then ``W_uv``
and the output projection, at the softmax scale ``1/sqrt(hd + dr)``.
Its dense layout: ``mla_attention_prefill`` (a whole prompt from
position 0 through the MLA chunk prefill kernel at offset 0) and
``mla_attention_decode`` (the MLA decode kernel over the latent slot
cache [B,S,dl+dr] seen as pages).  The JAX package's
``mla_attention_prefill`` runs the non-absorbed form instead; both
compute the same function.  MLA trains in that non-absorbed form, as
the JAX package does (``mla_attention_train``): keys and values
expanded per head (``mla_expand``, shared with ``mla_attention_suffix``)
and causal attention at Q/K hd + dr over V hd through the flash prefill
kernel and its backward.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from repro_torch.config import ModelConfig
from repro_torch.distributed.sharding import is_dtensor, per_shard
from repro_torch.kernels import abstract, ops, ref
from repro_torch.models.common import NOSHARD, PSpec, apply_rope


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


def attn_pspecs(cfg: ModelConfig, *, cross: bool = False) -> Dict[str, PSpec]:
    """A self-attention block's weights; a cross-attention block
    (``cross=True``) has no q/k/v bias."""
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
    if cfg.qkv_bias and not cross:
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
                cfg: ModelConfig, *, rope: bool = True, shd=NOSHARD):
    """x [B,S,D] -> q [B,S,Hq,hd], k/v [B,S,Hkv,hd] (RoPE applied).
    Under a mesh q is split over heads; k/v keep the placement their
    weights give them, as in the JAX package; x enters whole along the
    sequence (a sequence-parallel residual is gathered)."""
    x = shd(x, "batch", "seq", None)
    q, k, v = _proj(x, p["wq"]), _proj(x, p["wk"]), _proj(x, p["wv"])
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = shd(q, "batch", "seq", "heads", None)
    if rope and cfg.rope_theta > 0:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v.contiguous()


def out_proj(o: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """einsum("...hk,hkd->...d") as one matmul."""
    h, k, d = wo.shape
    return torch.matmul(o.flatten(-2), wo.reshape(h * k, d))


class RepeatHeads(torch.autograd.Function):
    """K/V [B,S,Hkv,d] -> [B,S,Hkv*g,d], each head repeated g times in
    place (``repeat_interleave``).  The backward sums each group's
    gradients: shard by shard where the head split cuts whole groups
    (Hkv divides it), else after gathering the heads."""

    @staticmethod
    def forward(ctx, x, g):
        ctx.g = g
        return x.repeat_interleave(g, dim=2)

    @staticmethod
    def backward(ctx, dy):
        def fold(t):
            b, s, h, d = t.shape
            return t.reshape(b, s, h // ctx.g, ctx.g, d).sum(3)

        if not is_dtensor(dy):
            return fold(dy), None
        from torch.distributed.tensor import Replicate, Shard
        from torch.distributed.tensor.experimental import local_map
        mesh = dy.device_mesh
        split = [i for i, p in enumerate(dy.placements)
                 if isinstance(p, Shard) and p.dim == 2]
        hkv = dy.shape[2] // ctx.g
        if split and hkv % math.prod(mesh.size(i) for i in split) == 0:
            pl = list(dy.placements)
            return local_map(fold, out_placements=pl, in_placements=(pl,),
                             device_mesh=mesh)(dy), None
        return fold(dy.redistribute(mesh, [
            Replicate() if i in split else p
            for i, p in enumerate(dy.placements)])), None


# ---------------------------------------------------------------------------
# Exact causal attention (monolithic prefill)
# ---------------------------------------------------------------------------
def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     *, q_offset: int = 0, backend: Optional[str] = None,
                     shd=NOSHARD) -> torch.Tensor:
    """q [B,Sq,Hq,hd] at positions q_offset + i; k [B,Sk,Hkv,hd]; v
    [B,Sk,Hkv,dv] -> [B,Sq,Hq,dv]: query i attends keys t <= q_offset + i
    (dv == hd but for MLA's non-absorbed form, Q/K hd + dr over V hd).

    With no offset over its own keys (Sq == Sk) this is the flash
    prefill kernel (``ops.flash_causal``: the CUDA kernel on the card,
    its plain version on the CPU).  A suffix after a cached prefix
    (q_offset > 0) runs plain PyTorch on both devices, as the JAX
    package runs it in ``jnp``: float32 softmax and accumulation.

    Under a mesh (``shd.active``) GQA keys and values are first repeated
    to the query heads and split over heads with them, as the JAX
    package orders it, so each head shard holds whole groups."""
    sq, sk = q.shape[1], k.shape[1]
    hq, hkv = q.shape[2], k.shape[2]
    if shd.active and hkv != hq:
        k, v = (shd(RepeatHeads.apply(t, hq // hkv), "batch", "seq",
                    "heads", None) for t in (k, v))
    if q_offset == 0 and sq == sk:
        return ops.flash_causal(q.contiguous(), k.contiguous(),
                                v.contiguous(), backend=backend)
    mask = ref.causal_mask(sq, sk, q_offset, q.device)
    return ref._attend(q, k, v, mask.expand(q.shape[0], sq, sk))


# ---------------------------------------------------------------------------
# Bidirectional attention (an encoder, and cross-attention to a memory)
# ---------------------------------------------------------------------------
def full_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   kv_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q [B,Sq,Hq,hd]; k/v [B,Sk,Hkv,hd]; kv_mask [B,Sk] bool (the keys
    to attend) -> [B,Sq,Hq,hd] in v's dtype.

    Plain PyTorch on both devices, as the JAX package computes it in
    ``jnp`` outside any kernel: grouped scores in the inputs' dtype,
    then float32 scaled by ``1/sqrt(hd)``, masked keys at -1e30, a
    float32 softmax, and the probabilities cast to v's dtype for the
    product with V."""
    b, sq, hq, hd = q.shape
    hkv = k.shape[2]
    if is_dtensor(q):
        # as causal_attention under a mesh: K/V repeated to the query
        # heads, so a head split of q never cuts a group; then each
        # rank's rows and heads on their own
        if hkv != hq:
            k, v = (RepeatHeads.apply(t, hq // hkv) for t in (k, v))
        return per_shard(full_attention, (q, k, v, kv_mask),
                         ((0, 2), (0, 2), (0, 2),
                          None if kv_mask is None else (0, None)), ((0, 2),))
    qg = q.reshape(b, sq, hkv, hq // hkv, hd)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k).float() / math.sqrt(hd)
    if kv_mask is not None:
        s = s.masked_fill(~kv_mask[:, None, None, None, :], ref.NEG_INF)
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.einsum("bhgqk,bkhd->bqhgd", p, v).reshape(b, sq, hq, -1)


def cross_kv(p: Dict, mem: torch.Tensor):
    """A cross-attention block's keys and values over a memory mem
    [B,P,D] (projected image patches, or the encoder's output): k/v
    [B,P,Hkv,hd], no bias and no RoPE."""
    return _proj(mem, p["wk"]), _proj(mem, p["wv"])


def cross_attention(p: Dict, h: torch.Tensor, xk: torch.Tensor,
                    xv: torch.Tensor, shd=NOSHARD) -> torch.Tensor:
    """Queries of h [B,S,D] over the memory's xk/xv [B,P,Hkv,hd]
    (``full_attention``), through the output projection: [B,S,D].
    Under a mesh h enters whole, and the query product's partial input
    gradient is all-reduced there (as ``project_qkv``'s is), before the
    norm that made h runs its backward."""
    h = shd(h, "batch", "seq", None)
    return out_proj(full_attention(_proj(h, p["wq"]), xk, xv), p["wo"])


# ---------------------------------------------------------------------------
# Decode over the dense slot cache [B, S, ...]
# ---------------------------------------------------------------------------
def cache_write(cache: torch.Tensor, new: torch.Tensor,
                lengths: torch.Tensor) -> torch.Tensor:
    """Write one new token per row at its current length, IN PLACE
    (the JAX package returns a new array): cache [B,S,...], new
    [B,1,...], lengths [B].  A length past the cache clamps to its last
    slot, as ``dynamic_update_slice`` clamps its start."""
    pos = lengths.long().clamp(0, cache.shape[1] - 1)
    if is_dtensor(cache):
        return abstract.cache_write(cache, new, pos)
    rows = torch.arange(cache.shape[0], device=cache.device)
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
                     backend: Optional[str] = None,
                     with_lse: bool = False) -> torch.Tensor:
    """q [B,1,Hq,hd]; caches [B,S,Hkv,hd]; lengths [B] int32 = valid
    tokens (the new one included) -> [B,1,Hq,hd] (with ``with_lse``
    also each head's log-sum-exp [B,Hq] float32).

    Runs the paged decode kernel over the caches seen as pages
    (``slot_pages``); with int8 caches and their bf16 scales
    [B,S,Hkv,1], the int8 kernel.  DTensor caches split over the
    sequence (the ``kv_seq`` rule) run the split decode
    (``kernels/abstract.split_decode``): each slice through the same
    kernel with its log-sum-exp, merged by them."""
    scales = () if k_scale is None else (k_scale, v_scale)
    if is_dtensor(k_cache):
        return abstract.split_decode(
            q, k_cache, v_cache, lengths, k_scale, v_scale,
            attend=lambda q1, k, v, n, *sc, with_lse=False: _squeeze(
                decode_attention(q1[:, None], k, v, n, *sc,
                                 backend=backend, with_lse=with_lse)))
    (kp, vp, *sp), tables = slot_pages(k_cache, v_cache, *scales)
    q1 = q[:, 0].contiguous()
    if k_scale is None:
        o = ops.paged_decode(q1, kp, vp, tables, lengths, backend=backend,
                             with_lse=with_lse)
    else:
        o = ops.paged_decode_int8(q1, kp, vp, *sp, tables, lengths,
                                  backend=backend, with_lse=with_lse)
    return (o[0][:, None], o[1]) if with_lse else o[:, None]


def _squeeze(o):
    """decode_attention's [B,1,Hq,hd] output (or (output, lse)) with the
    query dim dropped."""
    return (o[0][:, 0], o[1]) if isinstance(o, tuple) else o[:, 0]


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
                cfg: ModelConfig, shd=NOSHARD):
    """x [B,S,D] -> q_nope [B,S,H,hd], q_rope [B,S,H,dr] (RoPE applied)
    and the cached latent [B,S,dl+dr] = [c_kv ; RoPE(k_rope)]."""
    dr = cfg.d_rope
    x = shd(x, "batch", "seq", None)
    q = _proj(x, p["wq"])
    q_nope, q_rope = q[..., :-dr], q[..., -dr:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    c_kv = torch.matmul(x, p["w_dkv"])
    k_rope = torch.matmul(x, p["w_kr"])
    k_rope = apply_rope(k_rope[:, :, None, :], positions,
                        cfg.rope_theta)[:, :, 0, :]
    return q_nope, q_rope, shd(torch.cat([c_kv, k_rope], dim=-1), "batch",
                               "seq", None)


def mla_scale(cfg: ModelConfig) -> float:
    """The MLA softmax scale of every path: ``1/sqrt(hd + dr)``, the
    query width of the non-absorbed form."""
    return 1.0 / math.sqrt(cfg.hd + cfg.d_rope)


def mla_absorbed(p: Dict, x: torch.Tensor, positions: torch.Tensor,
                 cfg: ModelConfig, attend, shd=NOSHARD):
    """One absorbed-MLA attention sublayer: project, fold W_uk into the
    query, ``attend(q_lat, q_rope, latent) -> ctx`` runs a kernel in
    latent space, then W_uv and the output projection.  Returns (out
    [B,S,D], latent [B,S,dl+dr])."""
    q_nope, q_rope, latent = mla_project(p, x, positions, cfg, shd)
    q_lat = torch.einsum("...hk,lhk->...hl", q_nope, p["w_uk"]).contiguous()
    ctx = attend(q_lat, q_rope.contiguous(), latent)
    out = torch.einsum("...hl,lhk->...hk", ctx, p["w_uv"])
    return out_proj(out, p["wo"]), latent


def mla_attention_prefill(p: Dict, x: torch.Tensor, cfg: ModelConfig,
                          backend: Optional[str] = None, shd=NOSHARD):
    """Causal MLA over whole prompts x [B,S,D] from position 0; returns
    (out [B,S,D], latent [B,S,dl+dr]).  The MLA chunk prefill kernel
    (``ops.mla_prefill``) at offset 0 with the whole prompt as the
    chunk: it reads no pool token, so the pool is one empty page of 64
    tokens (the paged path's page, so the kernel runs the body it runs
    there)."""
    b, s = x.shape[:2]
    positions = torch.arange(s, device=x.device)[None, :]
    empty = x.new_zeros((1, 64, cfg.d_latent + cfg.d_rope))
    tables = torch.zeros((b, 1), dtype=torch.int32, device=x.device)
    offsets = torch.zeros((b,), dtype=torch.int32, device=x.device)
    return mla_absorbed(
        p, x, positions, cfg,
        lambda q_lat, q_rope, latent: ops.mla_prefill(
            q_lat, q_rope, latent, empty,
            tables, offsets, d_latent=cfg.d_latent, scale=mla_scale(cfg),
            backend=backend), shd)


def mla_expand(p: Dict, q_nope: torch.Tensor, q_rope: torch.Tensor,
               latent: torch.Tensor, cfg: ModelConfig):
    """The non-absorbed form's per-head tensors: q [B,Sq,H,hd+dr] =
    [q_nope ; q_rope]; from latent [B,Sk,dl+dr] = [c_kv ; k_rope], k
    [B,Sk,H,hd+dr] = [c_kv W_uk ; k_rope] (the shared RoPE key copied
    into every head, as JAX's ``broadcast_to``) and v [B,Sk,H,hd] = c_kv
    W_uv.  q and k are contiguous."""
    dl, dr = cfg.d_latent, cfg.d_rope
    c_kv, k_rope = latent[..., :dl], latent[..., dl:]
    k = torch.einsum("bsl,lhk->bshk", c_kv, p["w_uk"])
    v = torch.einsum("bsl,lhk->bshk", c_kv, p["w_uv"])
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k, k_rope[:, :, None, :].expand(k.shape[:3] + (dr,))],
                  dim=-1)
    return q, k, v


def mla_attention_train(p: Dict, x: torch.Tensor, positions: torch.Tensor,
                        cfg: ModelConfig, backend: Optional[str] = None,
                        shd=NOSHARD) -> torch.Tensor:
    """Causal MLA over x [B,S,D] from position 0 in the non-absorbed
    form the JAX package trains (its ``mla_attention_prefill``): project,
    expand keys and values per head (``mla_expand``), then
    ``causal_attention`` at Q/K hd + dr over V hd (192 / 128 at
    DeepSeek-V3 width; scale 1/sqrt(hd + dr) = ``mla_scale``), so under
    grad ``FlashCausal`` (the flash prefill kernel with ``lse`` and its
    backward on the card, the plain versions on the CPU).  Returns out
    [B,S,D]; the gradient of the shared RoPE key sums over the heads."""
    q_nope, q_rope, latent = mla_project(p, x, positions, cfg, shd)
    q, k, v = mla_expand(p, q_nope, q_rope, latent, cfg)
    return out_proj(causal_attention(q, k, v, backend=backend, shd=shd),
                    p["wo"])


def mla_attention_suffix(p: Dict, x: torch.Tensor, prefix: torch.Tensor,
                         q_offset: int, cfg: ModelConfig, shd=NOSHARD):
    """A prompt suffix x [B,S,D] at positions q_offset + i after its
    cached prefix latent [B,q_offset,dl+dr], in the non-absorbed form of
    the JAX package's ``prefill_suffix``: keys and values expanded per
    head from [prefix ; suffix] latents (``mla_expand``), plain attention
    (``ref._attend``, Q/K 192 wide over V 128 at DeepSeek-V3 width) on
    both devices.  Returns (out [B,S,D], the suffix latent
    [B,S,dl+dr])."""
    positions = q_offset + torch.arange(x.shape[1], device=x.device)[None, :]
    q_nope, q_rope, latent = mla_project(p, x, positions, cfg, shd)
    full = torch.cat([prefix.to(latent.dtype), latent], dim=1)
    q, k, v = mla_expand(p, q_nope, q_rope, full, cfg)
    sq, sk = q.shape[1], k.shape[1]
    mask = ref.causal_mask(sq, sk, q_offset, x.device)
    o = ref._attend(q, k, v, mask.expand(q.shape[0], sq, sk))
    return out_proj(o, p["wo"]), latent


def mla_attention_decode(p: Dict, x: torch.Tensor,
                         latent_cache: torch.Tensor, lengths: torch.Tensor,
                         cfg: ModelConfig, backend: Optional[str] = None,
                         shd=NOSHARD):
    """Absorbed-form decode of x [B,1,D] over the latent slot cache
    [B,S,dl+dr]: the new token's latent is written at ``lengths - 1``
    (in place), then the MLA decode kernel (``ops.mla_decode``) reads
    each row's ``lengths`` tokens through the cache seen as pages
    (``slot_pages``).  Returns (out [B,1,D], latent_cache)."""
    (pages,), tables = slot_pages(latent_cache)

    def attend(q_lat, q_rope, latent):
        cache_write(latent_cache, latent, lengths - 1)
        return ops.mla_decode(q_lat[:, 0], q_rope[:, 0], pages, tables,
                              lengths, d_latent=cfg.d_latent,
                              scale=mla_scale(cfg), backend=backend)[:, None]
    out, _ = mla_absorbed(p, x, (lengths - 1)[:, None], cfg, attend, shd)
    return out, latent_cache
