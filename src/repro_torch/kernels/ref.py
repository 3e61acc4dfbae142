"""Plain PyTorch versions of the paged attention kernels.

These are the ``torch`` backend (``kernels/backend.py``): the CPU path
of every op, and the yardstick each CUDA kernel is held to on the card.
One gather over the pool per op (table entries clamped into the pool,
the clip semantics of the JAX package's ``xla`` fallback), then a dense
masked softmax in float32.  A query row with no attendable key returns
zeros, as the kernels do (``acc / max(l, 1e-30)`` with ``l = 0``).
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def _gather(pages: torch.Tensor, tables: torch.Tensor) -> torch.Tensor:
    """pages [N,page,...], tables [B,P] -> [B, P*page, ...]."""
    n, page = pages.shape[:2]
    b, p = tables.shape
    idx = tables.long().clamp(0, n - 1)
    return pages[idx].reshape((b, p * page) + pages.shape[2:])


def _length_mask(lengths: torch.Tensor, t: int) -> torch.Tensor:
    """[B,1,T]: pool tokens < length."""
    pos = torch.arange(t, device=lengths.device)
    return (pos[None, :] < lengths.long()[:, None])[:, None, :]


def _offset_prior(offsets: torch.Tensor, c: int, t: int) -> torch.Tensor:
    """[B,C,T]: every query of a chunk at ``offset`` attends pool
    tokens < offset."""
    return _length_mask(offsets, t).expand(offsets.shape[0], c, t)


def _segment_prior(chunk_positions: torch.Tensor, t: int) -> torch.Tensor:
    """[B,C,T]: query i attends pool tokens below chunk_positions[b, i]
    except the slots the chunk itself will fill."""
    cp = chunk_positions.long()
    pos = torch.arange(t, device=cp.device)
    own = (pos[None, None, :] == cp[:, :, None]).any(dim=1)     # [B, T]
    return (pos[None, None, :] < cp[:, :, None]) & ~own[:, None, :]


def _with_chunk(prior: torch.Tensor) -> torch.Tensor:
    """Append the chunk's own keys, causal by index, to ``prior``."""
    b, c, _ = prior.shape
    idx = torch.arange(c, device=prior.device)
    causal = (idx[None, :] <= idx[:, None])[None].expand(b, c, c)
    return torch.cat([prior, causal], dim=2)


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            mask: torch.Tensor) -> torch.Tensor:
    """q [B,C,Hq,hd]; k [B,T,Hkv,hd]; v [B,T,Hkv,dv]; mask [B,C,T] bool
    -> [B,C,Hq,dv] in q's dtype (float32 softmax and accumulation; the
    scale is ``1/sqrt(hd)``, q's width)."""
    b, c, hq, hd = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    qg = q.reshape(b, c, hkv, g, hd).float()
    s = torch.einsum("bchgd,bthd->bchgt", qg, k.float()) / math.sqrt(hd)
    m4 = mask[:, :, None, None, :]
    s = s.masked_fill(~m4, NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True)) * m4
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bchgt,bthd->bchgd", p, v.float())
    o = o / l.clamp_min(1e-30)
    return o.reshape(b, c, hq, v.shape[-1]).to(q.dtype)


def paged_decode_attention(q, k_pages, v_pages, block_tables, lengths):
    """q [B,Hq,hd]; k/v_pages [N,page,Hkv,hd]; block_tables [B,P];
    lengths [B] -> [B,Hq,hd]: each row attends its pool tokens < length."""
    k = _gather(k_pages, block_tables)
    v = _gather(v_pages, block_tables)
    return _attend(q[:, None], k, v, _length_mask(lengths, k.shape[1]))[:, 0]


def paged_decode_attention_int8(q, k_pages, v_pages, k_scales, v_scales,
                                block_tables, lengths):
    """As ``paged_decode_attention`` over int8 pages [N,page,Hkv,hd] with
    per-token-head scales [N,page,Hkv,1]: each value is dequantized in
    float32 (``float(int8) * float(scale)``), then attended."""
    k = _gather(k_pages, block_tables).float() * \
        _gather(k_scales, block_tables).float()
    v = _gather(v_pages, block_tables).float() * \
        _gather(v_scales, block_tables).float()
    return _attend(q[:, None], k, v, _length_mask(lengths, k.shape[1]))[:, 0]


def paged_decode_lse(q, k_pages, block_tables, lengths, k_scales=None):
    """Each query head's log-sum-exp of its scaled scores over the row's
    pool tokens < length, [B,Hq] float32 (natural-log units; a row with
    no attendable key gives about NEG_INF): what the split decode merges
    its slices by.  With ``k_scales``, the int8 pages dequantized as
    ``paged_decode_attention_int8`` does."""
    k = _gather(k_pages, block_tables).float()
    if k_scales is not None:
        k = k * _gather(k_scales, block_tables).float()
    b, hq, hd = q.shape
    hkv = k.shape[2]
    qg = q.reshape(b, hkv, hq // hkv, hd).float()
    s = torch.einsum("bhgd,bthd->bhgt", qg, k) / math.sqrt(hd)
    s = s.masked_fill(~_length_mask(lengths, k.shape[1])[:, :, None, :],
                      NEG_INF)
    return torch.logsumexp(s, dim=-1).reshape(b, hq)


def causal_mask(sq: int, sk: int, q_offset: int, device) -> torch.Tensor:
    """[1,Sq,Sk]: query i (at position q_offset + i) attends keys
    t <= q_offset + i."""
    qpos = q_offset + torch.arange(sq, device=device)
    return (torch.arange(sk, device=device)[None, :] <= qpos[:, None])[None]


def flash_prefill(q, k, v):
    """q [B,S,Hq,dk]; k [B,S,Hkv,dk]; v [B,S,Hkv,dv] -> [B,S,Hq,dv]:
    causal attention, query i attends keys j <= i, for any S."""
    b, s = q.shape[:2]
    return _attend(q, k, v, causal_mask(s, s, 0, q.device).expand(b, s, s))


def _causal_scores(q, k):
    """q [B,S,Hq,hd]; k [B,S,Hkv,hd] -> the scaled scores [B,Hkv,G,S,S]
    in float32, NEG_INF where key j > query i."""
    b, s, hq, hd = q.shape
    hkv = k.shape[2]
    qg = q.reshape(b, s, hkv, hq // hkv, hd).float()
    sc = torch.einsum("bihgd,bjhd->bhgij", qg, k.float()) / math.sqrt(hd)
    return sc.masked_fill(~causal_mask(s, s, 0, q.device)[0], NEG_INF)


def flash_prefill_lse(q, k):
    """Each query row's log-sum-exp of its scaled causal scores, [B,Hq,S]
    float32 (natural-log units): the forward kernel's ``lse`` output."""
    b, s, hq = q.shape[:3]
    return torch.logsumexp(_causal_scores(q, k), dim=-1).reshape(b, hq, s)


def flash_prefill_bwd(q, k, v, o, do):
    """The gradients of causal attention (``flash_prefill``) given its
    output o and the output's cotangent do (q [B,S,Hq,dk], k [B,S,Hkv,dk],
    v [B,S,Hkv,dv], o and do [B,S,Hq,dv]): (dq, dk, dv) in the inputs'
    dtypes, computed analytically in float32 for any S, any G = Hq/Hkv
    and any widths: P = softmax(scale QK^T) over keys j <= i (scale
    1/sqrt(dk)), dV = P^T dO, dS = P o (dO V^T - rowsum(dO o O)),
    dQ = scale dS K, dK = scale dS^T Q (each KV head summed over its G
    query heads)."""
    b, s, hq, hd = q.shape
    hkv, dv_w = k.shape[2], v.shape[3]
    scale = 1.0 / math.sqrt(hd)
    qg = q.reshape(b, s, hkv, hq // hkv, hd).float()
    og, dog = (t.reshape(b, s, hkv, hq // hkv, dv_w).float() for t in (o, do))
    kf, vf = k.float(), v.float()
    p = torch.softmax(_causal_scores(q, k), dim=-1)
    dv = torch.einsum("bhgij,bihgd->bjhd", p, dog)
    dp = torch.einsum("bihgd,bjhd->bhgij", dog, vf)
    delta = (dog * og).sum(-1).permute(0, 2, 3, 1)[..., None]   # [b,h,g,i,1]
    ds = p * (dp - delta)
    dq = torch.einsum("bhgij,bjhd->bihgd", ds, kf) * scale
    dk = torch.einsum("bhgij,bihgd->bjhd", ds, qg) * scale
    return (dq.reshape(b, s, hq, hd).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def _chunk_attend(q, k_chunk, v_chunk, k_pages, v_pages, block_tables,
                  prior: torch.Tensor) -> torch.Tensor:
    """Pool tokens where ``prior`` [B,C,T_pool] holds, plus chunk tokens
    j <= i (causal by index)."""
    kp = _gather(k_pages, block_tables)
    vp = _gather(v_pages, block_tables)
    k = torch.cat([kp.float(), k_chunk.float()], dim=1)
    v = torch.cat([vp.float(), v_chunk.float()], dim=1)
    return _attend(q, k, v, _with_chunk(prior))


def paged_prefill_attention(q, k_chunk, v_chunk, k_pages, v_pages,
                            block_tables, offsets):
    """q [B,C,Hq,hd] at positions offset+i attends pool tokens < offset
    (through the block table) plus chunk tokens j <= i."""
    t = block_tables.shape[1] * k_pages.shape[1]
    return _chunk_attend(q, k_chunk, v_chunk, k_pages, v_pages,
                         block_tables, _offset_prior(offsets, q.shape[1], t))


def pool_limits(chunk_positions: torch.Tensor) -> torch.Tensor:
    """Tokens of resident pool context any query of a row may attend:
    the start position of the trailing contiguous run of valid chunk
    positions (everything from there up is the chunk's own writes).
    Reduces to ``offsets`` when the positions are contiguous."""
    cp = chunk_positions.long()
    c = cp.shape[1]
    valid = cp >= 0
    idx = torch.arange(c, device=cp.device)[None, :]
    d = cp - idx                          # constant along a contiguous run
    any_valid = valid.any(dim=1)
    last = torch.where(valid, idx, -1).argmax(dim=1)
    d_last = d.gather(1, last[:, None])
    in_suffix = idx <= last[:, None]
    ok = torch.where(in_suffix, (d == d_last) & valid,
                     torch.ones_like(valid))
    suffix_all = ok.long().flip(1).cumprod(1).flip(1).bool()
    big = torch.iinfo(torch.int32).max
    run_min = torch.where(suffix_all & in_suffix & valid, cp,
                          torch.full_like(cp, big)).amin(dim=1)
    return torch.where(any_valid, run_min,
                       torch.zeros_like(run_min)).to(torch.int32)


def paged_prefill_segments(q, k_chunk, v_chunk, k_pages, v_pages,
                           block_tables, chunk_positions):
    """Query i of row b sits at absolute position chunk_positions[b, i]
    (ascending among valid entries; negative = padding): it attends
    every resident pool token below its position, except the slots the
    chunk itself will fill, plus chunk tokens j <= i."""
    t = block_tables.shape[1] * k_pages.shape[1]
    return _chunk_attend(q, k_chunk, v_chunk, k_pages, v_pages,
                         block_tables, _segment_prior(chunk_positions, t))


# ---------------------------------------------------------------------------
# absorbed MLA over a latent pool [N, page, dl+dr]
# ---------------------------------------------------------------------------
def mla_scale(d_latent: int, d_rope: int, scale=None) -> float:
    """The kernels' default softmax scale, ``1/sqrt(dl//4 + dr)`` (the
    JAX package's oracle convention, hd ~ dl/4); an explicit ``scale``
    overrides it (the engine passes ``1/sqrt(hd + dr)``)."""
    return 1.0 / math.sqrt(d_latent // 4 + d_rope) if scale is None else scale


def _mla_attend(q_lat: torch.Tensor, q_rope: torch.Tensor, lat: torch.Tensor,
                mask: torch.Tensor, d_latent: int, scale) -> torch.Tensor:
    """q_lat [B,C,Hq,dl]; q_rope [B,C,Hq,dr]; lat [B,T,dl+dr] (value =
    its first dl columns); mask [B,C,T] -> ctx [B,C,Hq,dl] in q_lat's
    dtype (float32 scores, softmax and accumulation)."""
    scale = mla_scale(d_latent, q_rope.shape[-1], scale)
    lat = lat.float()
    c, kr = lat[..., :d_latent], lat[..., d_latent:]
    s = (torch.einsum("bchl,btl->bcht", q_lat.float(), c)
         + torch.einsum("bchr,btr->bcht", q_rope.float(), kr)) * scale
    m4 = mask[:, :, None, :]
    s = s.masked_fill(~m4, NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True)) * m4
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bcht,btl->bchl", p, c) / l.clamp_min(1e-30)
    return o.to(q_lat.dtype)


def mla_paged_decode(q_lat, q_rope, latent_pages, block_tables, lengths,
                     d_latent: int, scale=None):
    """q_lat [B,Hq,dl]; q_rope [B,Hq,dr]; latent_pages [N,page,dl+dr];
    block_tables [B,P]; lengths [B] -> ctx [B,Hq,dl]: each row attends
    its pool tokens < length."""
    lat = _gather(latent_pages, block_tables)
    return _mla_attend(q_lat[:, None], q_rope[:, None], lat,
                       _length_mask(lengths, lat.shape[1]), d_latent,
                       scale)[:, 0]


def _mla_chunk_attend(q_lat, q_rope, lat_chunk, latent_pages, block_tables,
                      prior: torch.Tensor, d_latent: int, scale):
    """Pool tokens where ``prior`` [B,C,T_pool] holds, plus chunk tokens
    j <= i (causal by index)."""
    lat = torch.cat([_gather(latent_pages, block_tables).float(),
                     lat_chunk.float()], dim=1)
    return _mla_attend(q_lat, q_rope, lat, _with_chunk(prior), d_latent,
                       scale)


def mla_paged_prefill(q_lat, q_rope, lat_chunk, latent_pages, block_tables,
                      offsets, d_latent: int, scale=None):
    """q_lat [B,C,Hq,dl]; q_rope [B,C,Hq,dr]; lat_chunk [B,C,dl+dr] at
    positions offset+i attend pool tokens < offset plus chunk tokens
    j <= i -> ctx [B,C,Hq,dl]."""
    t = block_tables.shape[1] * latent_pages.shape[1]
    return _mla_chunk_attend(q_lat, q_rope, lat_chunk, latent_pages,
                             block_tables,
                             _offset_prior(offsets, q_lat.shape[1], t),
                             d_latent, scale)


def mla_paged_prefill_segments(q_lat, q_rope, lat_chunk, latent_pages,
                               block_tables, chunk_positions, d_latent: int,
                               scale=None):
    """As ``paged_prefill_segments`` in latent form: query i at
    chunk_positions[b, i] (negative = padding) attends resident pool
    tokens below its position except the chunk's own slots, plus chunk
    tokens j <= i."""
    t = block_tables.shape[1] * latent_pages.shape[1]
    return _mla_chunk_attend(q_lat, q_rope, lat_chunk, latent_pages,
                             block_tables, _segment_prior(chunk_positions, t),
                             d_latent, scale)
