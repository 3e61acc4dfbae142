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
    """pages [N,page,Hkv,hd], tables [B,P] -> [B, P*page, Hkv, hd]."""
    n, page, hkv, hd = pages.shape
    b, p = tables.shape
    idx = tables.long().clamp(0, n - 1)
    return pages[idx].reshape(b, p * page, hkv, hd)


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            mask: torch.Tensor) -> torch.Tensor:
    """q [B,C,Hq,hd]; k/v [B,T,Hkv,hd]; mask [B,C,T] bool
    -> [B,C,Hq,hd] in q's dtype (float32 softmax and accumulation)."""
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
    return o.reshape(b, c, hq, hd).to(q.dtype)


def paged_decode_attention(q, k_pages, v_pages, block_tables, lengths):
    """q [B,Hq,hd]; k/v_pages [N,page,Hkv,hd]; block_tables [B,P];
    lengths [B] -> [B,Hq,hd]: each row attends its pool tokens < length."""
    k = _gather(k_pages, block_tables)
    v = _gather(v_pages, block_tables)
    pos = torch.arange(k.shape[1], device=q.device)
    mask = (pos[None, :] < lengths.long()[:, None])[:, None, :]
    return _attend(q[:, None], k, v, mask)[:, 0]


def _chunk_attend(q, k_chunk, v_chunk, k_pages, v_pages, block_tables,
                  prior: torch.Tensor) -> torch.Tensor:
    """Pool tokens where ``prior`` [B,C,T_pool] holds, plus chunk tokens
    j <= i (causal by index)."""
    c = q.shape[1]
    kp = _gather(k_pages, block_tables)
    vp = _gather(v_pages, block_tables)
    k = torch.cat([kp.float(), k_chunk.float()], dim=1)
    v = torch.cat([vp.float(), v_chunk.float()], dim=1)
    idx = torch.arange(c, device=q.device)
    causal = (idx[None, :] <= idx[:, None])[None].expand(q.shape[0], c, c)
    return _attend(q, k, v, torch.cat([prior, causal], dim=2))


def paged_prefill_attention(q, k_chunk, v_chunk, k_pages, v_pages,
                            block_tables, offsets):
    """q [B,C,Hq,hd] at positions offset+i attends pool tokens < offset
    (through the block table) plus chunk tokens j <= i."""
    t = block_tables.shape[1] * k_pages.shape[1]
    pos = torch.arange(t, device=q.device)
    prior = (pos[None, :] < offsets.long()[:, None])[:, None, :]
    prior = prior.expand(q.shape[0], q.shape[1], t)
    return _chunk_attend(q, k_chunk, v_chunk, k_pages, v_pages,
                         block_tables, prior)


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
    cp = chunk_positions.long()
    pos = torch.arange(t, device=q.device)
    own = (pos[None, None, :] == cp[:, :, None]).any(dim=1)     # [B, T]
    prior = (pos[None, None, :] < cp[:, :, None]) & ~own[:, None, :]
    return _chunk_attend(q, k_chunk, v_chunk, k_pages, v_pages,
                         block_tables, prior)
