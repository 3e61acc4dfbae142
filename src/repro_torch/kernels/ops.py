"""Public paged attention ops with backend dispatch.

Same signatures and layouts as the JAX package's ``kernels/ops.py``
(``paged_decode``, ``paged_prefill``, ``paged_prefill_seg``, the
absorbed-MLA ``mla_decode``, ``mla_prefill``, ``mla_prefill_seg``, the
dense causal ``flash_causal`` and the int8 ``paged_decode_int8``).
Each op resolves its backend through ``kernels/backend.py``: the CUDA
kernel for CUDA tensors, the plain PyTorch version for CPU tensors, and
the plain version on the card only when ``backend="torch"`` is named
explicitly.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_prefill import FlashCausal, flash_prefill
from repro_torch.kernels.mla_paged_decode import mla_paged_decode
from repro_torch.kernels.paged_attention import (paged_decode_attention,
                                                 paged_decode_attention_int8)
from repro_torch.kernels.paged_prefill import (mla_paged_prefill,
                                               mla_paged_prefill_segments,
                                               paged_prefill_attention,
                                               paged_prefill_segments)


def paged_decode(q, k_pages, v_pages, block_tables, lengths,
                 backend: str | None = None, with_lse: bool = False):
    """Paged decode attention (GQA/MHA/MQA): q [B,Hq,hd] over block-table
    indirected KV pages -> [B,Hq,hd] (and with ``with_lse`` each head's
    log-sum-exp [B,Hq] float32)."""
    return paged_decode_attention(q, k_pages, v_pages, block_tables,
                                  lengths, backend=backend,
                                  with_lse=with_lse)


def paged_prefill(q, k_chunk, v_chunk, k_pages, v_pages, block_tables,
                  offsets, backend: str | None = None):
    """Chunked prefill: full attention to pool tokens < offset (block
    table indirection) + causal attention within the chunk."""
    return paged_prefill_attention(q, k_chunk, v_chunk, k_pages, v_pages,
                                   block_tables, offsets, backend=backend)


def paged_prefill_seg(q, k_chunk, v_chunk, k_pages, v_pages, block_tables,
                      chunk_positions, backend: str | None = None):
    """Segment prefill: per-query absolute positions (``chunk_positions``
    [B,C] int32, ascending valid entries, negative = padding)."""
    return paged_prefill_segments(q, k_chunk, v_chunk, k_pages, v_pages,
                                  block_tables, chunk_positions,
                                  backend=backend)


def mla_decode(q_lat, q_rope, latent_pages, block_tables, lengths,
               d_latent: int, scale: float | None = None,
               backend: str | None = None):
    """Absorbed-MLA paged decode over latent pages -> ctx [B,Hq,dl]."""
    return mla_paged_decode(q_lat, q_rope, latent_pages, block_tables,
                            lengths, d_latent=d_latent, scale=scale,
                            backend=backend)


def mla_prefill(q_lat, q_rope, lat_chunk, latent_pages, block_tables,
                offsets, d_latent: int, scale: float | None = None,
                backend: str | None = None):
    """Absorbed-MLA chunked prefill over latent pages."""
    return mla_paged_prefill(q_lat, q_rope, lat_chunk, latent_pages,
                             block_tables, offsets, d_latent=d_latent,
                             scale=scale, backend=backend)


def mla_prefill_seg(q_lat, q_rope, lat_chunk, latent_pages, block_tables,
                    chunk_positions, d_latent: int,
                    scale: float | None = None, backend: str | None = None):
    """Absorbed-MLA segment prefill over latent pages (same position
    semantics as ``paged_prefill_seg``)."""
    return mla_paged_prefill_segments(q_lat, q_rope, lat_chunk, latent_pages,
                                      block_tables, chunk_positions,
                                      d_latent=d_latent, scale=scale,
                                      backend=backend)


def flash_causal(q, k, v, backend: str | None = None):
    """Causal prefill attention. q [B,S,Hq,dk], k [B,S,Hkv,dk], v
    [B,S,Hkv,dv] -> [B,S,Hq,dv] (dv == dk, or MLA's 192 / 128 on the
    card); any S.  When autograd records and an input requires grad
    (training), through ``FlashCausal``: the forward kernel with its
    ``lse``, then the backward kernel."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashCausal.apply(q, k, v, backend)
    return flash_prefill(q, k, v, backend=backend)


def paged_decode_int8(q, k_pages, v_pages, k_scales, v_scales, block_tables,
                      lengths, backend: str | None = None,
                      with_lse: bool = False):
    """int8-paged decode (per-token-head scales, applied to the scores
    and the probabilities): q [B,Hq,hd] -> [B,Hq,hd] (``with_lse`` as
    in ``paged_decode``)."""
    return paged_decode_attention_int8(q, k_pages, v_pages, k_scales,
                                       v_scales, block_tables, lengths,
                                       backend=backend, with_lse=with_lse)
