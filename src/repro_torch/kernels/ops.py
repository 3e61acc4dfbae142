"""Public paged attention ops with backend dispatch.

Same signatures and layouts as the JAX package's ``kernels/ops.py``
(``paged_decode``, ``paged_prefill``, ``paged_prefill_seg``).  Each op
resolves its backend through ``kernels/backend.py``: the CUDA kernel for
CUDA tensors, the plain PyTorch version for CPU tensors, and the plain
version on the card only when ``backend="torch"`` is named explicitly.
"""
from __future__ import annotations

from repro_torch.kernels.paged_attention import paged_decode_attention
from repro_torch.kernels.paged_prefill import (paged_prefill_attention,
                                               paged_prefill_segments)


def paged_decode(q, k_pages, v_pages, block_tables, lengths,
                 backend: str | None = None):
    """Paged decode attention (GQA/MHA/MQA): q [B,Hq,hd] over block-table
    indirected KV pages -> [B,Hq,hd]."""
    return paged_decode_attention(q, k_pages, v_pages, block_tables,
                                  lengths, backend=backend)


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

