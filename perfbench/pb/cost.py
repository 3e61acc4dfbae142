"""The kernels' costs and the H100's peaks, frozen from
``repro_torch/kernels/cost.py`` and ``repro_torch/launch/mesh.py`` so
that a change to the program cannot move the yardstick.

Bytes count each input read once and each output written once;
operations count the multiply-adds of the attended (query, key) pairs,
2 flops each.  Each function takes the call's shapes and element sizes
(``CallShape``) and the data-dependent counts the harness reads from
the call's own lengths, offsets or positions.  The whole block table is
counted, not only the entries a call reads: a few KB a call.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

# NVIDIA's H100 SXM data sheet, dense rates without sparsity
PEAK_FLOPS_BF16 = 989e12
PEAK_FLOPS_F32 = 67e12
HBM_BW = 3.35e12


def bound_s(nbytes: float, flops: float,
            peak: float = PEAK_FLOPS_BF16) -> float:
    """The least time the chip could take: the larger of bytes over the
    HBM rate and operations over the peak rate."""
    return max(nbytes / HBM_BW, flops / peak)


@dataclass(frozen=True)
class CallShape:
    """What a cost needs of one call: the query's shape and element
    size, the pool row (per token, per layer) and its element size, the
    block table's entry count, the count of per-row ints, and for a
    chunk its K/V (or latent) chunk elements."""
    q: Tuple[int, ...]            # [B, Hq, hd] or [B, C, Hq, hd]
    q_el: int
    kv_heads: int                 # GQA: Hkv; MLA: 0
    row: int                      # GQA: hd; MLA: dl (+ dr in q_rope)
    pool_el: int
    table_entries: int
    ints: int
    chunk_el: int = 0             # elements of k_chunk (v_chunk alike) or lat_chunk
    rope: int = 0                 # MLA: dr


def decode_cost(c: CallShape, tokens: int) -> Tuple[float, float]:
    """GQA paged decode (kernel 1): q read and the output written once,
    each attended token's K and V of every KV head, the tables and
    lengths; 4 hd flops a (query head, token)."""
    B, Hq, hd = c.q
    qn = B * Hq * hd
    nbytes = (2 * qn * c.q_el + 2 * tokens * c.kv_heads * hd * c.pool_el
              + c.table_entries * 4 + B * 4)
    return nbytes, 4 * tokens * Hq * hd


def prefill_cost(c: CallShape, attended_pool: int,
                 causal_pairs: int) -> Tuple[float, float]:
    """GQA chunk / segment prefill (kernels 2 / 3): attended_pool pool
    tokens read; causal_pairs the sum over queries of the keys each
    attends."""
    _, C, Hq, hd = c.q
    qn = c.q[0] * C * Hq * hd
    nbytes = (2 * qn * c.q_el + 2 * c.chunk_el * c.q_el
              + 2 * attended_pool * c.kv_heads * hd * c.pool_el
              + c.table_entries * 4 + 4 * C)
    return nbytes, 4 * causal_pairs * Hq * hd


def mla_cost(c: CallShape, pool_tokens: int,
             pairs: int) -> Tuple[float, float]:
    """Absorbed MLA decode or chunk / segment prefill (kernels 4-6):
    q_lat read and the context written, q_rope read, each pool token's
    latent row once, the chunk's latent, tables and ints; per attended
    (query, key) pair Hq (2 dk + 2 dl) flops."""
    Hq, dl = c.q[-2], c.q[-1]
    dk = dl + c.rope
    q_lat_n = 1
    for s in c.q:
        q_lat_n *= s
    q_rope_n = q_lat_n // dl * c.rope
    nbytes = ((2 * q_lat_n + q_rope_n) * c.q_el + pool_tokens * dk * c.pool_el
              + c.chunk_el * c.q_el + (c.table_entries + c.ints) * 4)
    return nbytes, pairs * Hq * (2 * dk + 2 * dl)
