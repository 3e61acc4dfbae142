"""The kernels' costs: bytes moved and operations done by one call, and
the least time an H100 could take for them.

One set of formulas serves two callers, so they cannot drift apart:
``chip_smoke.py`` prices each kernel's bound column from them, and the
dry run (``launch/opcost.py``) prices each kernel call it traces on meta
tensors.  Bytes count each input read once and each output written
once; operations count the multiply-adds of the attended (query, key)
pairs, 2 flops each.

Each cost function takes a dict of the call's tensors (real or meta:
only shapes and dtypes are read).  Where the work depends on the data
(the tokens a decode row attends), the caller passes the count; by
default it is read from the ``lengths`` tensor, which the dry run does
not have: it passes the cache's whole window, the steady state of a
long-context decode.

``record`` hands an abstract kernel call's cost to the active
``recording`` sinks (the dry run's counter); outside a recording it
does nothing.
"""
from __future__ import annotations

import contextlib
from typing import Callable, List, Optional

from repro_torch.launch.mesh import HBM_BW, PEAK_FLOPS_BF16, PEAK_FLOPS_F32

_SINKS: List[Callable] = []


@contextlib.contextmanager
def recording(sink: Callable):
    """Within the block, ``sink(name, nbytes, flops, peak)`` receives
    every abstract kernel call's cost."""
    _SINKS.append(sink)
    try:
        yield sink
    finally:
        _SINKS.remove(sink)


def record(name: str, nbytes: float, flops: float,
           peak: float = PEAK_FLOPS_BF16) -> None:
    for sink in _SINKS:
        sink(name, nbytes, flops, peak)


def bound(nbytes: float, flops: float, peak: float = PEAK_FLOPS_BF16):
    """(ms, "bytes" or "operations"): the larger of the bytes over the
    HBM rate and the operations over the peak rate of their type."""
    t_bytes = nbytes / HBM_BW
    t_ops = flops / peak
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def _tokens(a, tokens: Optional[int]) -> int:
    if tokens is not None:
        return tokens
    return int(a["lengths"].clamp_min(0).sum())


def decode_cost(a, tokens: Optional[int] = None):
    """Paged decode (kernel 1): q read and the output written once, each
    attended token's K and V of every KV head, the tables and lengths;
    4 hd flops a (query head, token)."""
    q, kp = a["q"], a["k_pages"]
    B, Hq, hd = q.shape
    Hkv = kp.shape[2]
    el = kp.element_size()
    toks = _tokens(a, tokens)
    nbytes = (2 * q.numel() * q.element_size() + 2 * toks * Hkv * hd * el
              + a["block_tables"].numel() * 4 + B * 4)
    flops = 4 * toks * Hq * hd
    return nbytes, flops


def int8_decode_cost(a, tokens: Optional[int] = None):
    """Each attended token's int8 K and V of every KV head plus their
    bf16 scales, q read and the output written once; flops as bf16
    decode."""
    q, kp = a["q"], a["k_pages"]
    B, Hq, hd = q.shape
    Hkv = kp.shape[2]
    toks = _tokens(a, tokens)
    nbytes = (2 * q.numel() * q.element_size()
              + 2 * toks * Hkv * (hd * kp.element_size()
                                  + a["k_scales"].element_size())
              + a["block_tables"].numel() * 4 + B * 4)
    return nbytes, 4 * toks * Hq * hd


def prefill_cost(a, attended_pool, causal_pairs):
    """attended_pool: pool tokens read; causal_pairs: sum over queries of
    (pool keys + chunk keys) attended."""
    q, kp = a["q"], a["k_pages"]
    _, C, Hq, hd = q.shape
    Hkv = kp.shape[2]
    el = kp.element_size()
    nbytes = (2 * q.numel() * q.element_size()
              + 2 * a["k_chunk"].numel() * a["k_chunk"].element_size()
              + 2 * attended_pool * Hkv * hd * el
              + a["block_tables"].numel() * 4 + 4 * C)
    flops = 4 * causal_pairs * Hq * hd
    return nbytes, flops


def mla_cost(a, pool_tokens, pairs):
    """Bytes (each input read once, the context written once) and flops
    of one MLA call: per attended (query, key) pair, Hq * (2*dk + 2*dl)
    flops (scores over dl + dr, then the context over dl)."""
    q_lat, q_rope, lat = a["q_lat"], a["q_rope"], a["latent_pages"]
    Hq, dl = q_lat.shape[-2:]
    dk = dl + q_rope.shape[-1]
    eq = q_lat.element_size()
    ints = a.get("lengths", a.get("offsets", a.get("chunk_positions")))
    nbytes = ((2 * q_lat.numel() + q_rope.numel()) * eq
              + pool_tokens * dk * lat.element_size()
              + (a["lat_chunk"].numel() * eq if "lat_chunk" in a else 0)
              + (a["block_tables"].numel() + ints.numel()) * 4)
    return nbytes, pairs * Hq * (2 * dk + 2 * dl)


def flash_cost(a):
    """Bytes (q, k, v read once, the output written once) and flops
    (2 (dk + dv) per attended (query, key) pair and query head: QK^T over
    dk, PV over dv) of one causal prefill."""
    q, k, v = a["q"], a["k"], a["v"]
    B, S, Hq, dk = q.shape
    dv = v.shape[-1]
    el = q.element_size()
    nbytes = (q.numel() + k.numel() + v.numel() + B * S * Hq * dv) * el
    return nbytes, 2 * B * (S * (S + 1) // 2) * Hq * (dk + dv)


def bwd_cost(a):
    """Bytes (q, k, v, o, dO and lse read once, dq, dk, dv written once)
    and flops (2 (3 dk + 2 dv) per attended (query, key) pair and query
    head: the QK^T recompute, dK and dQ over dk, dO V^T and dV over dv;
    10 hd when dk = dv = hd) of one backward, and the peak rate of the
    inputs' type."""
    q, k, v = a["q"], a["k"], a["v"]
    B, S, Hq, dk = q.shape
    dv = v.shape[-1]
    el = q.element_size()
    nbytes = (2 * (q.numel() + k.numel() + v.numel() + a["o"].numel())
              * el + a["lse"].numel() * 4)
    peak = PEAK_FLOPS_BF16 if q.dtype != a["lse"].dtype else PEAK_FLOPS_F32
    return (nbytes, 2 * B * (S * (S + 1) // 2) * Hq * (3 * dk + 2 * dv),
            peak)
