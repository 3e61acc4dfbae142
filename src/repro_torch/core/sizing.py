"""Architecture-variant-aware KV cache sizing engine (paper §III-A, eq. (3)).

The engine replaces the universal MHA formula with a dispatch on the
attention variant inferred from the model config:

    B(n) = 2 * h    * d * p * n      MHA
    B(n) = 2 * h_kv * d * p * n      GQA / MQA
    B(n) = (d_latent + d_rope) * p * n   MLA

Tensor-parallel conventions (reverse-engineered so every cell of the
paper's Table III reproduces exactly — see tests/test_sizing.py):

  * ``status-quo`` sizing (the "MHA batch" column) models today's
    frameworks: MHA-equivalent byte counts with **query heads sharded by
    TP** (each GPU budgets for h_q / tp heads).
  * ``arch-aware`` sizing (our engine) uses the exact variant formula with
    the KV state **replicated across TP** — conservative and correct for
    MLA, whose latent vector is shared by all heads and cannot be
    head-sharded.

SSM / RWKV architectures have O(1) recurrent state instead of a KV cache;
``recurrent_state_bytes`` sizes it (the paper's technique degenerates to a
fixed-size allocation for these — DESIGN.md §Arch-applicability).
"""
from __future__ import annotations

import math
from dataclasses import dataclass

from repro_torch.config import (GQA, MHA, MLA, MQA, FAMILY_HYBRID, FAMILY_RWKV,
                          FAMILY_ENCDEC, ModelConfig)

BYTES = {"bfloat16": 2, "float16": 2, "float32": 4, "int8": 1, "int4": 0.5}


def dtype_bytes(dtype: str) -> float:
    return BYTES[dtype]


# ---------------------------------------------------------------------------
# Per-token-per-layer bytes — eq. (3)
# ---------------------------------------------------------------------------
def per_token_layer_bytes(cfg: ModelConfig, *, p: float | None = None,
                          tp: int = 1, shard_kv: bool = False) -> float:
    """Exact per-layer KV bytes for ONE token under the inferred variant.

    ``tp``/``shard_kv``: optionally divide the head dimension count by the
    tensor-parallel degree (only meaningful for head-sharded variants; MLA
    latent state is never sharded).
    """
    p = dtype_bytes(cfg.dtype) if p is None else p
    variant = cfg.attention_variant
    d = cfg.hd
    if variant == MLA:
        return (cfg.d_latent + cfg.d_rope) * p
    if variant == "none":          # RWKV — no per-token KV state at all
        return 0.0
    h_kv = cfg.n_kv_heads
    if shard_kv and tp > 1:
        h_kv = max(1, math.ceil(h_kv / tp))
    return 2 * h_kv * d * p


def mha_equivalent_bytes(cfg: ModelConfig, *, p: float | None = None,
                         tp: int = 1) -> float:
    """The universal-MHA fallback today's frameworks apply to unsupported
    variants (q heads sharded by TP)."""
    p = dtype_bytes(cfg.dtype) if p is None else p
    h_q = max(1, math.ceil(cfg.n_heads / tp))
    return 2 * h_q * cfg.hd * p


# ---------------------------------------------------------------------------
# Sequence / batch level — eq. (4)
# ---------------------------------------------------------------------------
def seq_bytes(cfg: ModelConfig, n: int, **kw) -> float:
    """Full-model KV bytes for one sequence of n tokens: L * B(n)."""
    return cfg.n_layers * per_token_layer_bytes(cfg, **kw) * n


def total_bytes(cfg: ModelConfig, batch: int, n: int, **kw) -> float:
    """M_total = B_s * L * B(n_max)   (eq. (4))."""
    return batch * seq_bytes(cfg, n, **kw)


def max_batch(cfg: ModelConfig, budget_bytes: float, n_max: int, **kw) -> int:
    """B_s* = floor(M_target / (L * B(n_max)))."""
    per_seq = seq_bytes(cfg, n_max, **kw)
    if per_seq <= 0:
        return 1 << 30               # recurrent archs: not KV-bound
    return int(budget_bytes // per_seq)


def status_quo_max_batch(cfg: ModelConfig, budget_bytes: float, n_max: int,
                         *, tp: int = 8) -> int:
    """Batch size under MHA-equivalent sizing (paper Table III col 1)."""
    per_seq = cfg.n_layers * mha_equivalent_bytes(cfg, tp=tp) * n_max
    return int(budget_bytes // per_seq)


# ---------------------------------------------------------------------------
# Recurrent state (SSM / RWKV / hybrid) — the paper's formula extended
# ---------------------------------------------------------------------------
def recurrent_state_bytes(cfg: ModelConfig, *, p: float | None = None) -> float:
    """Per-sequence persistent state for attention-free mixing layers."""
    p = dtype_bytes(cfg.dtype) if p is None else p
    if cfg.family == FAMILY_RWKV:
        # wkv state [H, d_head, d_head] + token-shift vectors (2 per layer)
        per_layer = cfg.n_heads * cfg.hd * cfg.hd + 2 * cfg.d_model
        return cfg.n_layers * per_layer * p
    if cfg.family == FAMILY_HYBRID:
        per_layer = (cfg.n_ssm_heads * cfg.ssm_head_dim * cfg.ssm_state
                     + (cfg.d_inner + 2 * cfg.ssm_state) * cfg.ssm_conv)
        return cfg.n_layers * per_layer * p
    return 0.0


def decode_state_bytes(cfg: ModelConfig, n: int, batch: int = 1) -> float:
    """Total decode-time state: KV cache (attention layers) + recurrent."""
    kv = 0.0
    if cfg.family == FAMILY_HYBRID:
        kv = len(cfg.attn_layer_ids()) * per_token_layer_bytes(cfg) * n
    elif cfg.family == FAMILY_ENCDEC:
        kv = cfg.n_layers * per_token_layer_bytes(cfg) * (n + cfg.enc_len)
    elif cfg.family != FAMILY_RWKV:
        kv = seq_bytes(cfg, n)
        if cfg.family == "vlm":
            kv += len(cfg.cross_attn_layer_ids()) * \
                per_token_layer_bytes(cfg) * cfg.n_patches
    return batch * (kv + recurrent_state_bytes(cfg))


# ---------------------------------------------------------------------------
# Block sizing (paper §III-B Tier 0: arch-aware block granularity)
# ---------------------------------------------------------------------------
def block_tokens(cfg: ModelConfig) -> int:
    """PagedAttention block size per variant (paper: 512 MLA / 128 GQA-MQA /
    64 MHA) — chosen so a block is a few hundred KB in every variant.
    ``cfg.kv_block_tokens`` overrides the variant default (trace replay
    shrinks blocks so reduced models see trace-scale reuse granularity)."""
    if cfg.kv_block_tokens > 0:
        return cfg.kv_block_tokens
    v = cfg.attention_variant
    if v == MLA:
        return 512
    if v in (GQA, MQA):
        return 128
    if v == MHA:
        return 64
    return 128                        # recurrent: logical block for dedup


def block_bytes(cfg: ModelConfig) -> float:
    """Bytes of one full-model KV block (all layers)."""
    return cfg.n_layers * per_token_layer_bytes(cfg) * block_tokens(cfg)


@dataclass(frozen=True)
class SizingReport:
    model: str
    variant: str
    per_token_layer: float
    mha_equivalent: float
    compression: float
    seq_bytes_4k: float
    max_batch_arch_aware: int
    max_batch_status_quo: int


def sizing_report(cfg: ModelConfig, *, budget_bytes: float = 30e9,
                  n_max: int = 4096, tp: int = 8) -> SizingReport:
    """One-stop report reproducing the paper's Tables I and III."""
    btl = per_token_layer_bytes(cfg)
    mha = mha_equivalent_bytes(cfg)          # unsharded (Table I)
    return SizingReport(
        model=cfg.name,
        variant=cfg.attention_variant,
        per_token_layer=btl,
        mha_equivalent=mha,
        compression=mha / btl if btl else float("inf"),
        seq_bytes_4k=seq_bytes(cfg, n_max),
        max_batch_arch_aware=max_batch(cfg, budget_bytes, n_max),
        max_batch_status_quo=status_quo_max_batch(cfg, budget_bytes, n_max, tp=tp),
    )
