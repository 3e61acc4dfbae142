"""Unified configuration system for the serving/training framework.

A ``ModelConfig`` fully describes one architecture (attention variant, MoE,
SSM, hybrid, enc-dec, VLM).  A ``ShapeConfig`` describes one workload cell
(train / prefill / decode) with its sequence length and global batch.  The
cross product (arch x shape) defines the dry-run grid.

Everything downstream — the sizing engine (``core/sizing.py``), the model
builder (``models/model.py``), the sharding rules (``distributed/
sharding.py``) and the launcher — consumes these dataclasses.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field, replace
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# Attention variants (paper §II-B / eq. (3))
# ---------------------------------------------------------------------------
MHA = "mha"
GQA = "gqa"
MQA = "mqa"
MLA = "mla"

# Model families (drives the block layout inside models/)
FAMILY_DECODER = "decoder"   # dense decoder-only transformer
FAMILY_MOE = "moe"           # decoder-only with MoE FFN
FAMILY_HYBRID = "hybrid"     # Mamba2 blocks + shared attention (Zamba2)
FAMILY_RWKV = "rwkv"         # RWKV6 "Finch" — attention-free
FAMILY_ENCDEC = "encdec"     # Whisper-style encoder-decoder
FAMILY_VLM = "vlm"           # text decoder + cross-attention image layers


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                 # 0 -> d_model // n_heads
    qkv_bias: bool = False            # Qwen-2.5 uses bias on QKV
    rope_theta: float = 10_000.0
    tie_embeddings: bool = True
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"

    # --- MLA (DeepSeek-style latent attention) --------------------------
    d_latent: int = 0
    d_rope: int = 0
    # --- MoE -------------------------------------------------------------
    n_experts: int = 0
    top_k: int = 0
    expert_d_ff: int = 0              # per-expert hidden dim (granite: 512)
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    # --- SSM / Mamba2 (zamba2) -------------------------------------------
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_head_dim: int = 64
    attn_every: int = 0               # hybrid: shared attn block every k SSM layers
    # --- enc-dec (whisper) -------------------------------------------------
    n_enc_layers: int = 0
    enc_len: int = 0                  # precomputed frame embeddings (frontend stub)
    # --- VLM (llama3.2-vision) ---------------------------------------------
    cross_attn_every: int = 0         # cross-attn block before every k-th layer
    n_patches: int = 0                # precomputed patch embeddings (frontend stub)
    # --- internal layout (perf only; never changes model semantics) --------
    internal_pad_q_heads: int = 0     # pad q heads per GQA group so the
                                      # head dim divides TP; padded heads
                                      # are hard-masked to zero output
    internal_pad_experts: int = 0     # pad expert count to divide TP for
                                      # expert parallelism; padded experts
                                      # get -inf router logits
    # --- cache-block granularity override ---------------------------------
    kv_block_tokens: int = 0          # 0 -> variant default (sizing.block_tokens);
                                      # reduced replay configs shrink it so the
                                      # live engine sees trace-scale blocks

    # ------------------------------------------------------------------
    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def attention_variant(self) -> str:
        """Paper §III-A: infer variant from the model configuration.

        "if a latent dimension is specified, MLA is selected; otherwise the
        ratio h_q/h_kv distinguishes MHA, MQA and GQA."
        """
        if self.d_latent > 0:
            return MLA
        if self.family == FAMILY_RWKV:
            return "none"            # attention-free
        if self.n_kv_heads == self.n_heads:
            return MHA
        if self.n_kv_heads == 1:
            return MQA
        return GQA

    @property
    def q_group(self) -> int:
        return max(1, self.n_heads // max(1, self.n_kv_heads))

    @property
    def layout_q_heads(self) -> int:
        """Q-head count in the parameter layout (>= n_heads)."""
        return self.internal_pad_q_heads or self.n_heads

    @property
    def layout_q_group(self) -> int:
        return max(1, self.layout_q_heads // max(1, self.n_kv_heads))

    @property
    def layout_n_experts(self) -> int:
        return self.internal_pad_experts or self.n_experts

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def moe_ff(self) -> int:
        return self.expert_d_ff or self.d_ff

    def attn_layer_ids(self) -> Tuple[int, ...]:
        """For hybrid models: indices of SSM layers after which the shared
        attention block runs.  Zamba2 interleaves a shared attention block
        every ``attn_every`` Mamba2 layers."""
        if self.family != FAMILY_HYBRID or self.attn_every <= 0:
            return ()
        return tuple(range(self.attn_every - 1, self.n_layers, self.attn_every))

    def cross_attn_layer_ids(self) -> Tuple[int, ...]:
        if self.family != FAMILY_VLM or self.cross_attn_every <= 0:
            return ()
        return tuple(range(self.cross_attn_every - 1, self.n_layers,
                           self.cross_attn_every))

    # ------------------------------------------------------------------
    def param_count(self) -> int:
        """Analytic parameter count (used for MODEL_FLOPS = 6*N*D)."""
        d, hd = self.d_model, self.hd
        n_q, n_kv = self.n_heads, self.n_kv_heads
        emb = self.vocab_size * d
        out_head = 0 if self.tie_embeddings else self.vocab_size * d

        def attn_params() -> int:
            if self.attention_variant == MLA:
                # q/kv down+up projections + rope parts + output
                q = d * (self.d_latent + n_q * (hd + self.d_rope))
                kv = d * (self.d_latent + self.d_rope) + \
                    self.d_latent * n_q * 2 * hd
                o = n_q * hd * d
                return q + kv + o
            return d * (n_q * hd) + 2 * d * (n_kv * hd) + n_q * hd * d

        def ffn_params() -> int:
            if self.n_experts > 0:
                return (self.n_experts * 3 * d * self.moe_ff) + d * self.n_experts
            return 3 * d * self.d_ff

        def ssm_params() -> int:
            di = self.d_inner
            n_h = self.n_ssm_heads
            g_n = 2 * self.ssm_state
            in_p = d * (2 * di + g_n + n_h)
            conv = (di + g_n) * self.ssm_conv
            out_p = di * d
            return in_p + conv + out_p + 3 * n_h

        def rwkv_params() -> int:
            # time-mix (r,k,v,w,g + output) + channel-mix
            tm = 5 * d * d + d * d + 2 * (d * 32 + 32 * d)  # lora-ish extras
            cm = d * self.d_ff + self.d_ff * d
            return tm + cm

        per_layer = 0
        total = emb + out_head
        if self.family in (FAMILY_DECODER, FAMILY_MOE, FAMILY_VLM):
            per_layer = attn_params() + ffn_params() + 2 * d
            total += self.n_layers * per_layer
            if self.family == FAMILY_VLM:
                total += len(self.cross_attn_layer_ids()) * (attn_params() + 2 * d)
        elif self.family == FAMILY_HYBRID:
            total += self.n_layers * (ssm_params() + 2 * d)
            total += attn_params() + 3 * d * self.d_ff + 4 * d  # one shared block
        elif self.family == FAMILY_RWKV:
            total += self.n_layers * (rwkv_params() + 4 * d)
        elif self.family == FAMILY_ENCDEC:
            enc = self.n_enc_layers * (attn_params() + 3 * d * self.d_ff + 4 * d)
            dec = self.n_layers * (2 * attn_params() + 3 * d * self.d_ff + 6 * d)
            total += enc + dec
        return total

    def active_param_count(self) -> int:
        """Active params per token (MoE: only top-k experts count)."""
        if self.n_experts == 0:
            return self.param_count()
        dense_expert = 3 * self.d_model * self.moe_ff
        inactive = self.n_layers * (self.n_experts - self.top_k) * dense_expert
        return self.param_count() - inactive


# ---------------------------------------------------------------------------
# Workload shapes
# ---------------------------------------------------------------------------
KIND_TRAIN = "train"
KIND_PREFILL = "prefill"
KIND_DECODE = "decode"


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str
    seq_len: int
    global_batch: int
    # decode shapes: seq_len is the KV-cache length; one new token is decoded

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


SHAPES = {
    "train_4k": ShapeConfig("train_4k", KIND_TRAIN, 4_096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", KIND_PREFILL, 32_768, 32),
    "decode_32k": ShapeConfig("decode_32k", KIND_DECODE, 32_768, 128),
    "long_500k": ShapeConfig("long_500k", KIND_DECODE, 524_288, 1),
}

# Families with sub-quadratic sequence mixing: the only ones that run the
# 500k-token cell (full-attention archs skip it; see DESIGN.md).
SUBQUADRATIC_FAMILIES = (FAMILY_HYBRID, FAMILY_RWKV)


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Whether an (arch x shape) cell is well-defined (DESIGN.md §Skips)."""
    if shape.name == "long_500k" and cfg.family not in SUBQUADRATIC_FAMILIES:
        return False, ("pure full-attention architecture: 500k-token decode "
                       "requires sub-quadratic sequence mixing")
    return True, ""


# ---------------------------------------------------------------------------
# Reduced configs for CPU smoke tests
# ---------------------------------------------------------------------------
def reduce_config(cfg: ModelConfig) -> ModelConfig:
    """Tiny same-family variant: runs a real fwd/train step on CPU."""
    kw = dict(
        name=cfg.name + "-smoke",
        n_layers=min(cfg.n_layers, 2),
        d_model=64,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads < cfg.n_heads else 4,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
    )
    if cfg.family == FAMILY_RWKV:
        kw["n_kv_heads"] = 0
        kw["head_dim"] = 16
    if cfg.d_latent:
        kw.update(d_latent=32, d_rope=8)
    if cfg.n_experts:
        kw.update(n_experts=4, top_k=2, expert_d_ff=32)
    if cfg.ssm_state:
        kw.update(ssm_state=16, ssm_head_dim=16, attn_every=max(cfg.attn_every, 0) and 2)
        kw["n_layers"] = 4
    if cfg.n_enc_layers:
        kw.update(n_enc_layers=2, enc_len=16)
    if cfg.cross_attn_every:
        kw.update(cross_attn_every=2, n_patches=8)
        kw["n_layers"] = 4
    return replace(cfg, **kw)


def reduce_shape(shape: ShapeConfig) -> ShapeConfig:
    return ShapeConfig(shape.name + "-smoke", shape.kind,
                       seq_len=min(shape.seq_len, 64),
                       global_batch=min(shape.global_batch, 2))


def padded_head_layout(cfg: ModelConfig, tp: int,
                       max_overhead: float = 1.35) -> int:
    """Smallest per-GQA-group-padded q-head count divisible by `tp`
    (0 if none exists within the flop-overhead budget).  Padding q heads
    group-wise preserves the q->kv mapping under repeat-expansion while
    letting attention weights/activations shard evenly over TP."""
    hq, hkv = cfg.n_heads, max(1, cfg.n_kv_heads)
    if hq % tp == 0 or cfg.attention_variant in ("mla", "none"):
        return 0
    g = hq // hkv
    g_pad = g
    while (hkv * g_pad) % tp != 0:
        g_pad += 1
        if hkv * g_pad > hq * max_overhead:
            return 0
    return hkv * g_pad
