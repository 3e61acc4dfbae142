"""The four model configurations the paper evaluates (Tables I, III, VI).

These are sizing-engine inputs only — never compiled at full scale here.
Layer counts / head geometry from the public model cards; they reproduce the
paper's byte counts exactly (tests/test_sizing.py).
"""
from repro_torch.config import ModelConfig, FAMILY_DECODER, FAMILY_MOE

DEEPSEEK_V3 = ModelConfig(
    name="deepseek-v3", family=FAMILY_DECODER,
    n_layers=61, d_model=7168, n_heads=128, n_kv_heads=128, head_dim=128,
    d_ff=18432, vocab_size=129280,
    d_latent=512, d_rope=64,          # MLA
)

LLAMA3_70B = ModelConfig(
    name="llama-3-70b", family=FAMILY_DECODER,
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=28672, vocab_size=128256,
)

MIXTRAL_8X22B = ModelConfig(
    name="mixtral-8x22b", family=FAMILY_MOE,
    n_layers=56, d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
    d_ff=16384, vocab_size=32768, n_experts=8, top_k=2, expert_d_ff=16384,
)

QWEN2_5_72B = ModelConfig(
    name="qwen-2.5-72b", family=FAMILY_DECODER,
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=29568, vocab_size=152064, qkv_bias=True,
)

PAPER_MODELS = {m.name: m for m in
                [DEEPSEEK_V3, LLAMA3_70B, MIXTRAL_8X22B, QWEN2_5_72B]}
