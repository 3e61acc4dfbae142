"""granite-moe-1b-a400m [moe] — 32 experts top-8.
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]"""
from repro_torch.config import ModelConfig, FAMILY_MOE

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m", family=FAMILY_MOE,
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=8, head_dim=64,
    d_ff=512, vocab_size=49155, rope_theta=10_000.0,
    n_experts=32, top_k=8, expert_d_ff=512,
)
