"""granite-moe-3b-a800m [moe] — 40 experts top-8.
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]"""
from repro_torch.config import ModelConfig, FAMILY_MOE

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m", family=FAMILY_MOE,
    n_layers=32, d_model=1536, n_heads=24, n_kv_heads=8, head_dim=64,
    d_ff=512, vocab_size=49155, rope_theta=10_000.0,
    n_experts=40, top_k=8, expert_d_ff=512,
)
