"""zamba2-1.2b [hybrid] — Mamba2 backbone + shared attention block.
[arXiv:2411.15242; hf]"""
from repro_torch.config import ModelConfig, FAMILY_HYBRID

CONFIG = ModelConfig(
    name="zamba2-1.2b", family=FAMILY_HYBRID,
    n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32, head_dim=64,
    d_ff=8192, vocab_size=32000, rope_theta=10_000.0,
    ssm_state=64, ssm_expand=2, ssm_conv=4, ssm_head_dim=64, attn_every=6,
)
