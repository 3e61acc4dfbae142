"""phi3-medium-14b [dense] — RoPE SwiGLU GQA. [arXiv:2404.14219; unverified]"""
from repro_torch.config import ModelConfig, FAMILY_DECODER

CONFIG = ModelConfig(
    name="phi3-medium-14b", family=FAMILY_DECODER,
    n_layers=40, d_model=5120, n_heads=40, n_kv_heads=10, head_dim=128,
    d_ff=17920, vocab_size=100352, rope_theta=10_000.0,
)
