"""rwkv6-1.6b [ssm] — Finch, data-dependent decay; attention-free.
[arXiv:2404.05892; unverified]"""
from repro_torch.config import ModelConfig, FAMILY_RWKV

CONFIG = ModelConfig(
    name="rwkv6-1.6b", family=FAMILY_RWKV,
    n_layers=24, d_model=2048, n_heads=32, n_kv_heads=0, head_dim=64,
    d_ff=7168, vocab_size=65536, rope_theta=0.0, tie_embeddings=False,
)
