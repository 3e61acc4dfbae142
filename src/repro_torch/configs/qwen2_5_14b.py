"""qwen2.5-14b [dense] — GQA, QKV bias. [hf:Qwen/Qwen2.5-0.5B; hf]"""
from repro_torch.config import ModelConfig, FAMILY_DECODER

CONFIG = ModelConfig(
    name="qwen2.5-14b", family=FAMILY_DECODER,
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, head_dim=128,
    d_ff=13824, vocab_size=152064, rope_theta=1_000_000.0, qkv_bias=True,
)
