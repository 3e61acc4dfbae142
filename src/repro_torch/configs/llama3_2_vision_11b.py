"""llama-3.2-vision-11b [vlm] — cross-attn image layers every 5th layer.
Vision frontend is a STUB: input_specs() provides precomputed patch
embeddings. [hf:meta-llama/Llama-3.2-11B-Vision; unverified]"""
from repro_torch.config import ModelConfig, FAMILY_VLM

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b", family=FAMILY_VLM,
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab_size=128256, rope_theta=500_000.0,
    cross_attn_every=5, n_patches=1601,
)
