"""whisper-tiny [audio] — enc-dec; conv frontend is a STUB (input_specs()
provides precomputed frame embeddings). [arXiv:2212.04356; unverified]"""
from repro_torch.config import ModelConfig, FAMILY_ENCDEC

CONFIG = ModelConfig(
    name="whisper-tiny", family=FAMILY_ENCDEC,
    n_layers=4, d_model=384, n_heads=6, n_kv_heads=6, head_dim=64,
    d_ff=1536, vocab_size=51865, rope_theta=0.0,   # whisper: learned/sinusoidal pos
    n_enc_layers=4, enc_len=1500, tie_embeddings=True,
)
