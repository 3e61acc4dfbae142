"""DeepSeek-V3's configuration files (``model_type`` "deepseek_v3") as
the program runs them: absorbed MLA over a latent cache, every layer
the dense SwiGLU FFN (the port has no DeepSeek routing)."""
from __future__ import annotations

from typing import Dict, Tuple


def model_config(c: Dict, name: str):
    """The program's ``ModelConfig`` for a configuration file."""
    from repro_torch.config import FAMILY_DECODER, ModelConfig
    if int(c["first_k_dense_replace"]) < int(c["num_hidden_layers"]):
        raise ValueError("the port runs no DeepSeek routing: every layer "
                         "must be dense")
    if c["qk_nope_head_dim"] != c["v_head_dim"]:
        raise ValueError("the port's MLA needs qk_nope == v head dim")
    return ModelConfig(family=FAMILY_DECODER, name=name,
                       n_layers=int(c["num_hidden_layers"]),
                       d_model=int(c["hidden_size"]),
                       n_heads=int(c["num_attention_heads"]),
                       n_kv_heads=int(c["num_key_value_heads"]),
                       vocab_size=int(c["vocab_size"]),
                       rope_theta=float(c["rope_theta"]),
                       tie_embeddings=bool(c["tie_word_embeddings"]),
                       norm_eps=float(c["rms_norm_eps"]),
                       head_dim=int(c["qk_nope_head_dim"]),
                       d_ff=int(c["intermediate_size"]),
                       d_latent=int(c["kv_lora_rank"]),
                       d_rope=int(c["qk_rope_head_dim"]))


def kv_bytes_per_token(c: Dict) -> int:
    """Latent cache bytes of one token over every layer, bf16."""
    return (int(c["num_hidden_layers"])
            * (int(c["kv_lora_rank"]) + int(c["qk_rope_head_dim"])) * 2)


def active_flops(params: Dict, c: Dict) -> Tuple[float, float]:
    """(2 x the layers' parameters, 2 x hidden x vocab): every
    parameter of a dense layer runs for every token."""
    per_tok = 0.0

    def walk(t):
        nonlocal per_tok
        if isinstance(t, dict):
            for v in t.values():
                walk(v)
            return
        per_tok += t.numel()
    walk(params["layers"])
    return 2.0 * per_tok, 2.0 * c["hidden_size"] * c["vocab_size"]
