"""Granite MoE's configuration files (``model_type`` "granitemoe") as the
program runs them: GQA over a paged KV cache, a top-k MoE FFN routed
with the capacity factor the file assumes."""
from __future__ import annotations

from typing import Dict, Tuple


def model_config(c: Dict, name: str):
    """The program's ``ModelConfig`` for a configuration file."""
    from repro_torch.config import FAMILY_MOE, ModelConfig
    return ModelConfig(family=FAMILY_MOE, name=name,
                       n_layers=int(c["num_hidden_layers"]),
                       d_model=int(c["hidden_size"]),
                       n_heads=int(c["num_attention_heads"]),
                       n_kv_heads=int(c["num_key_value_heads"]),
                       vocab_size=int(c["vocab_size"]),
                       rope_theta=float(c["rope_theta"]),
                       tie_embeddings=bool(c["tie_word_embeddings"]),
                       norm_eps=float(c["rms_norm_eps"]),
                       head_dim=int(c["head_dim"]),
                       d_ff=int(c["intermediate_size"]),
                       n_experts=int(c["num_local_experts"]),
                       top_k=int(c["num_experts_per_tok"]),
                       expert_d_ff=int(c["intermediate_size"]),
                       capacity_factor=float(c["assumed"]["capacity_factor"]))


def kv_bytes_per_token(c: Dict) -> int:
    """K and V bytes of one token over every layer, bf16."""
    return (int(c["num_hidden_layers"]) * 2 * int(c["num_key_value_heads"])
            * int(c["head_dim"]) * 2)


def active_flops(params: Dict, c: Dict) -> Tuple[float, float]:
    """(2 x the parameters one token runs through outside the embedding
    and the head, 2 x hidden x vocab): the experts' leaves count top-k of
    E, the router whole."""
    frac = c["num_experts_per_tok"] / c["num_local_experts"]
    per_tok = 0.0

    def walk(t, path):
        nonlocal per_tok
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, path + (k,))
            return
        n = t.numel()
        if path[-2:-1] == ("ffn",) and path[-1] != "router":
            n *= frac
        per_tok += n
    walk(params["layers"], ())
    return 2.0 * per_tok, 2.0 * c["hidden_size"] * c["vocab_size"]
