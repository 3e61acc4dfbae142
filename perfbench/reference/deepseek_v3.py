"""DeepSeek-V3 (``first_k_dense_replace`` >= layers): MLA in the absorbed
form (query [hidden, H x (hd + dr)]; latent c_kv = x W_dkv, k_rope =
RoPE(x W_kr); scores q_nope W_uk . c_kv + q_rope . k_rope at
1/sqrt(hd + dr); context c_kv W_uv, then W_o) and the SwiGLU FFN."""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from reference import forward


class Reference(forward.Reference):
    def __init__(self, config: Dict, params: Dict, prec: str = "fp32"):
        if config["first_k_dense_replace"] < config["num_hidden_layers"]:
            raise ValueError("the reference has no DeepSeek routing: "
                             "every layer must be dense")
        super().__init__(config, params, prec)

    def attn(self, a: Dict, h: torch.Tensor, pos: torch.Tensor):
        P = self.prec
        c = self.c
        H, hd = c["num_attention_heads"], c["qk_nope_head_dim"]
        dr = c["qk_rope_head_dim"]
        S = h.shape[0]
        wq = a["wq"].reshape(h.shape[1], -1)
        q = P.mm(h, wq).view(S, H, hd + dr)
        q_nope = q[..., :hd]
        q_rope = forward.rope(q[..., hd:], pos, self.theta)
        ckv = P.mm(h, a["w_dkv"])                      # [S, dl]
        kr = forward.rope(P.mm(h, a["w_kr"])[:, None, :], pos,
                          self.theta)[:, 0, :]          # [S, dr]
        w_uk = a["w_uk"]                                # [dl, H, hd]
        q_lat = torch.einsum("shk,lhk->shl", P.a(q_nope), w_uk)
        scale = 1.0 / math.sqrt(hd + dr)
        ckv_a, kr_a = P.a(ckv), P.a(kr)
        q_lat, q_rope = P.a(q_lat), P.a(q_rope)

        def scores(lo, hi):
            return (torch.einsum("qhl,kl->qhk", q_lat[lo:hi], ckv_a)
                    + torch.einsum("qhr,kr->qhk", q_rope[lo:hi], kr_a)) * scale

        ctx = forward.causal_softmax_blocks(
            S, H, scores,
            lambda p: torch.einsum("qhk,kl->qhl", P.a(p), ckv_a))
        o = torch.einsum("shl,lhk->shk", P.a(ctx), a["w_uv"])
        wo = a["wo"]
        return P.mm(o.reshape(S, -1), wo.reshape(-1, wo.shape[-1]))

    def ffn(self, f: Dict, h: torch.Tensor,
            capacity: Optional[int] = None) -> torch.Tensor:
        P = self.prec
        g = P.mm(h, f["w_gate"])
        u = P.mm(h, f["w_up"])
        return P.mm(torch.nn.functional.silu(g) * u, f["w_down"])
