"""Granite MoE: GQA with RoPE at 1/sqrt(hd) and the top-k MoE FFN: a
float32 softmax over the router's logits, the top k renormalised, each
kept expert's SwiGLU weighted by its probability.  With ``capacity``
the assignments take each expert's capacity in the port's order (every
token's first choice before any token's second, tokens in order) over
the batch given, and a later one is dropped."""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from reference import forward


class Reference(forward.Reference):
    def attn(self, a: Dict, h: torch.Tensor, pos: torch.Tensor):
        P = self.prec
        c = self.c
        H, Hkv, hd = (c["num_attention_heads"], c["num_key_value_heads"],
                      c["head_dim"])
        S, D = h.shape
        q = P.mm(h, a["wq"].reshape(D, -1)).view(S, H, hd)
        k = P.mm(h, a["wk"].reshape(D, -1)).view(S, Hkv, hd)
        v = P.mm(h, a["wv"].reshape(D, -1)).view(S, Hkv, hd)
        q = forward.rope(q, pos, self.theta)
        k = forward.rope(k, pos, self.theta)
        g = H // Hkv
        k = P.a(k.repeat_interleave(g, dim=1))
        v = P.a(v.repeat_interleave(g, dim=1))
        q = P.a(q) / math.sqrt(hd)
        o = forward.causal_softmax_blocks(
            S, H, lambda lo, hi: torch.einsum("qhd,khd->qhk", q[lo:hi], k),
            lambda p: torch.einsum("qhk,khd->qhd", P.a(p), v))
        wo = a["wo"]
        return P.mm(o.reshape(S, -1), wo.reshape(-1, D))

    def ffn(self, f: Dict, h: torch.Tensor,
            capacity: Optional[int] = None) -> torch.Tensor:
        """h [T, D] -> [T, D]: top-k experts a token; with ``capacity``
        the kept set of the port's sequential slot order over these T
        tokens."""
        P = self.prec
        c = self.c
        E, k = c["num_local_experts"], c["num_experts_per_tok"]
        T = h.shape[0]
        probs = torch.softmax(P.mm(h, f["router"]), dim=-1)
        top_p, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
        top_p, top_i = top_p[:, :k], top_i[:, :k]
        top_p = top_p / top_p.sum(dim=-1, keepdim=True)
        keep = torch.ones_like(top_p, dtype=torch.bool)
        if capacity is not None:
            taken = [0] * E
            ti = top_i.tolist()
            for j in range(k):
                for t in range(T):
                    e = ti[t][j]
                    if taken[e] >= capacity:
                        keep[t, j] = False
                    else:
                        taken[e] += 1
        out = torch.zeros_like(h)
        for e in range(E):
            sel = (top_i == e) & keep
            rows = sel.any(dim=1).nonzero()[:, 0]
            if rows.numel() == 0:
                continue
            x = h[rows]
            y = P.mm(torch.nn.functional.silu(P.mm(x, f["w_gate"][e]))
                     * P.mm(x, f["w_up"][e]), f["w_down"][e])
            w = (top_p[rows] * sel[rows]).sum(dim=1, keepdim=True)
            out.index_add_(0, rows, w * y)
        return out
