"""Attention parameters and projections: the MHA / GQA / MQA family and
MLA (latent attention).

The attention itself runs in the paged kernels (``kernels/ops.py``);
this module declares the weights, projects q/k/v (or, for MLA, the
query heads and the cached latent ``[c_kv ; k_rope]``) with RoPE, and
masks padded layout heads.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from repro_torch.config import ModelConfig
from repro_torch.models.common import PSpec, apply_rope


def head_mask(cfg: ModelConfig, dtype=torch.bfloat16,
              device=None) -> Optional[torch.Tensor]:
    """[layout_q_heads, 1] multiplicative mask zeroing padded heads.
    Layout: per GQA group, real heads first, pads last — preserves the
    q->kv mapping i // layout_q_group."""
    hp = cfg.layout_q_heads
    if hp == cfg.n_heads:
        return None
    g, gp = cfg.q_group, cfg.layout_q_group
    idx = torch.arange(hp, device=device)
    return ((idx % gp) < g).to(dtype)[:, None]


def attn_pspecs(cfg: ModelConfig) -> Dict[str, PSpec]:
    d, hq, hkv, hd = (cfg.d_model, cfg.layout_q_heads,
                      max(cfg.n_kv_heads, 1), cfg.hd)
    scale = 0.02
    out = {
        "wq": PSpec((d, hq, hd), ("embed", "heads", None), scale=scale),
        "wk": PSpec((d, hkv, hd), ("embed", "kv_heads", None), scale=scale),
        "wv": PSpec((d, hkv, hd), ("embed", "kv_heads", None), scale=scale),
        "wo": PSpec((hq, hd, d), ("heads", None, "embed"),
                    scale=scale / math.sqrt(2 * max(cfg.n_layers, 1))),
    }
    if cfg.qkv_bias:
        out.update(
            bq=PSpec((hq, hd), ("heads", None), init="zeros"),
            bk=PSpec((hkv, hd), ("kv_heads", None), init="zeros"),
            bv=PSpec((hkv, hd), ("kv_heads", None), init="zeros"))
    return out


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhk->bshk") as one matmul."""
    d, h, k = w.shape
    return torch.matmul(x, w.reshape(d, h * k)).unflatten(-1, (h, k))


def project_qkv(p: Dict, x: torch.Tensor, positions: torch.Tensor,
                cfg: ModelConfig, *, rope: bool = True):
    """x [B,S,D] -> q [B,S,Hq,hd], k/v [B,S,Hkv,hd] (RoPE applied)."""
    q, k, v = _proj(x, p["wq"]), _proj(x, p["wk"]), _proj(x, p["wv"])
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    if rope and cfg.rope_theta > 0:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v.contiguous()


def out_proj(o: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """einsum("...hk,hkd->...d") as one matmul."""
    h, k, d = wo.shape
    return torch.matmul(o.flatten(-2), wo.reshape(h * k, d))


# ---------------------------------------------------------------------------
# MLA: the cache holds only [c_kv ; k_rope], (d_latent + d_rope) per token
# ---------------------------------------------------------------------------
def mla_pspecs(cfg: ModelConfig) -> Dict[str, PSpec]:
    d, hq, hd = cfg.d_model, cfg.n_heads, cfg.hd
    dl, dr = cfg.d_latent, cfg.d_rope
    return {
        "wq": PSpec((d, hq, hd + dr), ("embed", "heads", None)),
        "w_dkv": PSpec((d, dl), ("embed", "latent")),
        "w_kr": PSpec((d, dr), ("embed", None)),
        "w_uk": PSpec((dl, hq, hd), ("latent", "heads", None)),
        "w_uv": PSpec((dl, hq, hd), ("latent", "heads", None)),
        "wo": PSpec((hq, hd, d), ("heads", None, "embed"),
                    scale=0.02 / math.sqrt(2 * max(cfg.n_layers, 1))),
    }


def mla_project(p: Dict, x: torch.Tensor, positions: torch.Tensor,
                cfg: ModelConfig):
    """x [B,S,D] -> q_nope [B,S,H,hd], q_rope [B,S,H,dr] (RoPE applied)
    and the cached latent [B,S,dl+dr] = [c_kv ; RoPE(k_rope)]."""
    dr = cfg.d_rope
    q = _proj(x, p["wq"])
    q_nope, q_rope = q[..., :-dr], q[..., -dr:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    c_kv = torch.matmul(x, p["w_dkv"])
    k_rope = torch.matmul(x, p["w_kr"])
    k_rope = apply_rope(k_rope[:, :, None, :], positions,
                        cfg.rope_theta)[:, :, 0, :]
    return q_nope, q_rope, torch.cat([c_kv, k_rope], dim=-1)
