"""Decoder-only model (GQA / MHA / MQA, dense FFN) over the paged KV pool.

The serving entry points of the JAX package's ``DecoderModel``, as
plain functions of (params, state, ...):

    decode_step_paged(params, state, tokens)          -> (logits [B,V], state)
    prefill_chunk(params, state, tokens, offset)      -> {"k", "v"} [L,1,C,Hkv,hd]
    prefill_chunk_seg(params, state, tokens, cpos)    -> {"k", "v"} [L,1,C,Hkv,hd]

Params keep the JAX package's layer-stacked layout (``layers/attn/wq``
[L,D,Hq,hd], ``wo`` [L,Hq,hd,D], ...), so a JAX ``init_params`` tree
converts leaf for leaf (``models/convert.py``); the per-layer
``lax.scan`` is a Python loop.  Attention runs in the paged kernels
(``kernels/ops.py``); the projections, FFN and logits are
``torch.matmul``, as the JAX package left them to XLA.

The decode step writes the new token's KV into the pool IN PLACE
(``index_put_``) instead of returning new pool arrays: the returned
state holds the same pool tensors.  Other families (MLA, MoE, hybrid,
RWKV, VLM, enc-dec) are not ported yet: ``build_model`` raises.
"""
from __future__ import annotations

import math
from typing import Any, Dict

import torch

from repro_torch.config import FAMILY_DECODER, MLA, ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import attention as attn
from repro_torch.models.common import (PSpec, materialize, rms_norm,
                                       stack_specs, swiglu)

Params = Any


def _ln_spec(d: int) -> PSpec:
    return PSpec((d,), ("embed",), init="ones")


def _dense_ffn_pspecs(cfg: ModelConfig) -> Dict[str, PSpec]:
    d, f = cfg.d_model, cfg.d_ff
    return {
        "w_gate": PSpec((d, f), ("embed", "mlp")),
        "w_up": PSpec((d, f), ("embed", "mlp")),
        "w_down": PSpec((f, d), ("mlp", "embed"),
                        scale=0.02 / math.sqrt(2 * max(cfg.n_layers, 1))),
    }


def layer_params(params: Params, i: int) -> Params:
    """Layer ``i``'s slice of the stacked ``[L, ...]`` tree (views)."""
    def take(tree):
        if isinstance(tree, dict):
            return {k: take(v) for k, v in tree.items()}
        return tree[i]
    return take(params["layers"])


class DecoderModel:
    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg
        self.specs = self.param_specs()

    # -- params -------------------------------------------------------------
    def _layer_specs(self) -> Dict[str, Any]:
        cfg = self.cfg
        return {"attn": attn.attn_pspecs(cfg), "ffn": _dense_ffn_pspecs(cfg),
                "ln1": _ln_spec(cfg.d_model), "ln2": _ln_spec(cfg.d_model)}

    def param_specs(self) -> Params:
        cfg = self.cfg
        out = {
            "embed": PSpec((cfg.vocab_size, cfg.d_model), ("vocab", "embed")),
            "layers": stack_specs(self._layer_specs(), cfg.n_layers),
            "ln_f": _ln_spec(cfg.d_model),
        }
        if not cfg.tie_embeddings:
            out["head"] = PSpec((cfg.d_model, cfg.vocab_size),
                                ("embed", "vocab"))
        return out

    def init_params(self, seed: int, device=None,
                    dtype: torch.dtype = torch.bfloat16) -> Params:
        gen = torch.Generator(device=device or "cpu").manual_seed(seed)
        return materialize(self.specs, gen, dtype=dtype, device=device)

    def supports_paged_decode(self) -> bool:
        return True

    # -- helpers --------------------------------------------------------------
    def _embed(self, params: Params, tokens: torch.Tensor) -> torch.Tensor:
        return params["embed"][tokens.long()]

    def _logits(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        if self.cfg.tie_embeddings:
            return torch.matmul(x, params["embed"].t())
        return torch.matmul(x, params["head"])

    def _attn_out(self, lp: Params, o: torch.Tensor) -> torch.Tensor:
        mask = attn.head_mask(self.cfg, o.dtype, o.device)
        if mask is not None:
            o = o * mask              # zero padded layout heads
        return attn.out_proj(o, lp["attn"]["wo"])

    def _ffn_residual(self, lp: Params, x: torch.Tensor) -> torch.Tensor:
        h = rms_norm(x, lp["ln2"], self.cfg.norm_eps)
        f = lp["ffn"]
        return x + swiglu(h, f["w_gate"], f["w_up"], f["w_down"])

    # -- paged decode (block-table KV pool; serving fast path) ---------------
    def decode_step_paged(self, params, state, tokens, backend=None):
        """One batched decode step over a paged KV pool.

        state: {"k_pages"/"v_pages" [L, N, page, Hkv, hd]} +
        "block_tables" [B, P] int32 + "lengths" [B] int32.  The new
        token's KV is written into each row's current page (in place);
        attention reads through the block table (table entry 0 is the
        scratch page of inactive rows).  Returns (logits [B, V], state
        with lengths + 1)."""
        cfg = self.cfg
        b = tokens.shape[0]
        x = self._embed(params, tokens)[:, None, :]
        lengths = state["lengths"]
        bt = state["block_tables"]
        k_pools, v_pools = state["k_pages"], state["v_pages"]
        page = k_pools.shape[2]
        rows = torch.arange(b, device=tokens.device)
        page_ids = bt[rows, (lengths // page).long()].long()
        offs = (lengths % page).long()
        new_len = lengths + 1
        positions = lengths[:, None]
        for i in range(cfg.n_layers):
            lp = layer_params(params, i)
            kp, vp = k_pools[i], v_pools[i]
            h = rms_norm(x, lp["ln1"], cfg.norm_eps)
            q, k_new, v_new = attn.project_qkv(lp["attn"], h, positions, cfg)
            kp[page_ids, offs] = k_new[:, 0].to(kp.dtype)
            vp[page_ids, offs] = v_new[:, 0].to(vp.dtype)
            o = ops.paged_decode(q[:, 0].contiguous(), kp, vp, bt, new_len,
                                 backend=backend)
            x = x + self._attn_out(lp, o)[:, None]
            x = self._ffn_residual(lp, x)
        x = rms_norm(x[:, 0], params["ln_f"], cfg.norm_eps)
        return self._logits(params, x), {**state, "lengths": new_len}

    # -- chunked prefill (token-budget mixed batches; serving fast path) -----
    def _prefill_layers(self, params, state, tokens, positions, attend):
        cfg = self.cfg
        x = self._embed(params, tokens)
        ks, vs = [], []
        for i in range(cfg.n_layers):
            lp = layer_params(params, i)
            h = rms_norm(x, lp["ln1"], cfg.norm_eps)
            q, k, v = attn.project_qkv(lp["attn"], h, positions, cfg)
            o = attend(q, k, v, state["k_pages"][i], state["v_pages"][i])
            x = x + self._attn_out(lp, o)
            x = self._ffn_residual(lp, x)
            ks.append(k)
            vs.append(v)
        return {"k": torch.stack(ks), "v": torch.stack(vs)}

    def prefill_chunk(self, params, state, tokens, offset, backend=None):
        """Prefill a fixed-size prompt chunk against the request's
        already-resident paged KV.

        tokens [1, C] int32 (zero-padded past the valid suffix); offset
        [1] int32 — tokens already written to this slot's pages; state:
        {"k_pages"/"v_pages"} + "block_table" [1, P] int32.  Attention
        is causal within the chunk and full over pool tokens < offset.
        Returns the chunk's per-layer KV ({"k"/"v"} [L,1,C,Hkv,hd]) for
        the caller to scatter into the pool (``PagedKVCache.write_chunk``).
        """
        c = tokens.shape[1]
        positions = offset[:, None] + torch.arange(
            c, device=tokens.device, dtype=offset.dtype)[None, :]
        bt = state["block_table"]
        return self._prefill_layers(
            params, state, tokens, positions,
            lambda q, k, v, kp, vp: ops.paged_prefill(
                q, k, v, kp, vp, bt, offset, backend=backend))

    def prefill_chunk_seg(self, params, state, tokens, chunk_positions,
                          backend=None):
        """Segment-prefill a chunk of prompt gap tokens at ascending
        absolute positions (``chunk_positions`` [1, C] int32; negative =
        padding, RoPE at position 0).  Same contract as
        ``prefill_chunk``; attention runs through the segment kernel."""
        positions = chunk_positions.clamp_min(0)
        bt = state["block_table"]
        return self._prefill_layers(
            params, state, tokens, positions,
            lambda q, k, v, kp, vp: ops.paged_prefill_seg(
                q, k, v, kp, vp, bt, chunk_positions, backend=backend))


def build_model(cfg: ModelConfig) -> DecoderModel:
    """The dense GQA/MHA/MQA decoder; other families are not ported."""
    if (cfg.family != FAMILY_DECODER or cfg.attention_variant == MLA
            or cfg.n_experts > 0):
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} / variant "
            f"{cfg.attention_variant!r} is not ported to PyTorch yet "
            f"(dense GQA/MHA/MQA decoders only)")
    return DecoderModel(cfg)
