"""Decoder-only model (GQA / MHA / MQA or MLA attention, dense or MoE
FFN) over the paged KV pool or the dense slot cache; the two
cross-attention families on the dense slot cache: the VLM
(``VLMModel``, llama-3.2-vision) and the Whisper-style encoder-decoder
(``EncDecModel``); and the two recurrent families on a dense per-row
state: the Mamba2 hybrid (``HybridModel``, zamba2) and RWKV6
(``RWKVModel``).

The serving entry points of the JAX package's ``DecoderModel``, as
plain functions of (params, state, ...).  Over the paged pool:

    decode_step_paged(params, state, tokens)          -> (logits [B,V], state)
    prefill_chunk(params, state, tokens, offset)      -> {"k", "v"} [L,1,C,Hkv,hd]
    prefill_chunk_seg(params, state, tokens, cpos)    -> {"k", "v"} [L,1,C,Hkv,hd]

Over the dense slot layout (``init_decode_state``: "k"/"v"
[L,B,S,Hkv,hd] plus "lengths" [B]; with ``kv_dtype="int8"`` int8 values
and bf16 scales "k_scale"/"v_scale" [L,B,S,Hkv,1]; MLA "latent"
[L,B,S,dl+dr]), for the monolithic A/B paths of the engine:

    prefill(params, {"tokens"})                       -> (logits [B,V], state)
    prefill_suffix(params, {"tokens"}, prefix_kv, q_offset)
                                                      -> (logits, (k, v) [L,B,S,Hkv,hd]
                                                          or MLA (latent,))
    decode_step(params, state, tokens)                -> (logits [B,V], state)

``prefill`` runs the flash prefill kernel (``attention.causal_attention``
from position 0); ``decode_step`` the paged decode kernels over the
slot cache seen as pages (``attention.decode_attention``), int8 caches
through the int8 kernel.  An MLA model's ``prefill`` runs the MLA chunk
prefill kernel over the whole prompt at offset 0, its ``decode_step``
the MLA decode kernel over the latent slots seen as pages, and its
``prefill_suffix`` plain attention in the non-absorbed form, as the
JAX package does (``attention.mla_attention_*``).

MLA models (DeepSeek-style latent attention) keep one pool
``latent_pages`` [L,N,page,dl+dr] instead of ``k_pages``/``v_pages`` and
return ``{"latent"}`` [L,1,C,dl+dr] from the chunk prefill entry points.
They run in the absorbed form: ``W_uk`` is folded into the query, the
MLA kernels attend in latent space and return a [.., Hq, dl] context,
and ``W_uv`` plus the output projection follow, with the engine's
softmax scale ``1/sqrt(hd + dr)``.

With ``n_experts > 0`` every entry point's FFN is the MoE FFN
(``models/moe.py``), whose capacity-bounded routing makes one token's
output depend on the other tokens of its batch; the engine feeds
padding and inactive rows token 0, as the JAX engine does.

Params keep the JAX package's layer-stacked layout (``layers/attn/wq``
[L,D,Hq,hd], ``wo`` [L,Hq,hd,D], ...), so a JAX ``init_params`` tree
converts leaf for leaf (``models/convert.py``); the per-layer
``lax.scan`` is a Python loop.  Attention runs in the kernels
(``kernels/ops.py``); the projections, FFN (the MoE experts too) and
logits are ``torch.matmul`` / ``torch.bmm``, as the JAX package left
them to XLA.

The decode steps write the new token's KV into the pool or the slot
cache IN PLACE instead of returning new arrays: the returned state
holds the same cache tensors.

Every family has ``train_loss(params, batch) -> (loss, metrics)``, the
JAX package's: the logits of every position, its cross-entropy with
z-loss (plus the MoE aux term), each layer under ``remat``
(non-reentrant ``torch.utils.checkpoint``, the counterpart of
``jax.checkpoint``; the VLM's cross groups too) and causal
self-attention through ``FlashCausal`` (the flash prefill kernel with
its log-sum-exp, then its backward kernel).  MLA trains in the
non-absorbed form, as the JAX package does
(``attention.mla_attention_train``: per-head keys [c_kv W_uk ; k_rope]
at hd + dr over values c_kv W_uv at hd, through the same kernels), with
a dense or an MoE FFN; its serving paths keep the latent kernels.  The
params are plain leaves that require grad; the decode paths' in-place
writes stay off this path.

The cross-attention families have the dense layout's ``prefill`` and
``decode_step`` only (no paged or chunked entry point, as in the JAX
package, whose engine serves neither).  Their image patches or audio
frames are precomputed embeddings (``batch["patches"]`` [B,P,D],
``batch["frames"]`` [B,enc_len,D]): the frontends are stubs in the JAX
package too.  The state gains the memory's keys and values, "xk"/"xv"
[n_cross or L, B, P or enc_len, Hkv, hd]; cross-attention
(``attention.full_attention``) is plain PyTorch, self-attention runs
the flash prefill and paged decode kernels.

The hybrid and RWKV families likewise have ``prefill`` and
``decode_step`` only.  Their state is a tree (``init_decode_state``
maps the spec tree): the hybrid's "mamba" {ssm, conv_x, conv_B, conv_C}
[L,B,...] beside its shared block's "k"/"v" [n_apps,B,S,Hkv,hd]; RWKV's
"wkv" [L,B,H,hd,hd] and "tm_x"/"cm_x" [L,B,D].  A decode step
overwrites the recurrent state in place, as it does the K/V slots.  The
Mamba2 and WKV mixers are plain PyTorch (``models/ssm.py``,
``models/rwkv.py``), as the JAX package keeps them in ``jnp``; the
hybrid's shared attention runs the flash prefill and paged decode
kernels.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.config import (FAMILY_DECODER, FAMILY_ENCDEC,
                                FAMILY_HYBRID, FAMILY_MOE, FAMILY_RWKV,
                                FAMILY_VLM, KIND_DECODE, KIND_PREFILL,
                                KIND_TRAIN, MLA, ModelConfig, ShapeConfig)
from repro_torch.kernels import ops
from repro_torch.models import attention as attn
from repro_torch.models import moe, rwkv, ssm
from repro_torch.models.common import (NOSHARD, PSpec, cross_entropy,
                                       materialize, resolve_device,
                                       layer_norm, rms_norm,
                                       sinusoid_at, stack_specs, swiglu,
                                       tree_leaves, tree_map)

Params = Any
KV_DTYPES = ("bfloat16", "int8")


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


def layer_params(params: Params, i: int, stack: str = "layers") -> Params:
    """Layer ``i``'s slice of the stacked ``[L, ...]`` tree
    ``params[stack]`` (views: a gradient through them lands in the
    stacked leaf)."""
    def take(tree):
        if isinstance(tree, dict):
            return {k: take(v) for k, v in tree.items()}
        return tree[i]
    return take(params[stack])


def unstack(params: Params, stack: str = "layers") -> list:
    """Every layer's slice of the stacked ``[L, ...]`` tree
    ``params[stack]``, by one ``unbind`` a leaf: the gradient flows back
    through one ``stack`` instead of a zero-padded stack-sized gradient
    for every ``layer_params`` index (the training paths)."""
    parts = tree_map(lambda t: t.unbind(0), params[stack])
    n = len(tree_leaves(parts)[0])
    return [tree_map(lambda u: u[i], parts) for i in range(n)]


def remat(fn, *args):
    """``fn(*args)`` whose activations are recomputed in the backward
    pass instead of kept: ``jax.checkpoint``'s counterpart."""
    return checkpoint(fn, *args, use_reentrant=False)


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _abstract(specs: Params) -> Params:
    """A spec tree's leaves as meta tensors (bf16 unless a spec names its
    dtype): the counterpart of ``jax.ShapeDtypeStruct`` trees."""
    return tree_map(lambda p: _meta(p.shape,
                                    getattr(torch, p.dtype or "bfloat16")),
                    specs)


class Model:
    """What every family shares: the param-spec tree and its seeded
    weights, the zeroed dense slot state, the embedding lookup and the
    logits.  Only the decoder-only family has the paged entry points."""

    def __init__(self, cfg: ModelConfig, shd=NOSHARD):
        self.cfg = cfg
        self.shd = shd                # activation sharding hook
        self.specs = self.param_specs()

    def param_specs(self) -> Params:
        raise NotImplementedError

    def decode_state_specs(self, batch: int, max_len: int) -> Params:
        raise NotImplementedError

    def supports_paged_decode(self) -> bool:
        """Whether ``decode_step_paged`` serves this model."""
        return False

    def supports_chunked_prefill(self) -> bool:
        """Whether ``prefill_chunk`` / ``prefill_chunk_seg`` serve it."""
        return self.supports_paged_decode()

    def init_params(self, seed: int, device=None,
                    dtype: torch.dtype = torch.bfloat16) -> Params:
        """Seeded weights on the CUDA card unless ``device`` names
        another (``device="cpu"``)."""
        device = resolve_device(device)
        gen = torch.Generator(device=device).manual_seed(seed)
        return materialize(self.specs, gen, dtype=dtype, device=device)

    def init_decode_state(self, batch: int, max_len: int,
                          device=None) -> Params:
        """Zeroed slot state, a tree of the spec tree's shape (bf16
        unless a spec names its dtype), on the CUDA card unless
        ``device`` names another."""
        device = resolve_device(device)
        return tree_map(
            lambda p: torch.zeros(p.shape, device=device,
                                  dtype=getattr(torch, p.dtype or "bfloat16")),
            self.decode_state_specs(batch, max_len))

    # -- dry-run stand-ins: meta tensors with the JAX shapes and dtypes ------
    def abstract_params(self) -> Params:
        return _abstract(self.specs)

    def abstract_decode_state(self, batch: int, max_len: int) -> Params:
        return _abstract(self.decode_state_specs(batch, max_len))

    def input_specs(self, shape: ShapeConfig) -> Dict[str, torch.Tensor]:
        """Meta stand-ins for every input of the shape's entry point."""
        b, s = shape.global_batch, shape.seq_len
        if shape.kind == KIND_TRAIN:
            out = {"tokens": _meta((b, s), torch.int32),
                   "labels": _meta((b, s), torch.int32)}
        elif shape.kind == KIND_PREFILL:
            out = {"tokens": _meta((b, s), torch.int32)}
        else:
            out = {"tokens": _meta((b,), torch.int32)}
        self._add_aux_specs(out, shape)
        return out

    def _add_aux_specs(self, out: Dict, shape: ShapeConfig) -> None:
        pass

    def _embed(self, params: Params, tokens: torch.Tensor) -> torch.Tensor:
        # an embedding lookup, whose backward on the card sums each row's
        # gradients in a fixed order (an indexed read's does not); against
        # a vocab-sharded table, each shard's rows summed over the shards
        return self.shd(self.shd.embed_lookup(params["embed"], tokens),
                        "batch", "seq", None)

    def _logits(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        x = self._residual(x, "seq")   # a sequence-parallel stream whole
        if self.cfg.tie_embeddings:
            lg = torch.matmul(x, params["embed"].t())
        else:
            lg = torch.matmul(x, params["head"])
        axes = (("batch", "vocab") if lg.dim() == 2
                else ("batch", "seq", "vocab"))
        return self.shd(lg, *axes)

    # -- training -------------------------------------------------------------
    def train_loss(self, params: Params, batch: Dict,
                   backend=None) -> Tuple[torch.Tensor, Dict]:
        """The next-token loss of ``batch`` ({"tokens", "labels"} [B,S],
        plus the family's "patches" / "frames") with the logits of every
        position -> (loss, {"loss", ...}).  Every layer runs under
        ``remat``; causal self-attention runs ``FlashCausal`` (the flash
        prefill kernel and its backward on the card)."""
        raise NotImplementedError

    def _loss_from_logits(self, logits, labels):
        loss = cross_entropy(logits, labels, shd=self.shd)
        return loss, {"loss": loss}

    def _residual(self, x: torch.Tensor, seq: str = "seq") -> torch.Tensor:
        """The residual stream [B,S,D] or [B,D] in its layout: rows over
        the data axes, the model dim whole.  Under a mesh this is where a
        row-parallel product's partial sums are all-reduced."""
        axes = ("batch", seq, None) if x.dim() == 3 else ("batch", None)
        return self.shd(x, *axes)

    def _kv_state(self, c: torch.Tensor) -> torch.Tensor:
        """A stacked cache [L,B,S,...] in the state's layout (sequence
        over ``kv_seq``)."""
        return self.shd(c, None, "batch", "kv_seq",
                        *(None,) * (c.dim() - 3))


class DecoderModel(Model):
    def __init__(self, cfg: ModelConfig, shd=NOSHARD,
                 kv_dtype: str = "bfloat16"):
        if kv_dtype not in KV_DTYPES:
            raise ValueError(f"kv_dtype {kv_dtype!r}: expected one of "
                             f"{KV_DTYPES}")
        self.kv_dtype = kv_dtype      # the dense slot cache's values
        self.mla = cfg.attention_variant == MLA
        self.mla_scale = attn.mla_scale(cfg)
        super().__init__(cfg, shd)

    # -- params -------------------------------------------------------------
    def _layer_specs(self) -> Dict[str, Any]:
        cfg = self.cfg
        a = attn.mla_pspecs(cfg) if self.mla else attn.attn_pspecs(cfg)
        ffn = (moe.moe_pspecs(cfg) if cfg.n_experts > 0
               else _dense_ffn_pspecs(cfg))
        return {"attn": a, "ffn": ffn,
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

    def supports_paged_decode(self) -> bool:
        """The JAX rule: the paged pool serves bf16 caches."""
        return self.kv_dtype != "int8"

    # -- the dense slot layout ----------------------------------------------
    def decode_state_specs(self, batch: int, max_len: int) -> Dict[str, PSpec]:
        """The JAX package's: an MLA model keeps one bf16 latent slot
        cache whatever ``kv_dtype`` says."""
        cfg = self.cfg
        L, hkv, hd = cfg.n_layers, max(cfg.n_kv_heads, 1), cfg.hd
        out = {"lengths": PSpec((batch,), ("batch",), init="zeros",
                                dtype="int32")}
        if self.mla:
            out["latent"] = PSpec((L, batch, max_len,
                                   cfg.d_latent + cfg.d_rope),
                                  ("layers", "batch", "kv_seq", None),
                                  init="zeros")
            return out
        axes = ("layers", "batch", "kv_seq", None, None)
        kv = PSpec((L, batch, max_len, hkv, hd), axes, init="zeros",
                   dtype="int8" if self.kv_dtype == "int8" else None)
        out["k"] = kv
        out["v"] = kv
        if self.kv_dtype == "int8":
            sc = PSpec((L, batch, max_len, hkv, 1), axes, init="zeros")
            out["k_scale"] = sc
            out["v_scale"] = sc
        return out

    # -- helpers --------------------------------------------------------------
    def _attn_out(self, lp: Params, o: torch.Tensor) -> torch.Tensor:
        mask = attn.head_mask(self.cfg, o.dtype, o.device)
        if mask is not None:
            o = o * mask              # zero padded layout heads
        return attn.out_proj(o, lp["attn"]["wo"])

    def _residual(self, x: torch.Tensor, seq: str = "seq_res"):
        return super()._residual(x, seq)

    def _ffn_residual(self, lp: Params, x: torch.Tensor,
                      with_aux: bool = False):
        """x + FFN(ln2(x)): the SwiGLU FFN, or the MoE FFN, whose aux
        loss is dropped (as the JAX serving paths drop it) unless
        ``with_aux``: then (x, aux), aux None for the SwiGLU FFN."""
        h = rms_norm(x, lp["ln2"], self.cfg.norm_eps)
        f = lp["ffn"]
        if self.cfg.n_experts > 0:
            y, aux = moe.moe_ffn(f, h, self.cfg, self.shd)
        else:
            y, aux = swiglu(h, f["w_gate"], f["w_up"], f["w_down"],
                            self.shd), None
        y = self.shd.grad_layout(y, "batch", "seq", None)
        return (x + y, aux) if with_aux else x + y

    # -- monolithic prefill and dense decode -----------------------------------
    def _self_block_full(self, lp, x, positions, backend=None, prefix=None,
                         q_offset: int = 0):
        """One layer over a whole prompt (or a suffix at ``q_offset``
        after the cached ``prefix`` (k, v) [B,P,Hkv,hd], MLA (latent,));
        returns (x, per-layer cache): the layer's own (k, v) or MLA
        (latent,)."""
        cfg = self.cfg
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        if self.mla:
            if prefix is None:
                o, latent = attn.mla_attention_prefill(
                    lp["attn"], h, cfg, backend=backend, shd=self.shd)
            else:
                o, latent = attn.mla_attention_suffix(lp["attn"], h,
                                                      prefix[0], q_offset,
                                                      cfg, self.shd)
            x = self._residual(x + o)
            return self._residual(self._ffn_residual(lp, x)), (latent,)
        q, k, v = attn.project_qkv(lp["attn"], h, positions, cfg,
                                   shd=self.shd)
        kf, vf = k, v
        if prefix is not None:
            kf = torch.cat([prefix[0].to(k.dtype), k], dim=1)
            vf = torch.cat([prefix[1].to(v.dtype), v], dim=1)
        o = attn.causal_attention(q, kf, vf, q_offset=q_offset,
                                  backend=backend, shd=self.shd)
        x = self._residual(x + self._attn_out(lp, o))
        return self._residual(self._ffn_residual(lp, x)), (k, v)

    def _forward_layers(self, params, tokens, positions, backend=None,
                        prefix_kv=None, q_offset: int = 0):
        """Every layer, then the final norm; returns (x, cache) with the
        per-layer caches stacked: (k, v) [L,B,S,Hkv,hd] or MLA (latent,)
        [L,B,S,dl+dr]."""
        cfg = self.cfg
        x = self._embed(params, tokens)
        per_layer = []
        for i in range(cfg.n_layers):
            prefix = (None if prefix_kv is None
                      else tuple(c[i] for c in prefix_kv))
            x, kv = self._self_block_full(layer_params(params, i), x,
                                          positions, backend, prefix,
                                          q_offset)
            per_layer.append(kv)
        x = rms_norm(x, params["ln_f"], cfg.norm_eps)
        return x, tuple(torch.stack(c) for c in zip(*per_layer))

    def _train_layer(self, lp, x, positions, backend=None):
        """One layer of the training forward (GQA, or MLA in the
        non-absorbed form) -> (x, MoE aux or None)."""
        h = rms_norm(x, lp["ln1"], self.cfg.norm_eps)
        if self.mla:
            o = attn.mla_attention_train(lp["attn"], h, positions, self.cfg,
                                         backend=backend, shd=self.shd)
        else:
            q, k, v = attn.project_qkv(lp["attn"], h, positions, self.cfg,
                                       shd=self.shd)
            o = self._attn_out(lp, attn.causal_attention(
                q, k, v, backend=backend, shd=self.shd))
        o = self.shd.grad_layout(o, "batch", "seq", None)
        x, aux = self._ffn_residual(lp, self._residual(x + o), with_aux=True)
        return self._residual(x), aux

    def _train_layers(self, params, batch, x, positions, backend):
        """Every layer under ``remat`` -> (x before the final norm, the
        per-layer MoE aux losses)."""
        auxes = []
        for lp in unstack(params):
            x, aux = remat(self._train_layer, lp, x, positions, backend)
            auxes.append(aux)
        return x, auxes

    def train_loss(self, params, batch, backend=None):
        """The JAX package's: the mean cross-entropy over every position,
        plus ``router_aux_weight`` times the layers' mean MoE aux loss
        (``metrics["aux_loss"]``).  MLA attends in the non-absorbed form
        (``attention.mla_attention_train``), as the JAX package trains
        it."""
        cfg = self.cfg
        tokens = batch["tokens"]
        positions = torch.arange(tokens.shape[1], device=tokens.device)[None]
        x, auxes = self._train_layers(params, batch,
                                      self._embed(params, tokens), positions,
                                      backend)
        x = rms_norm(x, params["ln_f"], cfg.norm_eps)
        loss, metrics = self._loss_from_logits(self._logits(params, x),
                                               batch["labels"])
        if cfg.n_experts > 0:
            aux = torch.stack(auxes).mean()
            loss = loss + cfg.router_aux_weight * aux
            metrics["aux_loss"] = aux
        metrics["loss"] = loss
        return loss, metrics

    def prefill(self, params, batch, backend=None):
        """Monolithic prefill of ``batch["tokens"]`` [B,S] from position
        0 through the flash prefill kernel (MLA: the MLA chunk prefill
        kernel at offset 0).  Returns (logits of the last position [B,V],
        {"k"/"v" [L,B,S,Hkv,hd] or "latent" [L,B,S,dl+dr], "lengths" [B]
        = S})."""
        tokens = batch["tokens"]
        b, s = tokens.shape
        positions = torch.arange(s, device=tokens.device)[None, :]
        x, cache = self._forward_layers(params, tokens, positions, backend)
        lengths = torch.full((b,), s, dtype=torch.int32,
                             device=tokens.device)
        keys = ("latent",) if self.mla else ("k", "v")
        return self._logits(params, x[:, -1]), {
            "lengths": lengths, **{key: self._kv_state(c)
                                   for key, c in zip(keys, cache)}}

    def prefill_suffix(self, params, batch, prefix_kv, q_offset: int,
                       backend=None):
        """Prefix-cache-aware prefill: the suffix ``batch["tokens"]``
        [B,S] at positions q_offset + i attends [cached prefix ; its own
        causal keys].  ``prefix_kv`` = (k, v) [L,B,q_offset,Hkv,hd] (MLA:
        (latent,) [L,B,q_offset,dl+dr]).  Returns (logits [B,V], the
        suffix's cache in the same form)."""
        tokens = batch["tokens"]
        positions = q_offset + torch.arange(tokens.shape[1],
                                            device=tokens.device)[None, :]
        x, cache = self._forward_layers(params, tokens, positions, backend,
                                        prefix_kv, q_offset)
        return self._logits(params, x[:, -1]), cache

    def _self_block_decode(self, lp, x, state, i: int, backend=None):
        """Layer ``i`` of a dense decode step on x [B,1,D]: the row's new
        K/V (int8 values and scales for an int8 cache; MLA its latent)
        is written at its length (in place), then the row attends its
        length + 1 tokens through the paged decode kernel (int8, MLA
        decode) over the slots seen as pages, then the FFN."""
        cfg = self.cfg
        lengths = state["lengths"]
        new_len = lengths + 1
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        if self.mla:
            o, _ = attn.mla_attention_decode(lp["attn"], h,
                                             state["latent"][i], new_len,
                                             cfg, backend=backend,
                                             shd=self.shd)
            x = self._residual(x + o)
            return self._residual(self._ffn_residual(lp, x))
        int8 = self.kv_dtype == "int8"
        q, k_new, v_new = attn.project_qkv(lp["attn"], h, lengths[:, None],
                                           cfg)
        k_c, v_c = state["k"][i], state["v"][i]
        scales = (state["k_scale"][i], state["v_scale"][i]) if int8 \
            else (None, None)
        for cache, sc, new in zip((k_c, v_c), scales, (k_new, v_new)):
            if int8:
                new, new_sc = attn.quantize_kv(new)
                attn.cache_write(sc, new_sc, lengths)
            attn.cache_write(cache, new, lengths)
        o = attn.decode_attention(q, k_c, v_c, new_len, *scales,
                                  backend=backend)
        x = self._residual(x + self._attn_out(lp, o))
        return self._residual(self._ffn_residual(lp, x))

    def _decode_out(self, params, x, state):
        """The final norm and logits of a decode step: (logits [B,V],
        state with lengths + 1)."""
        x = rms_norm(x[:, 0], params["ln_f"], self.cfg.norm_eps)
        return self._logits(params, x), {**state,
                                         "lengths": state["lengths"] + 1}

    def decode_step(self, params, state, tokens, backend=None):
        """One batched decode step over the dense slot cache
        (``_self_block_decode`` in every layer).  Returns (logits [B,V],
        state with lengths + 1)."""
        x = self.shd.embed_lookup(params["embed"], tokens)[:, None, :]
        for i in range(self.cfg.n_layers):
            x = self._self_block_decode(layer_params(params, i), x, state, i,
                                        backend)
        return self._decode_out(params, x, state)

    # -- paged decode (block-table KV pool; serving fast path) ---------------
    def decode_step_paged(self, params, state, tokens, backend=None):
        """One batched decode step over a paged KV pool.

        state: {"k_pages"/"v_pages" [L, N, page, Hkv, hd]} (or MLA
        {"latent_pages" [L, N, page, dl+dr]}) + "block_tables" [B, P]
        int32 + "lengths" [B] int32.  The new token's KV (or latent) is
        written into each row's current page (in place); attention reads
        through the block table (table entry 0 is the scratch page of
        inactive rows).  Returns (logits [B, V], state with lengths + 1)."""
        cfg = self.cfg
        b = tokens.shape[0]
        x = self.shd.embed_lookup(params["embed"], tokens)[:, None, :]
        lengths = state["lengths"]
        bt = state["block_tables"]
        pool0 = state["latent_pages" if self.mla else "k_pages"]
        page = pool0.shape[2]
        rows = torch.arange(b, device=tokens.device)
        page_ids = bt[rows, (lengths // page).long()].long()
        offs = (lengths % page).long()
        new_len = lengths + 1
        positions = lengths[:, None]
        for i in range(cfg.n_layers):
            lp = layer_params(params, i)
            h = rms_norm(x, lp["ln1"], cfg.norm_eps)
            if self.mla:
                latp = state["latent_pages"][i]

                def attend(q_lat, q_rope, latent, latp=latp):
                    latp[page_ids, offs] = latent[:, 0].to(latp.dtype)
                    return ops.mla_decode(
                        q_lat[:, 0], q_rope[:, 0], latp, bt, new_len,
                        d_latent=cfg.d_latent, scale=self.mla_scale,
                        backend=backend)[:, None]
                o, _ = attn.mla_absorbed(lp["attn"], h, positions, cfg,
                                         attend)
            else:
                kp, vp = state["k_pages"][i], state["v_pages"][i]
                q, k_new, v_new = attn.project_qkv(lp["attn"], h, positions,
                                                   cfg)
                kp[page_ids, offs] = k_new[:, 0].to(kp.dtype)
                vp[page_ids, offs] = v_new[:, 0].to(vp.dtype)
                o = ops.paged_decode(q[:, 0].contiguous(), kp, vp, bt,
                                     new_len, backend=backend)
                o = self._attn_out(lp, o)[:, None]
            x = x + o
            x = self._ffn_residual(lp, x)
        x = rms_norm(x[:, 0], params["ln_f"], cfg.norm_eps)
        return self._logits(params, x), {**state, "lengths": new_len}

    # -- chunked prefill (token-budget mixed batches; serving fast path) -----
    def _prefill_layers(self, params, state, tokens, positions, gqa, mla):
        """The layer loop of both prefill entry points; ``gqa(q, k, v,
        kp, vp)`` or ``mla(q_lat, q_rope, latent, latent_pages)`` runs the
        layer's attention kernel.  Returns the chunk's per-layer cache."""
        cfg = self.cfg
        x = self._embed(params, tokens)
        per_layer = []
        for i in range(cfg.n_layers):
            lp = layer_params(params, i)
            h = rms_norm(x, lp["ln1"], cfg.norm_eps)
            if self.mla:
                latp = state["latent_pages"][i]
                o, latent = attn.mla_absorbed(
                    lp["attn"], h, positions, cfg,
                    lambda ql, qr, lat, latp=latp: mla(ql, qr, lat, latp))
                per_layer.append((latent,))
            else:
                q, k, v = attn.project_qkv(lp["attn"], h, positions, cfg)
                o = self._attn_out(lp, gqa(q, k, v, state["k_pages"][i],
                                           state["v_pages"][i]))
                per_layer.append((k, v))
            x = x + o
            x = self._ffn_residual(lp, x)
        keys = ("latent",) if self.mla else ("k", "v")
        return {key: torch.stack([e[j] for e in per_layer])
                for j, key in enumerate(keys)}

    def prefill_chunk(self, params, state, tokens, offset, backend=None):
        """Prefill a fixed-size prompt chunk against the request's
        already-resident paged KV.

        tokens [1, C] int32 (zero-padded past the valid suffix); offset
        [1] int32 — tokens already written to this slot's pages; state:
        {"k_pages"/"v_pages"} (or MLA {"latent_pages"}) + "block_table"
        [1, P] int32.  Attention is causal within the chunk and full over
        pool tokens < offset.  Returns the chunk's per-layer KV ({"k"/"v"}
        [L,1,C,Hkv,hd] or {"latent"} [L,1,C,dl+dr]) for the caller to
        scatter into the pool (``PagedKVCache.write_chunk``).
        """
        c = tokens.shape[1]
        positions = offset[:, None] + torch.arange(
            c, device=tokens.device, dtype=offset.dtype)[None, :]
        bt = state["block_table"]
        return self._prefill_layers(
            params, state, tokens, positions,
            gqa=lambda q, k, v, kp, vp: ops.paged_prefill(
                q, k, v, kp, vp, bt, offset, backend=backend),
            mla=lambda ql, qr, lat, latp: ops.mla_prefill(
                ql, qr, lat, latp, bt, offset, d_latent=self.cfg.d_latent,
                scale=self.mla_scale, backend=backend))

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
            gqa=lambda q, k, v, kp, vp: ops.paged_prefill_seg(
                q, k, v, kp, vp, bt, chunk_positions, backend=backend),
            mla=lambda ql, qr, lat, latp: ops.mla_prefill_seg(
                ql, qr, lat, latp, bt, chunk_positions,
                d_latent=self.cfg.d_latent, scale=self.mla_scale,
                backend=backend))


class VLMModel(DecoderModel):
    """The llama-3.2-vision decoder: the GQA decoder's self layers, and a
    gated cross-attention block over the projected image patches before
    each group of ``n_layers // n_cross`` self layers, as the JAX
    package's ``DecoderModel`` runs its VLM branch (its groups, not the
    layer ids of ``cfg.cross_attn_layer_ids()``, place the blocks).
    ``prefill`` and ``decode_step`` on the dense slot state only."""

    def __init__(self, cfg: ModelConfig, shd=NOSHARD,
                 kv_dtype: str = "bfloat16"):
        self.n_cross = len(cfg.cross_attn_layer_ids())
        if (kv_dtype != "bfloat16" or cfg.attention_variant == MLA
                or self.n_cross == 0 or cfg.n_layers % self.n_cross):
            raise ValueError(
                f"{cfg.name}: the VLM takes GQA self layers, a bf16 slot "
                f"cache and n_layers ({cfg.n_layers}) a multiple of its "
                f"{self.n_cross} cross-attention blocks")
        self.per = cfg.n_layers // self.n_cross
        super().__init__(cfg, shd, kv_dtype)

    def param_specs(self) -> Params:
        cfg = self.cfg
        out = super().param_specs()
        cross = {"attn": attn.attn_pspecs(cfg, cross=True),
                 "ln": _ln_spec(cfg.d_model),
                 "gate": PSpec((1,), (None,), init="zeros")}
        out["cross"] = stack_specs(cross, self.n_cross)
        out["patch_proj"] = PSpec((cfg.d_model, cfg.d_model),
                                  ("embed", "embed_out"))
        return out

    def supports_paged_decode(self) -> bool:
        return False

    def _unsupported(self, *args, **kwargs):
        raise NotImplementedError(
            f"{self.cfg.name}: the VLM has only the dense layout's prefill "
            f"and decode_step")

    decode_step_paged = prefill_chunk = prefill_chunk_seg = \
        prefill_suffix = _unsupported

    def decode_state_specs(self, batch: int, max_len: int) -> Dict[str, PSpec]:
        """The GQA slot state plus every cross block's keys and values of
        the row's patches, "xk"/"xv" [n_cross, B, n_patches, Hkv, hd]."""
        cfg = self.cfg
        out = super().decode_state_specs(batch, max_len)
        xkv = PSpec((self.n_cross, batch, cfg.n_patches,
                     max(cfg.n_kv_heads, 1), cfg.hd),
                    ("layers", "batch", None, "kv_heads", None), init="zeros")
        out["xk"] = xkv
        out["xv"] = xkv
        return out

    def _add_aux_specs(self, out, shape):
        if shape.kind != KIND_DECODE:
            out["patches"] = _meta((shape.global_batch, self.cfg.n_patches,
                                    self.cfg.d_model), torch.bfloat16)

    def _cross_block(self, cp, x, xk, xv):
        """x + tanh(gate) * cross-attention of ln(x) over xk/xv (the gate
        in float32, cast to x's dtype)."""
        h = rms_norm(x, cp["ln"], self.cfg.norm_eps)
        o = attn.cross_attention(cp["attn"], h, xk, xv, self.shd)
        return self._residual(
            x + torch.tanh(cp["gate"].float()).to(x.dtype) * o)

    def _group(self, g: int) -> range:
        return range(g * self.per, (g + 1) * self.per)

    def _train_group(self, cp, lps, x, mem, positions, backend):
        """A cross group of the training forward: its cross block (params
        ``cp``) over the projected patches ``mem``, then its self layers
        ``lps``, each under ``remat``."""
        x = self._cross_block(cp, x, *attn.cross_kv(cp["attn"], mem))
        for lp in lps:
            x, _ = remat(self._train_layer, lp, x, positions, backend)
        return x

    def _train_layers(self, params, batch, x, positions, backend):
        """As JAX scans the VLM: ``batch["patches"]`` [B,n_patches,D]
        projected once, then each group (its cross block and its self
        layers) under ``remat`` too."""
        mem = torch.matmul(batch["patches"], params["patch_proj"])
        cross, layers = unstack(params, "cross"), unstack(params)
        for g in range(self.n_cross):
            x = remat(self._train_group, cross[g],
                      [layers[i] for i in self._group(g)], x, mem, positions,
                      backend)
        return x, []

    def prefill(self, params, batch, backend=None):
        """Monolithic prefill of ``batch["tokens"]`` [B,S] with
        ``batch["patches"]`` [B,n_patches,D], from position 0.  The
        patches are projected once (``patch_proj``); each group's cross
        block attends its own keys and values of them, the self layers
        run the flash prefill kernel.  Returns (logits of the last
        position [B,V], {"k"/"v" [L,B,S,Hkv,hd], "xk"/"xv"
        [n_cross,B,n_patches,Hkv,hd], "lengths" [B] = S})."""
        tokens = batch["tokens"]
        b, s = tokens.shape
        positions = torch.arange(s, device=tokens.device)[None, :]
        mem = torch.matmul(batch["patches"], params["patch_proj"])
        x = self._embed(params, tokens)
        kv, xkv = [], []
        for g in range(self.n_cross):
            cp = layer_params(params, g, "cross")
            xkv.append(attn.cross_kv(cp["attn"], mem))
            x = self._cross_block(cp, x, *xkv[-1])
            for i in self._group(g):
                x, c = self._self_block_full(layer_params(params, i), x,
                                             positions, backend)
                kv.append(c)
        x = rms_norm(x, params["ln_f"], self.cfg.norm_eps)
        (k, v), (xk, xv) = (tuple(torch.stack(c) for c in zip(*e))
                            for e in (kv, xkv))
        lengths = torch.full((b,), s, dtype=torch.int32,
                             device=tokens.device)
        return self._logits(params, x[:, -1]), {
            "lengths": lengths, "k": self._kv_state(k),
            "v": self._kv_state(v), "xk": xk, "xv": xv}

    def decode_step(self, params, state, tokens, backend=None):
        """One batched decode step over the dense slot state: each group's
        cross block over the cached "xk"/"xv", then its self layers
        (``_self_block_decode``: the paged decode kernel over the slots
        seen as pages).  Returns (logits [B,V], state with lengths + 1)."""
        x = self.shd.embed_lookup(params["embed"], tokens)[:, None, :]
        for g in range(self.n_cross):
            x = self._cross_block(layer_params(params, g, "cross"), x,
                                  state["xk"][g], state["xv"][g])
            for i in self._group(g):
                x = self._self_block_decode(layer_params(params, i), x,
                                            state, i, backend)
        return self._decode_out(params, x, state)


class EncDecModel(Model):
    """The Whisper-style encoder-decoder: a bidirectional encoder over
    precomputed frame embeddings and a causal decoder whose layers
    cross-attend the encoder's output; sinusoidal positions, no RoPE,
    tied embeddings.  The decoder's self-attention runs the flash
    prefill kernel in ``prefill`` and the paged decode kernel over the
    slots seen as pages in ``decode_step``; the encoder and the
    cross-attention run ``attention.full_attention``."""

    def param_specs(self) -> Params:
        cfg = self.cfg
        d = cfg.d_model
        enc_layer = {"attn": attn.attn_pspecs(cfg),
                     "ffn": _dense_ffn_pspecs(cfg),
                     "ln1": _ln_spec(d), "ln2": _ln_spec(d)}
        dec_layer = {"attn": attn.attn_pspecs(cfg),
                     "xattn": attn.attn_pspecs(cfg, cross=True),
                     "ffn": _dense_ffn_pspecs(cfg),
                     "ln1": _ln_spec(d), "ln2": _ln_spec(d),
                     "ln3": _ln_spec(d)}
        return {
            "embed": PSpec((cfg.vocab_size, d), ("vocab", "embed")),
            "enc_layers": stack_specs(enc_layer, cfg.n_enc_layers),
            "dec_layers": stack_specs(dec_layer, cfg.n_layers),
            "ln_enc": _ln_spec(d),
            "ln_dec": _ln_spec(d),
        }

    def decode_state_specs(self, batch: int, max_len: int) -> Dict[str, PSpec]:
        """Each decoder layer's self K/V slots "k"/"v" [L,B,max_len,Hkv,hd]
        and its keys and values of the encoder output "xk"/"xv"
        [L,B,enc_len,Hkv,hd]."""
        cfg = self.cfg
        L, hkv, hd = cfg.n_layers, cfg.n_kv_heads, cfg.hd
        kv = PSpec((L, batch, max_len, hkv, hd),
                   ("layers", "batch", "kv_seq", None, None), init="zeros")
        xkv = PSpec((L, batch, cfg.enc_len, hkv, hd),
                    ("layers", "batch", None, "kv_heads", None), init="zeros")
        return {"k": kv, "v": kv, "xk": xkv, "xv": xkv,
                "lengths": PSpec((batch,), ("batch",), init="zeros",
                                 dtype="int32")}

    def _ffn_residual(self, lp, x, ln: str, shd=NOSHARD):
        h = rms_norm(x, lp[ln], self.cfg.norm_eps)
        f = lp["ffn"]
        return self._residual(
            x + swiglu(h, f["w_gate"], f["w_up"], f["w_down"], shd))

    def _add_aux_specs(self, out, shape):
        if shape.kind != KIND_DECODE:
            out["frames"] = _meta((shape.global_batch, self.cfg.enc_len,
                                   self.cfg.d_model), torch.bfloat16)

    def encode(self, params, frames):
        """frames [B,enc_len,D] (precomputed: the conv frontend is a stub)
        plus sinusoidal positions, through the bidirectional encoder
        layers and the final norm -> [B,enc_len,D]."""
        cfg = self.cfg
        s = frames.shape[1]
        x = frames + sinusoid_at(torch.arange(s, device=frames.device),
                                 cfg.d_model, frames.dtype)[None]
        for lp in unstack(params, "enc_layers"):
            h = rms_norm(x, lp["ln1"], cfg.norm_eps)
            q, k, v = attn.project_qkv(lp["attn"], h, None, cfg, rope=False,
                                       shd=self.shd)
            x = self._residual(x + attn.out_proj(
                attn.full_attention(q, k, v), lp["attn"]["wo"]))
            x = self._ffn_residual(lp, x, "ln2", self.shd)
        # the decoder layers' partial K/V input gradients, summed, are
        # all-reduced here, before the final norm's backward
        return self.shd(rms_norm(x, params["ln_enc"], cfg.norm_eps),
                        "batch", "seq", None)

    def _embed_dec(self, params, tokens, positions):
        """The decoder's token embedding plus sinusoidal positions; a
        decode step's single token through ``shd.embed_lookup``, as the
        JAX package looks it up, a prompt as ``_embed`` looks it up (its
        vocab-sharded rows summed over the shards by one all-reduce, as
        JAX's gather is)."""
        if tokens.shape[-1] == 1:
            x = self.shd.embed_lookup(params["embed"],
                                      tokens[:, 0])[:, None, :]
        else:
            x = self._embed(params, tokens)
        return x + sinusoid_at(positions, self.cfg.d_model, x.dtype)

    def _cross(self, lp, x, xk, xv):
        h = rms_norm(x, lp["ln2"], self.cfg.norm_eps)
        return self._residual(
            x + attn.cross_attention(lp["xattn"], h, xk, xv, self.shd))

    def _dec_layer(self, lp, x, enc_out, backend=None):
        """One decoder layer over a whole prompt from position 0: causal
        self-attention (the flash prefill kernel), cross-attention over
        its keys and values of ``enc_out``, the FFN -> (x, (k, v, xk,
        xv))."""
        h = rms_norm(x, lp["ln1"], self.cfg.norm_eps)
        q, k, v = attn.project_qkv(lp["attn"], h, None, self.cfg, rope=False,
                                   shd=self.shd)
        o = attn.causal_attention(q, k, v, backend=backend, shd=self.shd)
        x = self._residual(x + attn.out_proj(o, lp["attn"]["wo"]))
        xk, xv = attn.cross_kv(lp["xattn"], enc_out)
        x = self._ffn_residual(lp, self._cross(lp, x, xk, xv), "ln3",
                               self.shd)
        return x, (k, v, xk, xv)

    def train_loss(self, params, batch, backend=None):
        """The JAX package's: ``batch["frames"]`` through the encoder (no
        remat, as in JAX), then each decoder layer under ``remat``, the
        cross-entropy over every position."""
        cfg = self.cfg
        enc_out = self.encode(params, batch["frames"])
        tokens = batch["tokens"]
        positions = torch.arange(tokens.shape[1], device=tokens.device)[None]
        x = self._embed_dec(params, tokens, positions)
        for lp in unstack(params, "dec_layers"):
            x = remat(self._dec_layer, lp, x, enc_out, backend)[0]
        x = rms_norm(x, params["ln_dec"], cfg.norm_eps)
        return self._loss_from_logits(self._logits(params, x),
                                      batch["labels"])

    def prefill(self, params, batch, backend=None):
        """Encode ``batch["frames"]`` [B,enc_len,D], then the decoder over
        ``batch["tokens"]`` [B,S] from position 0: causal self-attention
        through the flash prefill kernel, cross-attention over each
        layer's keys and values of the encoder output.  Returns (logits
        of the last position [B,V], {"k"/"v" [L,B,S,Hkv,hd], "xk"/"xv"
        [L,B,enc_len,Hkv,hd], "lengths" [B] = S})."""
        cfg = self.cfg
        enc_out = self.encode(params, batch["frames"])
        tokens = batch["tokens"]
        b, s = tokens.shape
        positions = torch.arange(s, device=tokens.device)[None, :]
        x = self._embed_dec(params, tokens, positions)
        caches = []
        for i in range(cfg.n_layers):
            x, c = self._dec_layer(layer_params(params, i, "dec_layers"), x,
                                   enc_out, backend)
            caches.append(c)
        x = rms_norm(x, params["ln_dec"], cfg.norm_eps)
        k, v, xk, xv = (torch.stack(c) for c in zip(*caches))
        lengths = torch.full((b,), s, dtype=torch.int32,
                             device=tokens.device)
        return self._logits(params, x[:, -1]), {
            "k": self._kv_state(k), "v": self._kv_state(v), "xk": xk,
            "xv": xv, "lengths": lengths}

    def decode_step(self, params, state, tokens, backend=None):
        """One batched decoder step over the dense slot state at sinusoidal
        positions ``lengths``: each row's new K/V written at its length
        (in place), self-attention over length + 1 tokens through the
        paged decode kernel over the slots seen as pages, cross-attention
        over the cached "xk"/"xv".  Returns (logits [B,V], state with
        lengths + 1)."""
        cfg = self.cfg
        lengths = state["lengths"]
        x = self._embed_dec(params, tokens[:, None], lengths[:, None])
        for i in range(cfg.n_layers):
            lp = layer_params(params, i, "dec_layers")
            h = rms_norm(x, lp["ln1"], cfg.norm_eps)
            q, k_new, v_new = attn.project_qkv(lp["attn"], h, None, cfg,
                                               rope=False)
            k_c, v_c = state["k"][i], state["v"][i]
            attn.cache_write(k_c, k_new, lengths)
            attn.cache_write(v_c, v_new, lengths)
            o = attn.decode_attention(q, k_c, v_c, lengths + 1,
                                      backend=backend)
            x = self._residual(x + attn.out_proj(o, lp["attn"]["wo"]))
            x = self._cross(lp, x, state["xk"][i], state["xv"][i])
            x = self._ffn_residual(lp, x, "ln3")
        x = rms_norm(x[:, 0], params["ln_dec"], cfg.norm_eps)
        return self._logits(params, x), {**state, "lengths": lengths + 1}


class HybridModel(Model):
    """zamba2: a Mamba2 backbone and ONE shared attention block (GQA
    attention and a SwiGLU FFN, weights shared) applied after each of
    ``cfg.attn_layer_ids()``.  ``prefill`` and ``decode_step`` on a
    dense per-row state: each Mamba layer's SSM and conv state, and each
    application's K/V slots.  The shared block's attention runs the
    flash prefill kernel in ``prefill`` and the paged decode kernel over
    the slots seen as pages in ``decode_step``, as the VLM's self layers
    do; the Mamba2 mixer is plain PyTorch (``models/ssm.py``)."""

    def param_specs(self) -> Params:
        cfg = self.cfg
        layer = {"mamba": ssm.mamba_pspecs(cfg), "ln": _ln_spec(cfg.d_model)}
        shared = {"attn": attn.attn_pspecs(cfg), "ffn": _dense_ffn_pspecs(cfg),
                  "ln1": _ln_spec(cfg.d_model), "ln2": _ln_spec(cfg.d_model)}
        return {
            "embed": PSpec((cfg.vocab_size, cfg.d_model), ("vocab", "embed")),
            "layers": stack_specs(layer, cfg.n_layers),
            "shared": shared,
            "ln_f": _ln_spec(cfg.d_model),
        }

    def decode_state_specs(self, batch: int, max_len: int) -> Params:
        """The JAX package's: "mamba" {ssm [L,B,H,P,N], conv_x
        [L,B,K-1,di], conv_B/conv_C [L,B,K-1,N]}, the shared block's K/V
        slots "k"/"v" [n_apps,B,max_len,Hkv,hd] and "lengths" [B]."""
        cfg = self.cfg
        kv = PSpec((len(cfg.attn_layer_ids()), batch, max_len,
                    cfg.n_kv_heads, cfg.hd),
                   ("layers", "batch", "kv_seq", None, None), init="zeros")
        return {"mamba": stack_specs(ssm.mamba_state_pspecs(cfg, batch),
                                     cfg.n_layers),
                "k": kv, "v": kv,
                "lengths": PSpec((batch,), ("batch",), init="zeros",
                                 dtype="int32")}

    def _segments(self):
        """(first layer, end layer, shared block after it?) runs."""
        bounds, prev = [], 0
        for i in self.cfg.attn_layer_ids():
            bounds.append((prev, i + 1, True))
            prev = i + 1
        if prev < self.cfg.n_layers:
            bounds.append((prev, self.cfg.n_layers, False))
        return bounds

    def _shared_ffn(self, sp, x):
        h = rms_norm(x, sp["ln2"], self.cfg.norm_eps)
        f = sp["ffn"]
        return self._residual(
            x + swiglu(h, f["w_gate"], f["w_up"], f["w_down"], self.shd))

    def _shared_block(self, sp, x, positions, backend=None):
        """The shared attention block over a whole prompt from position 0
        (the flash prefill kernel) -> (x, (k, v))."""
        h = rms_norm(x, sp["ln1"], self.cfg.norm_eps)
        q, k, v = attn.project_qkv(sp["attn"], h, positions, self.cfg,
                                   shd=self.shd)
        o = attn.causal_attention(q, k, v, backend=backend, shd=self.shd)
        x = self._residual(x + attn.out_proj(o, sp["attn"]["wo"]))
        return self._shared_ffn(sp, x), (k, v)

    def _mamba_layer(self, lp, x):
        return self._residual(x + ssm.mamba_block(
            lp["mamba"], rms_norm(x, lp["ln"], self.cfg.norm_eps), self.cfg,
            self.shd))

    def train_loss(self, params, batch, backend=None):
        """The JAX package's: each Mamba2 layer under ``remat``, the
        shared block after each of its layers without (as in JAX), the
        cross-entropy over every position."""
        tokens = batch["tokens"]
        positions = torch.arange(tokens.shape[1], device=tokens.device)[None]
        x = self._embed(params, tokens)
        layers = unstack(params)
        for lo, hi, has_attn in self._segments():
            for i in range(lo, hi):
                x = remat(self._mamba_layer, layers[i], x)
            if has_attn:
                x, _ = self._shared_block(params["shared"], x, positions,
                                          backend)
        x = rms_norm(x, params["ln_f"], self.cfg.norm_eps)
        return self._loss_from_logits(self._logits(params, x),
                                      batch["labels"])

    def prefill(self, params, batch, backend=None):
        """Prefill of ``batch["tokens"]`` [B,S] from position 0 (S at
        least K-1 = ``ssm_conv - 1``).  Returns (logits of the last
        position [B,V], {"mamba": each layer's state after the prompt,
        "k"/"v" [n_apps,B,S,Hkv,hd], "lengths" [B] = S})."""
        cfg = self.cfg
        tokens = batch["tokens"]
        b, s = tokens.shape
        positions = torch.arange(s, device=tokens.device)[None, :]
        sp = params["shared"]
        x = self._embed(params, tokens)
        mamba, kv = [], []
        for lo, hi, has_attn in self._segments():
            for i in range(lo, hi):
                lp = layer_params(params, i)
                y, st = ssm.mamba_block_with_state(
                    lp["mamba"], rms_norm(x, lp["ln"], cfg.norm_eps), cfg,
                    self.shd)
                x = self._residual(x + y)
                mamba.append(st)
            if has_attn:
                x, c = self._shared_block(sp, x, positions, backend)
                kv.append(c)
        x = rms_norm(x, params["ln_f"], cfg.norm_eps)
        k, v = (torch.stack(c) for c in zip(*kv))
        lengths = torch.full((b,), s, dtype=torch.int32,
                             device=tokens.device)
        return self._logits(params, x[:, -1]), {
            "mamba": {key: torch.stack([st[key] for st in mamba])
                      for key in mamba[0]},
            "k": self._kv_state(k), "v": self._kv_state(v),
            "lengths": lengths}

    def decode_step(self, params, state, tokens, backend=None):
        """One batched decode step over the dense per-row state: each
        Mamba layer's recurrent update (its state overwritten in place),
        and at application ``ai`` the shared block over its slots (the
        new K/V written at each row's length in place, RoPE at that
        length, the paged decode kernel over length + 1 tokens).
        Returns (logits [B,V], state with lengths + 1)."""
        cfg = self.cfg
        lengths = state["lengths"]
        sp = params["shared"]
        x = self.shd.embed_lookup(params["embed"], tokens)      # [B, D]
        ai = 0
        for lo, hi, has_attn in self._segments():
            for i in range(lo, hi):
                lp = layer_params(params, i)
                st = {key: t[i] for key, t in state["mamba"].items()}
                y, new = ssm.mamba_decode_step(
                    lp["mamba"], rms_norm(x, lp["ln"], cfg.norm_eps), st,
                    cfg)
                x = self._residual(x + y)
                for key, t in new.items():
                    st[key].copy_(t)
            if has_attn:
                xs = x[:, None]
                h = rms_norm(xs, sp["ln1"], cfg.norm_eps)
                q, k_new, v_new = attn.project_qkv(sp["attn"], h,
                                                   lengths[:, None], cfg)
                k_c, v_c = state["k"][ai], state["v"][ai]
                attn.cache_write(k_c, k_new, lengths)
                attn.cache_write(v_c, v_new, lengths)
                o = attn.decode_attention(q, k_c, v_c, lengths + 1,
                                          backend=backend)
                x = self._shared_ffn(sp, self._residual(
                    xs + attn.out_proj(o, sp["attn"]["wo"])))[:, 0]
                ai += 1
        x = rms_norm(x, params["ln_f"], cfg.norm_eps)
        return self._logits(params, x), {**state, "lengths": lengths + 1}


class RWKVModel(Model):
    """RWKV6: ``ln0`` after the embedding, then per layer the time-mix
    and the channel-mix, each after its layer norm (with bias), an
    ``ln_f`` with zero bias and an untied ``head``.  ``prefill`` and
    ``decode_step`` on a dense per-row state: each layer's wkv state and
    its last ln1 / ln2 outputs (the token shift).  Plain PyTorch
    (``models/rwkv.py``): no kernel."""

    def param_specs(self) -> Params:
        cfg = self.cfg
        d = cfg.d_model
        bias = PSpec((d,), ("embed",), init="zeros")
        layer = dict(rwkv.rwkv_pspecs(cfg), ln1_g=_ln_spec(d), ln1_b=bias,
                     ln2_g=_ln_spec(d), ln2_b=bias)
        return {
            "embed": PSpec((cfg.vocab_size, d), ("vocab", "embed")),
            "ln0_g": _ln_spec(d),
            "ln0_b": bias,
            "layers": stack_specs(layer, cfg.n_layers),
            "ln_f": _ln_spec(d),
            "head": PSpec((d, cfg.vocab_size), ("embed", "vocab")),
        }

    def decode_state_specs(self, batch: int, max_len: int) -> Params:
        """The JAX package's: "wkv" [L,B,H,hd,hd], "tm_x"/"cm_x" [L,B,D]
        and "lengths" [B]; ``max_len`` does not size it."""
        st = stack_specs(rwkv.rwkv_state_pspecs(self.cfg, batch),
                         self.cfg.n_layers)
        st["lengths"] = PSpec((batch,), ("batch",), init="zeros",
                              dtype="int32")
        return st

    def _ln(self, x, g, b):
        return layer_norm(x, g, b, self.cfg.norm_eps)

    def _final(self, params, x):
        return self._logits(params, self._ln(x, params["ln_f"],
                                             torch.zeros_like(
                                                 params["ln_f"])))

    def _train_layer(self, lp, x):
        x = self._residual(x + rwkv.time_mix(
            lp, self._ln(x, lp["ln1_g"], lp["ln1_b"]), self.cfg, self.shd))
        return self._residual(x + rwkv.channel_mix(
            lp, self._ln(x, lp["ln2_g"], lp["ln2_b"]), shd=self.shd))

    def train_loss(self, params, batch, backend=None):
        """The JAX package's: each layer under ``remat``, the
        cross-entropy over every position.  No kernel runs (``backend``
        is accepted for a uniform signature)."""
        x = self._ln(self._embed(params, batch["tokens"]), params["ln0_g"],
                     params["ln0_b"])
        for lp in unstack(params):
            x = remat(self._train_layer, lp, x)
        return self._loss_from_logits(self._final(params, x),
                                      batch["labels"])

    def prefill(self, params, batch):
        """Prefill of ``batch["tokens"]`` [B,S].  Returns (logits of the
        last position [B,V], {"wkv" [L,B,H,hd,hd] bf16 (as the JAX
        package returns it), "tm_x"/"cm_x" [L,B,D] the last token's ln1
        / ln2 outputs, "lengths" [B] = S})."""
        tokens = batch["tokens"]
        b, s = tokens.shape
        x = self._ln(self._embed(params, tokens), params["ln0_g"],
                     params["ln0_b"])
        states = []
        for i in range(self.cfg.n_layers):
            lp = layer_params(params, i)
            h = self._ln(x, lp["ln1_g"], lp["ln1_b"])
            out, wkv = rwkv.time_mix_with_state(lp, h, self.cfg)
            x = self._residual(x + out)
            h2 = self._ln(x, lp["ln2_g"], lp["ln2_b"])
            x = self._residual(x + rwkv.channel_mix(lp, h2, shd=self.shd))
            states.append({"wkv": wkv.to(torch.bfloat16), "tm_x": h[:, -1],
                           "cm_x": h2[:, -1]})
        state = {key: torch.stack([st[key] for st in states])
                 for key in states[0]}
        state["lengths"] = torch.full((b,), s, dtype=torch.int32,
                                      device=tokens.device)
        return self._final(params, x[:, -1]), state

    def decode_step(self, params, state, tokens):
        """One batched decode step: every layer's state overwritten in
        place.  Returns (logits [B,V], state with lengths + 1)."""
        x = self._ln(self.shd.embed_lookup(params["embed"], tokens),
                     params["ln0_g"], params["ln0_b"])
        for i in range(self.cfg.n_layers):
            lp = layer_params(params, i)
            st = {key: state[key][i] for key in ("wkv", "tm_x", "cm_x")}
            h = self._ln(x, lp["ln1_g"], lp["ln1_b"])
            out, new = rwkv.rwkv_decode_step(lp, h, st, self.cfg)
            x = self._residual(x + out)
            h2 = self._ln(x, lp["ln2_g"], lp["ln2_b"])
            out, new = rwkv.channel_mix_step(lp, h2, new)
            x = self._residual(x + out)
            for key, t in st.items():
                t.copy_(new[key])
        return self._final(params, x), {**state,
                                        "lengths": state["lengths"] + 1}


def build_model(cfg: ModelConfig, shd=NOSHARD,
                kv_dtype: str = "bfloat16") -> Model:
    """The decoder-only model (GQA/MHA/MQA or MLA attention, dense or MoE
    FFN) with a bf16 or int8 dense slot cache; the VLM, the
    encoder-decoder and the hybrid with bf16 slots; RWKV6.  ``shd`` is
    the activation sharding hook (``distributed/sharding.MeshSharding``;
    the default changes nothing)."""
    if cfg.family in (FAMILY_DECODER, FAMILY_MOE):
        return DecoderModel(cfg, shd, kv_dtype=kv_dtype)
    if cfg.family == FAMILY_VLM:
        return VLMModel(cfg, shd, kv_dtype=kv_dtype)
    families = {FAMILY_ENCDEC: EncDecModel, FAMILY_HYBRID: HybridModel,
                FAMILY_RWKV: RWKVModel}
    if cfg.family not in families:
        raise NotImplementedError(f"{cfg.name}: unknown family "
                                  f"{cfg.family!r}")
    if kv_dtype != "bfloat16":
        raise ValueError(f"{cfg.name}: the {cfg.family} family keeps a "
                         f"bf16 state")
    return families[cfg.family](cfg, shd)
