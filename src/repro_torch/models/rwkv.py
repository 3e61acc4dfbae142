"""RWKV6 "Finch" block: attention-free time-mix with data-dependent decay.

The per-channel, per-token decay w_t comes from the input through a
low-rank projection.  Prefill uses a chunked linear-attention form
(GLA-style): within a chunk the pairwise decay products are computed in
factored form, across chunks a [H, dk, dv] state is carried (the JAX
package's ``lax.scan`` is a Python loop over the chunks).  Log-decays
are clamped to [-LOG_CLAMP, -1e-4], so the factored exponents of a chunk
of at most CHUNK tokens stay inside the float32 range (CHUNK * LOG_CLAMP
= 80 < 88).  Plain PyTorch on every device, as the JAX package keeps this
module in ``jnp``; no kernel.

A prompt that is not a multiple of CHUNK runs its full chunks and then
one remainder chunk of fewer than CHUNK tokens.  The JAX package falls
back to one chunk of the whole prompt there, whose factored exponents
leave the float32 range once the summed log-decay passes about 88 (a
few hundred tokens), so its output turns non-finite; this one stays
finite at any length and equals the sequential oracle.

As in the JAX package, the token-shift mixing coefficients are static
per channel (RWKV6's LoRA on them is dropped); the decay LoRA is kept.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.models.attention import _proj, out_proj
from repro_torch.distributed.sharding import is_dtensor, per_shard
from repro_torch.models.common import NOSHARD, PSpec, chunked_scan, softplus

CHUNK = 16
LOG_CLAMP = 5.0       # CHUNK * LOG_CLAMP = 80 < 88 (float32 exp range)
DECAY_LORA = 32


def rwkv_pspecs(cfg: ModelConfig) -> Dict[str, PSpec]:
    d, f = cfg.d_model, cfg.d_ff
    h, hd = cfg.n_heads, cfg.hd
    out_scale = 0.02 / math.sqrt(2 * max(cfg.n_layers, 1))
    return {
        # time-mix
        "mu_r": PSpec((d,), ("embed",), init="zeros"),
        "mu_k": PSpec((d,), ("embed",), init="zeros"),
        "mu_v": PSpec((d,), ("embed",), init="zeros"),
        "mu_w": PSpec((d,), ("embed",), init="zeros"),
        "mu_g": PSpec((d,), ("embed",), init="zeros"),
        "w_r": PSpec((d, h, hd), ("embed", "heads", None)),
        "w_k": PSpec((d, h, hd), ("embed", "heads", None)),
        "w_v": PSpec((d, h, hd), ("embed", "heads", None)),
        "w_g": PSpec((d, h, hd), ("embed", "heads", None)),
        "decay_a": PSpec((d, DECAY_LORA), ("embed", None)),
        "decay_b": PSpec((DECAY_LORA, h, hd), (None, "heads", None)),
        "decay_0": PSpec((h, hd), ("heads", None), init="zeros"),
        "bonus_u": PSpec((h, hd), ("heads", None)),
        "ln_x": PSpec((h, hd), ("heads", None), init="ones"),
        "w_o": PSpec((h, hd, d), ("heads", None, "embed"), scale=out_scale),
        # channel-mix
        "cmu_k": PSpec((d,), ("embed",), init="zeros"),
        "cmu_r": PSpec((d,), ("embed",), init="zeros"),
        "cw_k": PSpec((d, f), ("embed", "mlp")),
        "cw_v": PSpec((f, d), ("mlp", "embed"), scale=out_scale),
        "cw_r": PSpec((d, d), ("embed", "embed_out")),
    }


def _shift(x: torch.Tensor, last: Optional[torch.Tensor] = None
           ) -> torch.Tensor:
    """Token shift: x_{t-1} (zeros, or the carried ``last``, at t = 0).
    x [B,S,D]."""
    if last is None:
        return torch.cat([torch.zeros_like(x[:, :1]), x[:, :-1]], dim=1)
    return torch.cat([last[:, None, :].to(x.dtype), x[:, :-1]], dim=1)


class _Sigmoid(torch.autograd.Function):
    """sigmoid whose backward multiplies the gradient by the saved
    s (1 - s): linear in the gradient, so a partial sum stays one (on
    DTensors a mixing weight's gradient, a partial sum over the batch's
    data shards, then reaches ZeRO-1's reduce-scatter with the other
    weights'; DTensor's own sigmoid backward all-reduces it first)."""

    @staticmethod
    def forward(ctx, x):
        s = torch.sigmoid(x)
        ctx.save_for_backward(s)
        return s

    @staticmethod
    def backward(ctx, g):
        s, = ctx.saved_tensors
        return g * (s * (1 - s))


def _mix(x: torch.Tensor, xprev: torch.Tensor,
         mu: torch.Tensor) -> torch.Tensor:
    m = _Sigmoid.apply(mu.float()).to(x.dtype)
    return x + (xprev - x) * m


def _log_decay(p: Dict, xw: torch.Tensor) -> torch.Tensor:
    """Data-dependent log-decay in [-LOG_CLAMP, -1e-4]: xw [..., D] ->
    [..., H, hd] float32."""
    lora = torch.matmul(xw, p["decay_a"])
    # one [.., L] x [L, H*hd] product, as JAX's dot (an einsum here runs
    # it as a batched product of one)
    w = torch.tensordot(torch.tanh(lora.float()), p["decay_b"].float(),
                        dims=1)
    w = p["decay_0"].float() + w
    return -torch.clamp(softplus(w) + 1e-4, 1e-4, LOG_CLAMP)


# ---------------------------------------------------------------------------
# chunked WKV (prefill)
# ---------------------------------------------------------------------------
def _wkv_chunks(u, chunks, s0):
    """Equal chunks, float32: r/k/v/lw [b,z,c,h,dk], u [h,dk], s0
    [b,h,dk,dv] the state entering the first chunk.  Returns (y
    [b,z,c,h,dv], final state)."""
    r, k, v, lw = chunks
    c = r.shape[2]
    cw = torch.cumsum(lw, dim=2)                   # inclusive, <= 0
    cw_prev = cw - lw                              # exclusive (t - 1)
    r_f = r * torch.exp(cw_prev)                   # exponent <= 0
    k_f = k * torch.exp(-cw)                       # exponent <= c * clamp
    # strictly-lower-triangular pairwise terms
    amat = torch.einsum("bzihk,bzjhk->bzijh", r_f, k_f)
    mask = torch.ones((c, c), dtype=torch.bool, device=r.device).tril(-1)
    amat = torch.where(mask[None, None, :, :, None], amat,
                       amat.new_zeros(()))
    y_intra = torch.einsum("bzijh,bzjhe->bzihe", amat, v)
    # the bonus diagonal (u)
    bonus = (r * u * k).sum(-1)                    # [b,z,c,h]
    y_intra = y_intra + bonus[..., None] * v
    # inter-chunk
    k_end = k * torch.exp(cw[:, :, -1:] - cw)      # exponent <= 0
    states = torch.einsum("bzjhk,bzjhe->bzhke", k_end, v)
    chunk_decay = torch.exp(cw[:, :, -1])          # [b,z,h,dk]
    carry, entering = s0, []
    for z in range(r.shape[1]):
        entering.append(carry)                     # the state ENTERING z
        carry = carry * chunk_decay[:, z, ..., None] + states[:, z]
    entering = torch.stack(entering, dim=1)        # [b,z,h,dk,dv]
    y_inter = torch.einsum("bzihk,bzhke->bzihe", r_f, entering)
    return y_intra + y_inter, carry


def wkv_chunked(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                logw: torch.Tensor, u: torch.Tensor, *, chunk: int = CHUNK,
                init_state: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """r/k/v [B,S,H,K], logw [B,S,H,K] (<= 0, float32), u [H,K].

    Returns (y [B,S,H,K], final state [B,H,K,K] = the decayed sum of
    k (x) v), both float32.  The full chunks first, then one remainder
    chunk of S mod chunk tokens.  DTensors: each rank's rows and heads on
    their own."""
    if is_dtensor(r):
        return per_shard(
            lambda *t: wkv_chunked(*t[:5], chunk=chunk, init_state=t[5]),
            (r, k, v, logw, u, init_state),
            ((0, 2), (0, 2), (0, 2), (0, 2), (None, 0),
             None if init_state is None else (0, 1)), ((0, 2), (0, 1)))
    bsz, s, h, dk = r.shape
    state = (torch.zeros((bsz, h, dk, dk), dtype=torch.float32,
                         device=r.device) if init_state is None
             else init_state.float())
    return chunked_scan(lambda chunks, st: _wkv_chunks(u.float(), chunks, st),
                        [t.float() for t in (r, k, v, logw)], chunk, state)


def wkv_step(state: torch.Tensor, r: torch.Tensor, k: torch.Tensor,
             v: torch.Tensor, logw: torch.Tensor, u: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """O(1) decode, float32: state [B,H,K,V]; r/k/v [B,H,K]; logw
    [B,H,K] -> (new state, y [B,H,V]).  DTensors: each rank's rows and
    heads on their own."""
    if is_dtensor(state):
        return per_shard(wkv_step, (state, r, k, v, logw, u),
                         ((0, 1), (0, 1), (0, 1), (0, 1), (0, 1), (None, 0)),
                         ((0, 1), (0, 1)))
    sf = state.float()
    rf, kf, vf = (t.float() for t in (r, k, v))
    kv = kf[..., :, None] * vf[..., None, :]       # [B,H,K,V]
    y = torch.einsum("bhk,bhke->bhe", rf,
                     sf + u.float()[None, :, :, None] * kv)
    new = sf * torch.exp(logw.float())[..., None] + kv
    return new, y


# ---------------------------------------------------------------------------
# full blocks
# ---------------------------------------------------------------------------
def _group_norm(y: torch.Tensor, gamma: torch.Tensor,
                eps: float) -> torch.Tensor:
    """Per-head normalization of the wkv output y [..., H, K] (float32,
    population variance)."""
    yf = y.float()
    mu = yf.mean(dim=-1, keepdim=True)
    var = yf.var(dim=-1, keepdim=True, correction=0)
    return ((yf - mu) * torch.rsqrt(var + eps)) * gamma.float()


def _time_mix_inputs(p: Dict, x: torch.Tensor, xprev: torch.Tensor,
                     shd=NOSHARD):
    """r, k, v (x's dtype), the gate g (float32) and the log-decay of x
    and its shifted xprev."""
    xr, xk, xv, xw, xg = (_mix(x, xprev, p[m]) for m in
                          ("mu_r", "mu_k", "mu_v", "mu_w", "mu_g"))
    # each product's input is constrained whole under a mesh, so the
    # partial sum of its gradient (the weight is split over ``model``) is
    # all-reduced where it enters, as JAX's partitioned step reduces it,
    # before the mix and shift run their backward; channel_mix's too
    xr, xk, xv, xw, xg = (shd(a, "batch", "seq", None)
                          for a in (xr, xk, xv, xw, xg))
    r, k, v = (shd(_proj(a, p[w]), "batch", "seq", "heads", None)
               for a, w in ((xr, "w_r"), (xk, "w_k"), (xv, "w_v")))
    g = F.silu(_proj(xg, p["w_g"]).float())
    return r, k, v, g, _log_decay(p, xw)


def _time_mix_out(p: Dict, y: torch.Tensor, g: torch.Tensor,
                  dtype: torch.dtype, cfg: ModelConfig) -> torch.Tensor:
    return out_proj((_group_norm(y, p["ln_x"], cfg.norm_eps) * g).to(dtype),
                    p["w_o"])


def time_mix_with_state(p: Dict, x: torch.Tensor, cfg: ModelConfig,
                        shd=NOSHARD) -> Tuple[torch.Tensor, torch.Tensor]:
    """Prefill of x [B,S,D] from an empty state -> (out [B,S,D], the
    final wkv state [B,H,K,K] float32)."""
    r, k, v, g, logw = _time_mix_inputs(p, x, _shift(x), shd)
    y, final = wkv_chunked(r, k, v, logw, p["bonus_u"])
    return _time_mix_out(p, y, g, x.dtype, cfg), final


def time_mix(p: Dict, x: torch.Tensor, cfg: ModelConfig,
             shd=NOSHARD) -> torch.Tensor:
    return time_mix_with_state(p, x, cfg, shd)[0]


def channel_mix(p: Dict, x: torch.Tensor,
                last: Optional[torch.Tensor] = None,
                shd=NOSHARD) -> torch.Tensor:
    xprev = _shift(x, last)
    xk = shd(_mix(x, xprev, p["cmu_k"]), "batch", "seq", None)
    xr = shd(_mix(x, xprev, p["cmu_r"]), "batch", "seq", None)
    k = torch.matmul(xk, p["cw_k"])
    k = shd(torch.square(torch.relu(k.float())).to(x.dtype),
            "batch", "seq", "mlp")
    kv = torch.matmul(k, p["cw_v"])
    return torch.sigmoid(torch.matmul(xr, p["cw_r"]).float()).to(x.dtype) \
        * kv


def rwkv_decode_step(p: Dict, xt: torch.Tensor, state: Dict,
                     cfg: ModelConfig) -> Tuple[torch.Tensor, Dict]:
    """One token through the time-mix: xt [B,D] (ln1's output) ->
    (out [B,D], state with the new "wkv" in its dtype and "tm_x" = xt).
    The caller adds the residual and runs ``channel_mix_step``."""
    r, k, v, g, logw = _time_mix_inputs(p, xt, state["tm_x"].to(xt.dtype))
    new_wkv, y = wkv_step(state["wkv"], r, k, v, logw, p["bonus_u"])
    out = _time_mix_out(p, y, g, xt.dtype, cfg)
    return out, {**state, "wkv": new_wkv.to(state["wkv"].dtype),
                 "tm_x": xt}


def channel_mix_step(p: Dict, xt: torch.Tensor, state: Dict
                     ) -> Tuple[torch.Tensor, Dict]:
    """xt [B,D] (ln2's output) -> (out [B,D], state with "cm_x" = xt)."""
    out = channel_mix(p, xt[:, None], last=state["cm_x"])[:, 0]
    return out, {**state, "cm_x": xt}


def rwkv_state_pspecs(cfg: ModelConfig, batch: int) -> Dict[str, PSpec]:
    h, hd, d = cfg.n_heads, cfg.hd, cfg.d_model
    return {
        "wkv": PSpec((batch, h, hd, hd), ("batch", "heads", None, None),
                     init="zeros"),
        "tm_x": PSpec((batch, d), ("batch", None), init="zeros"),
        "cm_x": PSpec((batch, d), ("batch", None), init="zeros"),
    }


# ---------------------------------------------------------------------------
# the sequential oracle
# ---------------------------------------------------------------------------
def wkv_reference(r, k, v, logw, u):
    """Token-by-token recurrence; slow but obviously correct."""
    bsz, s, h, dk = r.shape
    state = torch.zeros((bsz, h, dk, dk), dtype=torch.float32,
                        device=r.device)
    ys = []
    for t in range(s):
        state, y = wkv_step(state, r[:, t], k[:, t], v[:, t], logw[:, t], u)
        ys.append(y)
    return torch.stack(ys, dim=1), state
