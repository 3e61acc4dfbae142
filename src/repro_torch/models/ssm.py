"""Mamba2 (SSD) block, the sequence mixer of the zamba2 hybrid.

Prefill runs the chunked SSD algorithm: quadratic attention-like work
inside fixed-size chunks and a linear recurrence across chunk boundaries
(the JAX package's ``lax.scan`` is a Python loop over the chunks).
Decode is the O(1) recurrent update.  Plain PyTorch on every device, as
the JAX package keeps this module in ``jnp``; no kernel.

Two departures from the JAX code, neither changing the function:

* a prompt that is not a multiple of the chunk runs its full chunks and
  then one remainder chunk, where JAX falls back to a single chunk of
  the whole prompt; the quadratic tensors stay [chunk, chunk] in size;
* the three-operand contraction ``bzij,bzijh,bzjhp->bzihp`` is two
  pairwise ones (scores times decay, then a batched matmul over j), so
  the six-index [b,z,i,j,h,p] tensor is never formed.

State per sequence: the SSM state [H, head_dim, N] and the last K-1
inputs of each causal conv.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.distributed.sharding import is_dtensor, per_shard
from repro_torch.models.common import (NOSHARD, PSpec, chunked_scan,
                                       rms_norm, softplus)

CHUNK = 64


def mamba_pspecs(cfg: ModelConfig) -> Dict[str, PSpec]:
    d, di, n, h = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads
    kw = cfg.ssm_conv
    return {
        "w_z": PSpec((d, di), ("embed", "inner")),
        "w_x": PSpec((d, di), ("embed", "inner")),
        "w_B": PSpec((d, n), ("embed", None)),
        "w_C": PSpec((d, n), ("embed", None)),
        "w_dt": PSpec((d, h), ("embed", "heads")),
        "conv_x": PSpec((kw, di), (None, "inner"), scale=0.2),
        "conv_B": PSpec((kw, n), (None, None), scale=0.2),
        "conv_C": PSpec((kw, n), (None, None), scale=0.2),
        "A_log": PSpec((h,), ("heads",), init="zeros"),
        "D": PSpec((h,), ("heads",), init="ones"),
        "dt_bias": PSpec((h,), ("heads",), init="zeros"),
        "norm": PSpec((di,), ("inner",), init="ones"),
        "w_out": PSpec((di, d), ("inner", "embed"),
                       scale=0.02 / math.sqrt(2 * max(cfg.n_layers, 1))),
    }


# ---------------------------------------------------------------------------
# causal depthwise conv
# ---------------------------------------------------------------------------
def _causal_conv(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """x [B,S,C], kernel [K,C] -> causal depthwise conv [B,S,C]: the K
    shifted products summed in order, each in x's dtype."""
    k, s = kernel.shape[0], x.shape[1]
    pad = torch.zeros_like(x[:, :1]).expand(-1, k - 1, -1)
    xp = torch.cat([pad, x], dim=1)
    return sum(xp[:, i:i + s, :] * kernel[i] for i in range(k))


def _conv_step(state: torch.Tensor, xt: torch.Tensor,
               kernel: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """state [B,K-1,C], xt [B,C] -> (new_state, y [B,C]), in the wider
    of the operands' dtypes, as ``jnp`` promotes them."""
    window = torch.cat([state, xt[:, None, :]], dim=1)
    dt = torch.promote_types(window.dtype, kernel.dtype)
    if is_dtensor(window):        # no contraction rule splits it: per tap
        return window[:, 1:, :], (window.to(dt) * kernel.to(dt)).sum(dim=1)
    y = torch.einsum("bkc,kc->bc", window.to(dt), kernel.to(dt))
    return window[:, 1:, :], y


# ---------------------------------------------------------------------------
# chunked SSD (prefill)
# ---------------------------------------------------------------------------
def _ssd_chunks(a, chunks, s0):
    """Equal chunks: x [b,z,c,h,p], dt [b,z,c,h] (float32), b_in/c_in
    [b,z,c,n] (float32); a [h]; s0 [b,h,p,n] float32, the state entering
    the first chunk.  Returns (y [b,z,c,h,p] float32, final state
    float32)."""
    x, dt, b_in, c_in = chunks
    c = x.shape[2]
    da = dt * a                                   # [b,z,c,h] (<= 0)
    cum = torch.cumsum(da, dim=2)                 # inclusive
    # intra-chunk: the decay exp(cum_i - cum_j) of the lower triangle
    # (its upper triangle has positive exponents, masked before exp)
    mask = torch.ones((c, c), dtype=torch.bool, device=x.device).tril()
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]   # [b,z,i,j,h]
    li = torch.exp(diff.masked_fill(~mask[None, None, :, :, None],
                                    float("-inf")))
    scores = torch.einsum("bzin,bzjn->bzij", c_in, b_in)
    wx = dt[..., None] * x.float()                # dt_j B_j x_j factor
    w = (scores[..., None] * li).permute(0, 1, 4, 2, 3)    # [b,z,h,i,j]
    y_intra = torch.matmul(w, wx.permute(0, 1, 3, 2, 4))   # [b,z,h,i,p]
    y_intra = y_intra.permute(0, 1, 3, 2, 4)
    # the state each chunk adds, decayed to its end
    decay_end = torch.exp(cum[:, :, -1:, :] - cum)          # [b,z,c,h]
    states = torch.einsum("bzchp,bzcn->bzhpn",
                          (decay_end * dt)[..., None] * x.float(), b_in)
    chunk_decay = torch.exp(cum[:, :, -1, :])               # [b,z,h]
    carry, entering = s0, []
    for z in range(x.shape[1]):
        entering.append(carry)                    # the state ENTERING z
        carry = carry * chunk_decay[:, z, :, None, None] + states[:, z]
    entering = torch.stack(entering, dim=1)       # [b,z,h,p,n]
    y_inter = torch.einsum("bzin,bzhpn->bzihp", c_in, entering) \
        * torch.exp(cum)[..., None]
    return y_intra + y_inter, carry


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                b_in: torch.Tensor, c_in: torch.Tensor, *,
                chunk: int = CHUNK,
                init_state: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B,S,H,P], dt [B,S,H] (>0), a [H] (<0), b_in/c_in [B,S,N].

    Returns (y [B,S,H,P], final_state [B,H,P,N]), both in x's dtype.
    The full chunks first, then one remainder chunk of S mod chunk
    tokens, the state carried between them in float32.  DTensors: each
    rank's rows and heads on their own."""
    if is_dtensor(x):
        return per_shard(
            lambda *t: ssd_chunked(*t[:5], chunk=chunk, init_state=t[5]),
            (x, dt, a, b_in, c_in, init_state),
            ((0, 2), (0, 2), (None, 0), (0, None), (0, None),
             None if init_state is None else (0, 1)), ((0, 2), (0, 1)))
    bsz, s, h, p = x.shape
    state = (torch.zeros((bsz, h, p, b_in.shape[-1]), dtype=torch.float32,
                         device=x.device) if init_state is None
             else init_state.float())
    y, state = chunked_scan(
        lambda chunks, st: _ssd_chunks(a.float(), chunks, st),
        [x, dt.float(), b_in.float(), c_in.float()], chunk, state)
    return y.to(x.dtype), state.to(x.dtype)


def ssd_step(state: torch.Tensor, xt: torch.Tensor, dt: torch.Tensor,
             a: torch.Tensor, bt: torch.Tensor, ct: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """O(1) decode, float32: state [B,H,P,N], xt [B,H,P], dt [B,H],
    bt/ct [B,N] -> (new_state, y [B,H,P]).  DTensors: each rank's rows
    and heads on their own."""
    if is_dtensor(state):
        return per_shard(ssd_step, (state, xt, dt, a, bt, ct),
                         ((0, 1), (0, 1), (0, 1), (None, 0), (0, None),
                          (0, None)), ((0, 1), (0, 1)))
    state, xt, dt, bt, ct = (t.float() for t in (state, xt, dt, bt, ct))
    dec = torch.exp(dt * a.float())                          # [B,H]
    upd = (dt[:, :, None] * xt)[..., None] * bt[:, None, None, :]
    new_state = state * dec[:, :, None, None] + upd
    y = torch.einsum("bhpn,bn->bhp", new_state, ct)
    return new_state, y


# ---------------------------------------------------------------------------
# full block
# ---------------------------------------------------------------------------
def _mamba_inputs(p: Dict, x: torch.Tensor, cfg: ModelConfig, shd=NOSHARD):
    """The projections of a prompt x [B,S,D]: z, the conv inputs
    (x_pre, b_pre, c_pre: the raw projections a conv state keeps) and
    the SSD operands.  Under a mesh the input gradients that arrive as
    partial sums over ``model`` (the head- and inner-split products',
    and B's and C's from the head-split SSD) are all-reduced where x, B
    and C enter (as JAX's step all-reduces them), so the norm before
    the block and the B / C convolutions run their backward whole."""
    x = shd(x, "batch", "seq", None)
    z = shd(torch.matmul(x, p["w_z"]), "batch", "seq", "inner")
    x_pre = torch.matmul(x, p["w_x"])
    b_pre = torch.matmul(x, p["w_B"])
    c_pre = torch.matmul(x, p["w_C"])
    xs = shd(F.silu(_causal_conv(x_pre, p["conv_x"]).float()).to(x.dtype),
             "batch", "seq", "inner")
    b_in, c_in = (shd(F.silu(_causal_conv(t, p[w]).float()), "batch", "seq",
                      None)
                  for t, w in ((b_pre, "conv_B"), (c_pre, "conv_C")))
    dt = softplus(torch.matmul(x, p["w_dt"]).float() + p["dt_bias"].float())
    return z, (x_pre, b_pre, c_pre), xs, b_in, c_in, dt


def _mamba_out(p: Dict, y: torch.Tensor, z: torch.Tensor,
               dtype: torch.dtype, cfg: ModelConfig) -> torch.Tensor:
    """The gated norm and the output projection of y [..., d_inner]."""
    y = rms_norm(y * F.silu(z.float()).to(dtype), p["norm"], cfg.norm_eps)
    return torch.matmul(y, p["w_out"])


def _skip(d: torch.Tensor, xh: torch.Tensor) -> torch.Tensor:
    """The skip term D x of xh [B,S,H,P], D [H]; on DTensors per shard
    of rows and heads, so D's gradient is its head shard's (DTensor's
    broadcast product would make it a partial sum of the whole D)."""
    if is_dtensor(xh):
        return per_shard(lambda x, dd: _skip(dd, x), (xh, d),
                         ((0, 2), (None, 0)), ((0, 2),))
    return d[None, None, :, None] * xh


def mamba_block_with_state(p: Dict, x: torch.Tensor, cfg: ModelConfig,
                           shd=NOSHARD
                           ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Prefill of x [B,S,D] -> (out [B,S,D], the decode state after the
    prompt: {"ssm" [B,H,P,N], "conv_x" [B,K-1,di], "conv_B"/"conv_C"
    [B,K-1,N]}).  A prompt shorter than K-1 tokens raises: the JAX
    package would hand decode a conv state of the wrong length."""
    bsz, s, _ = x.shape
    k = cfg.ssm_conv
    if s < k - 1:
        raise ValueError(f"{cfg.name}: a Mamba prefill needs at least "
                         f"{k - 1} tokens (the conv state), got {s}")
    h, hd = cfg.n_ssm_heads, cfg.ssm_head_dim
    z, pre, xs, b_in, c_in, dt = _mamba_inputs(p, x, cfg, shd)
    a = -torch.exp(p["A_log"].float())
    xh = xs.reshape(bsz, s, h, hd)
    y, final = ssd_chunked(xh, dt, a, b_in, c_in)
    y = y + _skip(p["D"], xh)
    out = _mamba_out(p, y.reshape(bsz, s, cfg.d_inner), z, x.dtype, cfg)
    state = {"ssm": final}
    for key, t in zip(("conv_x", "conv_B", "conv_C"), pre):
        state[key] = t[:, s - (k - 1):, :]
    return out, state


def mamba_block(p: Dict, x: torch.Tensor, cfg: ModelConfig,
                shd=NOSHARD) -> torch.Tensor:
    """Prefill path. x [B,S,D] -> [B,S,D]."""
    return mamba_block_with_state(p, x, cfg, shd)[0]


def mamba_decode_step(p: Dict, xt: torch.Tensor, state: Dict,
                      cfg: ModelConfig) -> Tuple[torch.Tensor, Dict]:
    """xt [B,D]; state {ssm [B,H,P,N], conv_x [B,K-1,di], conv_B/conv_C
    [B,K-1,N]} -> (y [B,D], new state: the ssm in its state's dtype)."""
    bsz = xt.shape[0]
    h, hd = cfg.n_ssm_heads, cfg.ssm_head_dim
    z = torch.matmul(xt, p["w_z"])
    cx, xc = _conv_step(state["conv_x"], torch.matmul(xt, p["w_x"]),
                        p["conv_x"])
    cb, bc = _conv_step(state["conv_B"], torch.matmul(xt, p["w_B"]),
                        p["conv_B"])
    cc, cc_in = _conv_step(state["conv_C"], torch.matmul(xt, p["w_C"]),
                           p["conv_C"])
    xs = F.silu(xc.float()).to(xt.dtype)
    b_in = F.silu(bc.float())
    c_in = F.silu(cc_in.float())
    dt = softplus(torch.matmul(xt, p["w_dt"]).float() + p["dt_bias"].float())
    a = -torch.exp(p["A_log"].float())
    xh = xs.reshape(bsz, h, hd)
    new_ssm, y = ssd_step(state["ssm"], xh, dt, a, b_in, c_in)
    y = y + p["D"][None, :, None] * xh
    y = y.reshape(bsz, cfg.d_inner).to(xt.dtype)
    out = _mamba_out(p, y, z, xt.dtype, cfg)
    return out, {"ssm": new_ssm.to(state["ssm"].dtype), "conv_x": cx,
                 "conv_B": cb, "conv_C": cc}


def mamba_state_pspecs(cfg: ModelConfig, batch: int) -> Dict[str, PSpec]:
    """The JAX package's: K-1 conv taps a state (``core/sizing`` budgets
    K)."""
    h, hd, n = cfg.n_ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    k, di = cfg.ssm_conv, cfg.d_inner
    return {
        "ssm": PSpec((batch, h, hd, n), ("batch", "heads", None, None),
                     init="zeros"),
        "conv_x": PSpec((batch, k - 1, di), ("batch", None, "inner"),
                        init="zeros"),
        "conv_B": PSpec((batch, k - 1, n), ("batch", None, None),
                        init="zeros"),
        "conv_C": PSpec((batch, k - 1, n), ("batch", None, None),
                        init="zeros"),
    }


# ---------------------------------------------------------------------------
# the sequential oracle
# ---------------------------------------------------------------------------
def ssd_reference(x, dt, a, b_in, c_in):
    """Token-by-token recurrence; slow but obviously correct."""
    bsz, s, h, p = x.shape
    n = b_in.shape[-1]
    state = torch.zeros((bsz, h, p, n), dtype=torch.float32,
                        device=x.device)
    ys = []
    for t in range(s):
        state, y = ssd_step(state, x[:, t], dt[:, t], a, b_in[:, t],
                            c_in[:, t])
        ys.append(y)
    return torch.stack(ys, dim=1).to(x.dtype), state
