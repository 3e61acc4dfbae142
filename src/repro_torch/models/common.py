"""Shared model-building blocks: param-spec trees, norms, RoPE, MLPs.

Params are plain nested dicts of tensors.  Every parameter is declared
once as a ``PSpec`` (shape + logical axes + init), as in the JAX
package, so the same declaration materializes the weights here and the
layer-stacked ``[L, ...]`` layout stays leaf-for-leaf identical to the
JAX ``init_params`` tree.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional, Tuple

import torch
import torch.nn.functional as F


# ---------------------------------------------------------------------------
# Device
# ---------------------------------------------------------------------------
def resolve_device(device) -> torch.device:
    """The device an entry point runs on: the CUDA card unless the caller
    names another device (``device="cpu"``); with no card it raises, as
    it does when asked for the card by name."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: entry points run on the card unless they "
            "are given device='cpu'")
    return device


def device_line(device: torch.device) -> str:
    """The line an example prints first: the device it runs on, and for
    the card its name."""
    if device.type == "cuda":
        return f"device: {device} ({torch.cuda.get_device_name(device)})"
    return f"device: {device}"


# ---------------------------------------------------------------------------
# Parameter declaration
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class PSpec:
    """Declarative parameter: shape, logical axis names, init scale."""
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    init: str = "normal"            # normal | zeros | ones | small
    scale: float = 0.02
    dtype: Optional[str] = None     # None -> the tree's default dtype

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


ParamTree = Any     # nested dict of PSpec / tensors


def tree_map(fn: Callable, tree: ParamTree, *rest: ParamTree) -> ParamTree:
    """Apply ``fn`` to every leaf of a nested dict (sorted key order,
    the order JAX flattens a dict in), leaf by leaf across ``tree`` and
    the same-shaped trees in ``rest``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    return fn(tree, *rest)


def tree_leaves(tree: ParamTree) -> list:
    """The leaves of a nested dict in ``tree_map``'s order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    return [tree]


def stack_specs(tree: ParamTree, n: int) -> ParamTree:
    """Add a leading 'layers' axis to every PSpec."""
    return tree_map(lambda p: PSpec((n,) + p.shape, ("layers",) + p.axes,
                                    p.init, p.scale, p.dtype), tree)


def materialize(tree: ParamTree, generator: torch.Generator,
                dtype: torch.dtype = torch.bfloat16,
                device=None) -> ParamTree:
    """Draw every leaf from ``generator`` (normal * scale in float32,
    then cast), on ``device``.  The draws differ from ``jax.random``'s,
    so cross-framework tests hand the JAX tree over through numpy
    (``models/convert.py``) instead."""
    def leaf(p: PSpec) -> torch.Tensor:
        dt = getattr(torch, p.dtype) if p.dtype else dtype
        if p.init == "zeros":
            return torch.zeros(p.shape, dtype=dt, device=device)
        if p.init == "ones":
            return torch.ones(p.shape, dtype=dt, device=device)
        scale = p.scale if p.init == "normal" else p.scale * 0.1
        x = torch.randn(p.shape, generator=generator, dtype=torch.float32,
                        device=device)
        return x.mul_(scale).to(dt)
    return tree_map(leaf, tree)


# ---------------------------------------------------------------------------
# Sharding hook: models call shd(x, *logical_axes) on activations.
# distributed/sharding.py supplies a real implementation; default no-op.
# ---------------------------------------------------------------------------
class NoSharding:
    active = False            # whether tensors are split over a mesh

    def __call__(self, x, *axes):
        return x

    def grad_layout(self, x, *axes):
        return x

    def embed_lookup(self, emb, tokens):
        return F.embedding(tokens.long(), emb)

    def vocab_gather(self, x, labels):
        """x [..., V] at ``labels`` [...] -> [...]."""
        return x.gather(-1, labels.long()[..., None])[..., 0]

    def dp_size(self) -> int:
        return 1


NOSHARD = NoSharding()


# ---------------------------------------------------------------------------
# Norms / activations
# ---------------------------------------------------------------------------
def rms_norm(x: torch.Tensor, gamma: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    """float32 reduction, cast back to x's dtype BEFORE the gamma
    multiply (the JAX package's rounding order)."""
    dt = x.dtype
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(dt) * gamma


def layer_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """float32 mean and population variance, cast back to x's dtype
    before ``* gamma + beta`` (the JAX package's rounding order)."""
    dt = x.dtype
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, correction=0)
    return ((xf - mu) * torch.rsqrt(var + eps)).to(dt) * gamma + beta


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``log(1 + exp(x))`` as ``jax.nn.softplus`` computes it (no
    threshold)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor, shd=NOSHARD) -> torch.Tensor:
    """silu in float32, cast to x's dtype, then times the up projection.
    Under a mesh x enters whole along the sequence (a sequence-parallel
    residual is gathered, as GSPMD gathers it for the product)."""
    x = shd(x, "batch", "seq", None)
    g = shd(torch.matmul(x, w_gate), "batch", "seq", "mlp")
    u = shd(torch.matmul(x, w_up), "batch", "seq", "mlp")
    h = F.silu(g.float()).to(x.dtype) * u
    return torch.matmul(h, w_down)


# ---------------------------------------------------------------------------
# Chunked scans (the recurrent mixers' prefill)
# ---------------------------------------------------------------------------
def chunked_scan(step: Callable, tensors, chunk: int, state):
    """Run ``step(chunks, state) -> (y, state)`` over tensors [B,S,...]
    cut into S // chunk full chunks, then one remainder chunk of
    S mod chunk tokens, each group passed as [B, n_chunks, c, ...] with
    the state that enters it.  Returns (y [B,S,...], the final state)."""
    b, s = tensors[0].shape[:2]
    chunk = min(chunk, s)
    full = (s // chunk) * chunk
    ys = []
    for lo, hi, c in ((0, full, chunk), (full, s, s - full)):
        if hi == lo:
            continue
        y, state = step([t[:, lo:hi].reshape((b, (hi - lo) // c, c)
                                             + t.shape[2:])
                         for t in tensors], state)
        ys.append(y.reshape((b, hi - lo) + y.shape[3:]))
    return (torch.cat(ys, dim=1) if len(ys) > 1 else ys[0]), state


# ---------------------------------------------------------------------------
# Rotary position embeddings (split-half, not interleaved)
# ---------------------------------------------------------------------------
def rope_freqs(dim: int, theta: float, device=None) -> torch.Tensor:
    i = torch.arange(0, dim, 2, dtype=torch.float32, device=device)
    return 1.0 / (theta ** (i / dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x [..., seq, heads, head_dim]; positions broadcastable to [..., seq]."""
    dim = x.shape[-1]
    freqs = rope_freqs(dim, theta, device=x.device)            # [dim/2]
    angles = positions[..., None].float() * freqs              # [..., s, dim/2]
    cos = torch.cos(angles)[..., None, :]                      # [..., s, 1, dim/2]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Sinusoidal positions (the enc-dec family: no RoPE)
# ---------------------------------------------------------------------------
def sinusoid_at(positions: torch.Tensor, dim: int,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Sinusoidal embedding at integer positions [...] -> [..., dim]:
    ``[sin(p / 10000^(2i/dim)) ; cos(...)]`` over i < dim/2, computed in
    float32, then cast to ``dtype`` (the activations')."""
    i = torch.arange(dim // 2, dtype=torch.float32, device=positions.device)
    angle = positions[..., None].float() / torch.pow(10000.0, 2 * i / dim)
    return torch.cat([torch.sin(angle), torch.cos(angle)], dim=-1).to(dtype)


# ---------------------------------------------------------------------------
# Softmax cross-entropy (the training loss)
# ---------------------------------------------------------------------------
def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None,
                  z_loss: float = 1e-4, shd=NOSHARD) -> torch.Tensor:
    """logits [..., V] in any dtype, labels [...] integer -> the mean
    negative log-likelihood in float32, plus ``z_loss`` times the square
    of each row's log-sum-exp of its max-shifted logits, as the JAX
    package computes it (the max is detached, as ``stop_gradient``
    does).  With ``mask`` [...], the masked mean.  Under a mesh the
    vocab sums are all-reduced into the rows' layout and each vocab shard
    gathers its own gold logits (``shd.vocab_gather``)."""
    lg = logits.float()
    shifted = lg - lg.amax(dim=-1, keepdim=True).detach()
    rows = ("batch", "seq")[:logits.dim() - 1]
    logz = torch.log(shd(torch.exp(shifted).sum(dim=-1), *rows))
    gold = shd.vocab_gather(shifted, labels)
    nll = logz - gold
    if z_loss:
        nll = nll + z_loss * torch.square(logz)
    if mask is not None:
        nll = nll * mask
        return nll.sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()

