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


def tree_map(fn: Callable, tree: ParamTree) -> ParamTree:
    """Apply ``fn`` to every leaf of a nested dict (sorted key order,
    the order JAX flattens a dict in)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k]) for k in sorted(tree)}
    return fn(tree)


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


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    """silu in float32, cast to x's dtype, then times the up projection."""
    g = torch.matmul(x, w_gate)
    u = torch.matmul(x, w_up)
    h = F.silu(g.float()).to(x.dtype) * u
    return torch.matmul(h, w_down)


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
