"""AdamW with float32 master weights, as pure functions of tensor trees.

The port of the JAX package's ``training/optimizer.py`` (not
``torch.optim``): the state holds a float32 master copy of the params
and the first and second moments, the model's params stay bf16 for
compute, and ``apply_updates`` returns new trees instead of updating in
place.  Trees are nested dicts of tensors (the params' layout), mapped
in sorted key order (``models/common.tree_map``).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, NamedTuple, Tuple

import torch

from repro_torch.models.common import tree_leaves, tree_map


class AdamWState(NamedTuple):
    step: torch.Tensor      # 0-d int32
    master: Any
    m: Any
    v: Any


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10_000
    grad_clip: float = 1.0


def lr_schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup + cosine decay to 10% (float32)."""
    warm = torch.clamp((step + 1) / max(1, cfg.warmup_steps), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(1, cfg.total_steps - cfg.warmup_steps), 0.0, 1.0)
    cos = 0.1 + 0.45 * (1.0 + torch.cos(math.pi * prog))
    return cfg.lr * warm * cos


def init_state(params: Any) -> AdamWState:
    """Step 0, the params in float32 and zeroed moments, on the params'
    device."""
    leaf = tree_leaves(params)[0]
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=leaf.device),
        master=tree_map(lambda p: p.detach().float().clone(), params),
        m=tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                   params),
        v=tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                   params))


def global_norm(tree: Any) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree_leaves(tree)))


@torch.no_grad()
def apply_updates(cfg: AdamWConfig, params: Any, grads: Any,
                  state: AdamWState) -> Tuple[Any, AdamWState, Dict]:
    """grads float32, params bf16 -> (new params bf16, new state,
    {"lr", "grad_norm"}): the clipped global norm, bias-corrected
    moments and decoupled weight decay ``wd * master`` inside the lr
    term, as the JAX package updates.

    DTensor grads are first moved to their moments' placements (ZeRO-1:
    a reduce-scatter of a data-parallel partial sum), the update runs
    on the shards, and each new param is gathered back to its param's
    placements."""
    grads = tree_map(_like, grads, state.m)
    step = state.step + 1
    lr = lr_schedule(cfg, state.step)
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1.0 - torch.pow(b1, step.float())
    bc2 = 1.0 - torch.pow(b2, step.float())

    def upd(g, m, v, mast):
        g = g.float() * scale
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        mh = m / bc1
        vh = v / bc2
        new_mast = mast - lr * (mh / (torch.sqrt(vh) + cfg.eps)
                                + cfg.weight_decay * mast)
        return m, v, new_mast

    out = tree_map(upd, grads, state.m, state.v, state.master)
    m, v, master = _pick(out, 0), _pick(out, 1), _pick(out, 2)
    new_params = tree_map(lambda mast, p: _like(mast.to(torch.bfloat16), p),
                          master, params)
    return new_params, AdamWState(step=step, master=master, m=m, v=v), \
        {"lr": lr, "grad_norm": gnorm}


def _like(x: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """``x`` redistributed to ``ref``'s placements when both are
    DTensors; else ``x``."""
    from torch.distributed.tensor import DTensor
    if (isinstance(x, DTensor) and isinstance(ref, DTensor)
            and x.placements != ref.placements):
        return x.redistribute(ref.device_mesh, ref.placements)
    return x


def _pick(tree: Any, i: int) -> Any:
    """Element ``i`` of every tuple leaf."""
    if isinstance(tree, dict):
        return {k: _pick(t, i) for k, t in tree.items()}
    return tree[i]
