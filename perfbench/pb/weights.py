"""Weights made by the benchmark from ``--seed``, on the device, in the
type they are served in: one draw of every normally distributed
element from a ``torch.Generator`` on the device, cut into the leaves of
the engine's layer-stacked layout and scaled in place.  The same tensors
go to ``ServingEngine(params=...)`` and to the reference.

The layout (leaf names, shapes, init scales) is the program's spec
tree; only its shapes and scales are read."""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch


def _leaves(tree, path=()) -> List[Tuple[tuple, object]]:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k], path + (k,))]
    return [(path, tree)]


def _put(tree: Dict, path: tuple, value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def make_params(specs, seed: int, device, dtype=torch.bfloat16) -> Dict:
    """Every leaf of ``specs`` (objects with ``shape``, ``init``,
    ``scale``): "normal" leaves are N(0, scale^2), "small" ones
    N(0, (scale / 10)^2), "zeros" / "ones" constant."""
    leaves = _leaves(specs)
    drawn = [(p, s) for p, s in leaves if s.init in ("normal", "small")]
    total = sum(_numel(s.shape) for _, s in drawn)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) & ((1 << 63) - 1))
    flat = torch.randn(total, generator=gen, device=device, dtype=dtype)
    out: Dict = {}
    at = 0
    for path, s in drawn:
        n = _numel(s.shape)
        leaf = flat[at:at + n].view(s.shape)
        leaf.mul_(s.scale if s.init == "normal" else s.scale * 0.1)
        _put(out, path, leaf)
        at += n
    for path, s in leaves:
        if s.init == "zeros":
            _put(out, path, torch.zeros(s.shape, dtype=dtype, device=device))
        elif s.init == "ones":
            _put(out, path, torch.ones(s.shape, dtype=dtype, device=device))
    return out


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    return n
