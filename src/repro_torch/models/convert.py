"""Cross a parameter tree from numpy into the port.

``jax.random`` and ``torch.Generator`` draw different numbers from one
seed, so a test that holds the port to the JAX package hands the JAX
``init_params`` tree over as numpy arrays (``np.asarray`` of each leaf)
and converts it here, one copy per leaf.  The layouts are identical, so
nothing is transposed: an MoE layer's ``router`` [D,E] and expert
``w_gate`` / ``w_up`` [E,D,F] and ``w_down`` [E,F,D] cross as they are.  A bf16 leaf arrives with numpy dtype name
``bfloat16``; its bits are reinterpreted through ``uint16`` without
importing the package that defines that dtype.  Tensors land on the
CUDA card unless ``device`` names another (``device="cpu"``).
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.models.common import resolve_device


def tensor_from_numpy(a: np.ndarray, device=None) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy())
        t = t.view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a, copy=True))
    return t.to(device=resolve_device(device))


def params_from_numpy(tree: Any, device=None) -> Any:
    """Nested dict of numpy arrays -> the same tree of tensors."""
    device = resolve_device(device)
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    return tensor_from_numpy(tree, device)
