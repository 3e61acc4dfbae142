"""Kernel-backend resolution for the paged attention ops.

Two backends:

* ``cuda``  — the hand-written CUDA C++ kernels under ``csrc/`` (built
              at first use by ``kernels/build.py``); CUDA tensors only.
* ``torch`` — the plain PyTorch versions in ``kernels/ref.py``, the
              counterpart of the JAX package's ``xla`` fallback.

Resolution order: an explicit ``backend=`` argument, then the device of
the input.  A CUDA tensor resolves to ``cuda`` and a CPU tensor to
``torch``.  A meta tensor (the dry run's, DTensors over meta shards too)
resolves to ``abstract``: the op returns empty outputs of the kernel's
shapes and dtypes and records the kernel's cost (``kernels/cost.py``);
no backend can be named for it.  ``cuda`` on a CPU tensor raises.  ``torch`` on a CUDA tensor
runs only when the caller names it explicitly (the reference comparison
in ``chip_smoke.py``).  There is no environment override and no silent
fall back from a failed kernel to the plain version.
"""
from __future__ import annotations

from typing import Optional

import torch

BACKENDS = ("cuda", "torch")


def resolve_backend(backend: Optional[str], x: torch.Tensor) -> str:
    """The backend one op call runs on, given its first tensor ``x``."""
    if x.device.type == "meta":
        return "abstract"
    if backend is not None:
        name = backend.strip().lower()
        if name not in BACKENDS:
            raise ValueError(f"unknown kernel backend {backend!r}; "
                             f"expected one of {BACKENDS}")
        if name == "cuda" and x.device.type != "cuda":
            raise ValueError(
                f"kernel backend 'cuda' needs CUDA tensors, got a tensor "
                f"on {x.device}")
        return name
    if x.device.type == "cuda":
        return "cuda"
    if x.device.type == "cpu":
        return "torch"
    raise ValueError(f"no kernel backend for tensors on {x.device}")
