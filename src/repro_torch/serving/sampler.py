"""Batched token sampling: greedy / temperature / top-k / top-p per row."""
from __future__ import annotations

from typing import Optional

import torch


def sample_batched(logits: torch.Tensor, generator: torch.Generator,
                   temperature: torch.Tensor, top_k: torch.Tensor,
                   top_p: torch.Tensor,
                   stochastic: Optional[bool] = None) -> torch.Tensor:
    """logits [B, V] + per-row ``temperature``/``top_k``/``top_p`` [B]
    -> tokens [B] int32.

    temperature <= 0 is greedy: an exact argmax over the float32 logits
    (the first maximum, as ``jnp.argmax``), so greedy decode matches the
    JAX engine token for token.  top_k <= 0 and top_p >= 1 disable
    those filters.  Stochastic rows draw with ``generator`` (Gumbel-max
    over the filtered logits) — another stream than ``jax.random``, the
    same distribution.  ``stochastic=False`` (the caller knows no row
    samples) skips the sort and the draw."""
    lg32 = logits.float()
    greedy = lg32.argmax(dim=-1).to(torch.int32)
    if stochastic is None:
        stochastic = bool((temperature > 0).any())
    if not stochastic:
        return greedy
    B, V = lg32.shape
    lg = lg32 / temperature.clamp_min(1e-6)[:, None]
    # top-k: drop everything below the kth-largest (k = V disables)
    k = torch.where(top_k > 0, top_k, torch.full_like(top_k, V)).clamp(1, V)
    sorted_asc = lg.sort(dim=-1).values
    kth = sorted_asc.gather(1, (V - k).long()[:, None])
    lg = lg.masked_fill(lg < kth, float("-inf"))
    # top-p: drop everything below the nucleus cutoff
    sorted_lg = lg.sort(dim=-1, descending=True).values
    cum = torch.softmax(sorted_lg, dim=-1).cumsum(dim=-1)
    cutoff_idx = (cum < top_p[:, None]).sum(dim=-1).clamp(max=V - 1)
    cutoff = sorted_lg.gather(1, cutoff_idx[:, None])
    lg = lg.masked_fill(lg < cutoff, float("-inf"))
    u = torch.rand(lg.shape, generator=generator, device=lg.device)
    gumbel = -torch.log(-torch.log(u.clamp_min(1e-20)))
    sampled = (lg + gumbel).argmax(dim=-1).to(torch.int32)
    return torch.where(temperature <= 0, greedy, sampled)
