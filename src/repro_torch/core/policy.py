"""Latency-aware tier placement policy (paper §III-B, last paragraph).

Each block gets a *value score* balancing the cost of recomputation
against the cost of storage at each tier.  For candidate tier t the
expected cost of placing block b there is

    C(b, t) = P_reuse(b) * fetch_time(t, bytes_b)          # latency cost
            + (1 - P_reuse(b)) * 0                          # never fetched
            + lam_cost * cost_rate(t) * bytes_b             # $ cost
    fetch beats recompute only if fetch_time < recompute_cost, else the
    block is not worth keeping below the recompute-equivalent tier.

The placement target is argmin_t C(b, t) over tiers with free capacity —
frequently-reused, compute-expensive blocks land in fast tiers; rarely
accessed blocks migrate toward cheap storage; blocks whose recompute is
cheaper than any fetch are simply dropped.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

from repro_torch.core.eviction import BlockMeta
from repro_torch.core.tiers import TierHierarchy


@dataclass
class PlacementDecision:
    tier: Optional[int]              # None -> drop (recompute on demand)
    expected_cost: float
    value_score: float


class PlacementPolicy:
    def __init__(self, hierarchy: TierHierarchy, *,
                 cost_weight: float = 1e-10,
                 promote_margin: float = 0.8):
        self.hierarchy = hierarchy
        self.cost_weight = cost_weight
        # a move must cut expected cost by this factor to be worth issuing
        self.promote_margin = promote_margin

    # ------------------------------------------------------------------
    def value_score(self, meta: BlockMeta) -> float:
        """Seconds of recompute expected to be saved by keeping the block."""
        return meta.reuse_prob * meta.recompute_cost

    def expected_cost(self, meta: BlockMeta, tier_id: int) -> float:
        spec = self.hierarchy[tier_id].spec
        fetch = spec.transfer_time(meta.nbytes)
        latency_cost = meta.reuse_prob * min(fetch, meta.recompute_cost)
        dollar_cost = self.cost_weight * spec.cost_per_gb_hour * meta.nbytes
        return latency_cost + dollar_cost

    def target_tier(self, meta: BlockMeta) -> PlacementDecision:
        best_tier, best_cost = None, meta.reuse_prob * meta.recompute_cost
        # cost of NOT caching at all = P_reuse * recompute
        for t in self.hierarchy.active_tiers():
            if t.free < meta.nbytes and not t.contains(meta.block_id):
                continue
            c = self.expected_cost(meta, t.spec.tier_id)
            if c < best_cost:
                best_tier, best_cost = t.spec.tier_id, c
        return PlacementDecision(best_tier, best_cost, self.value_score(meta))

    # ------------------------------------------------------------------
    def should_promote(self, meta: BlockMeta, current_tier: int) -> Optional[int]:
        """Async promotion check: returns a faster target tier or None."""
        decision = self.target_tier(meta)
        if decision.tier is None or decision.tier >= current_tier:
            return None
        cur = self.expected_cost(meta, current_tier)
        if decision.expected_cost <= self.promote_margin * cur:
            return decision.tier
        return None

    def demotion_order(self, metas: Sequence[BlockMeta]) -> List[BlockMeta]:
        """Lowest value first — these cascade to cheaper tiers."""
        return sorted(metas, key=self.value_score)
