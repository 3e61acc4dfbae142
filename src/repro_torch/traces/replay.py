"""Trace replay evaluation (paper §V-E, Table V).

Feeds a block-access trace through the PredictiveCacheManager: every
access first registers the block (dedup makes repeat content a single
block), then performs the tiered lookup.  Hit rate is measured at tiers
0+1 ("GPU + CPU DRAM"), exactly the paper's Table V definition.

Capacity pressure: replay tier specs shrink tier 0/1 so the hot set
cannot hold the whole working set — this is where LRU / EMA / Bayesian
policies separate.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

from repro_torch.config import ModelConfig
from repro_torch.configs.paper_models import LLAMA3_70B
from repro_torch.core import sizing
from repro_torch.core.cache_manager import PredictiveCacheManager
from repro_torch.core.tiers import GB, PAPER_TIER_SPECS, TierSpec
from repro_torch.traces.generators import (GENERATORS, BlockAccess, TraceConfig)


def replay_tier_specs(cfg: ModelConfig, *, hot_blocks: int = 600,
                      t1_blocks: int = 900) -> tuple:
    """Scaled-down tier capacities (block counts) for replay pressure."""
    bb = sizing.block_bytes(cfg)
    base = PAPER_TIER_SPECS
    return (
        TierSpec(0, base[0].name, base[0].bandwidth, base[0].latency,
                 base[0].cost_per_gb_hour, hot_blocks * bb),
        TierSpec(1, base[1].name, base[1].bandwidth, base[1].latency,
                 base[1].cost_per_gb_hour, t1_blocks * bb),
        base[2], base[3], base[4], base[5],
    )


@dataclass
class ReplayResult:
    workload: str
    policy: str
    hit_rate: float
    accesses: int
    dedup_hits: int
    fetch_time: float
    recompute_time: float
    promotions: int
    demotions: int
    wall_s: float
    predictor_snapshot: Optional[dict] = None


def replay(trace: Sequence[BlockAccess], cfg: ModelConfig, *,
           policy: str = "bayesian", hot_blocks: int = 600,
           t1_blocks: Optional[int] = None,
           enable_multi_tier: bool = True,
           enable_dedup: bool = True,
           enable_prefetch: bool = True,
           enable_head_eviction: bool = True,
           workload: str = "?",
           predictor_kwargs: Optional[dict] = None,
           policy_kwargs: Optional[dict] = None) -> ReplayResult:
    mgr = PredictiveCacheManager(
        cfg, specs=replay_tier_specs(
            cfg, hot_blocks=hot_blocks,
            t1_blocks=t1_blocks if t1_blocks is not None else hot_blocks),
        policy=policy, enable_dedup=enable_dedup,
        enable_prefetch=enable_prefetch,
        enable_head_eviction=enable_head_eviction,
        enable_multi_tier=enable_multi_tier)
    if predictor_kwargs:
        from repro_torch.core.bayesian import BayesianReusePredictor
        mgr.predictor = BayesianReusePredictor(**predictor_kwargs)
    if policy_kwargs:
        from repro_torch.core.eviction import BayesianPolicy
        mgr.evictor = BayesianPolicy(mgr.head_tracker, **policy_kwargs)
    seen: Dict = {}
    t0 = time.time()
    prev_session_tool: Dict[str, str] = {}
    for i, ev in enumerate(trace):
        if ev.tool is not None:
            prev = prev_session_tool.get(ev.session)
            if prev != ev.tool:
                mgr.on_tool_switch(prev, ev.tool)
                prev_session_tool[ev.session] = ev.tool
        bid = seen.get(ev.content_id)
        if bid is None or bid not in mgr.metas:
            bid, _ = mgr.register_block(
                ev.content_id, block_type=ev.block_type,
                recompute_cost=0.02)
            seen[ev.content_id] = bid
            # first-touch registration is not a lookup: skip access
            mgr.tick(0.1)
            continue
        mgr.access(bid, transition=ev.transition)
        mgr.tick(0.1)
        if i % 512 == 0:
            mgr.age_all()
    st = mgr.stats
    return ReplayResult(
        workload=workload, policy=policy, hit_rate=st.hit_rate,
        accesses=st.accesses, dedup_hits=st.dedup_hits,
        fetch_time=st.fetch_time, recompute_time=st.recompute_time,
        promotions=st.promotions, demotions=st.demotions,
        wall_s=time.time() - t0,
        predictor_snapshot=mgr.predictor.snapshot())


# Per-workload replay capacity (tier-0 = tier-1 blocks): chosen so the
# reusable core exceeds the hot set (capacity pressure) — see DESIGN.md
# §Trace-calibration.  The paper does not publish its replay cache size.
REPLAY_HOT_BLOCKS = {"sharegpt": 150, "lmsys": 100, "agentic": 120}


def run_table_v(cfg: ModelConfig = LLAMA3_70B, *, n_sessions: int = 100,
                seeds: Sequence[int] = (0, 1, 2, 3, 4),
                policies: Sequence[str] = ("lru", "ema", "bayesian")
                ) -> List[dict]:
    """Paper Table V: {workloads} x {lru, ema, bayesian}, n-seed mean+std."""
    import numpy as np
    rows = []
    for wl, gen in GENERATORS.items():
        for policy in policies:
            rates = []
            for seed in seeds:
                trace = gen(TraceConfig(n_sessions=n_sessions, seed=seed))
                r = replay(trace, cfg, policy=policy, workload=wl,
                           hot_blocks=REPLAY_HOT_BLOCKS[wl])
                rates.append(r.hit_rate)
            rows.append({"workload": wl, "policy": policy,
                         "hit_mean": float(np.mean(rates)),
                         "hit_std": float(np.std(rates)),
                         "n_accesses": r.accesses})
    return rows
