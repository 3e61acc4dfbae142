"""Head-granular eviction with EMA importance (paper §III-D).

Maintains a [layer][head] importance matrix updated every attention step
with an exponential moving average that folds in recency and positional-
distance decay.  Architecture handling:

  * GQA — query heads sharing a KV head are grouped; the KV head's score
    is the max over its group.
  * MLA — the matrix collapses to [layer][1] (latent KV shared by heads).
  * MHA — uniform weights; MQA — single KV head.

Eviction picks the block with the lowest weighted aggregate importance.
During agentic task transitions, per-head multipliers bias eviction toward
heads less relevant for the incoming task (§III-G step 2).
"""
from __future__ import annotations

import math
import threading
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.config import GQA, MHA, MLA, MQA, ModelConfig


class HeadImportanceTracker:
    """EMA-scored per-(layer, head) importance matrix."""

    def __init__(self, cfg: ModelConfig, *, ema_decay: float = 0.6,
                 position_decay: float = 1e-4):
        self.cfg = cfg
        self.ema_decay = float(ema_decay)
        self.position_decay = float(position_decay)
        variant = cfg.attention_variant
        if variant == MLA:
            self.n_tracked = 1                      # latent bottleneck
        elif variant in (GQA, MQA, MHA):
            self.n_tracked = max(1, cfg.n_kv_heads)
        else:
            self.n_tracked = 1                      # recurrent archs
        n_layers = max(1, cfg.n_layers)
        self.matrix = np.full((n_layers, self.n_tracked), 0.5, dtype=np.float64)
        self.multipliers = np.ones_like(self.matrix)
        self._lock = threading.RLock()

    # ------------------------------------------------------------------
    def _fold_groups(self, per_q_head: np.ndarray) -> np.ndarray:
        """Map per-query-head scores onto tracked KV heads (max over the
        GQA group, paper §III-D)."""
        cfg = self.cfg
        if self.n_tracked == 1:
            return per_q_head.max(axis=-1, keepdims=True)
        g = cfg.q_group
        h_kv = cfg.n_kv_heads
        trimmed = per_q_head[..., :g * h_kv].reshape(*per_q_head.shape[:-1],
                                                     h_kv, g)
        return trimmed.max(axis=-1)

    def update(self, layer: int, attn_mass: np.ndarray,
               query_pos: Optional[int] = None,
               key_pos: Optional[np.ndarray] = None) -> None:
        """attn_mass: per-query-head attention mass [n_heads] for this step
        (e.g. sum of attention probabilities onto the tracked block).
        Positional-distance decay discounts mass on far-away keys."""
        mass = np.asarray(attn_mass, dtype=np.float64)
        if query_pos is not None and key_pos is not None:
            dist = abs(float(query_pos) - float(np.mean(key_pos)))
            mass = mass * math.exp(-self.position_decay * dist)
        folded = self._fold_groups(mass)
        a = self.ema_decay
        with self._lock:
            self.matrix[layer] = a * self.matrix[layer] + (1.0 - a) * folded

    def bulk_update(self, attn_mass: np.ndarray) -> None:
        """attn_mass [n_layers, n_heads] — one EMA step for all layers."""
        folded = self._fold_groups(np.asarray(attn_mass, dtype=np.float64))
        a = self.ema_decay
        with self._lock:
            self.matrix = a * self.matrix + (1.0 - a) * folded

    # ------------------------------------------------------------------
    def head_weights(self) -> np.ndarray:
        """Architecture-dependent aggregation weights (paper: uniform for
        MHA, proportional to group size for GQA)."""
        v = self.cfg.attention_variant
        if v == GQA:
            w = np.full(self.n_tracked, float(self.cfg.q_group))
        else:
            w = np.ones(self.n_tracked)
        return w / w.sum()

    def block_score(self, layers: Optional[Iterable[int]] = None) -> float:
        """Weighted aggregate importance (with task-transition multipliers)."""
        with self._lock:
            m = self.matrix * self.multipliers
        if layers is not None:
            idx = list(layers)
            m = m[idx] if idx else m
        return float((m * self.head_weights()[None, :]).mean(axis=0).sum())

    def set_transition_multipliers(self, mult: np.ndarray) -> None:
        with self._lock:
            self.multipliers = np.broadcast_to(
                np.asarray(mult, dtype=np.float64), self.matrix.shape).copy()

    def reset_multipliers(self) -> None:
        with self._lock:
            self.multipliers = np.ones_like(self.matrix)


# ---------------------------------------------------------------------------
# Block-level eviction policies (used by trace replay + live engine)
# ---------------------------------------------------------------------------
@dataclass
class BlockMeta:
    block_id: str
    nbytes: float
    block_type: str = "user_context"
    last_access: float = 0.0
    access_count: int = 0
    ema_score: float = 0.5
    reuse_prob: float = 0.5
    pinned: bool = False
    positions: Tuple[int, int] = (0, 0)      # token position range
    recompute_cost: float = 1.0              # seconds to regenerate


class EvictionPolicy:
    name = "base"

    def score(self, meta: BlockMeta, now: float) -> float:
        """Lower score evicts first."""
        raise NotImplementedError

    def select_victim(self, metas: Iterable[BlockMeta], now: float
                      ) -> Optional[BlockMeta]:
        best, best_s = None, math.inf
        for m in metas:
            if m.pinned:
                continue
            s = self.score(m, now)
            if s < best_s:
                best, best_s = m, s
        return best

    def select_victims(self, metas: Iterable[BlockMeta], now: float,
                       k: int) -> List[BlockMeta]:
        """k lowest-scoring victims in one scan (amortized eviction)."""
        import heapq
        scored = [(self.score(m, now), i, m)
                  for i, m in enumerate(metas) if not m.pinned]
        return [m for _, _, m in heapq.nsmallest(k, scored)]


class LRUPolicy(EvictionPolicy):
    """Reactive baseline (paper Problem 3)."""
    name = "lru"

    def score(self, meta: BlockMeta, now: float) -> float:
        return meta.last_access


class EMAPolicy(EvictionPolicy):
    """Pattern-aware baseline: recency-decayed access frequency."""
    name = "ema"

    def __init__(self, decay: float = 0.6):
        self.decay = decay

    def touch(self, meta: BlockMeta) -> None:
        meta.ema_score = self.decay * meta.ema_score + (1 - self.decay)

    def age(self, meta: BlockMeta) -> None:
        meta.ema_score = self.decay * meta.ema_score

    def score(self, meta: BlockMeta, now: float) -> float:
        return meta.ema_score


class BayesianPolicy(EMAPolicy):
    """The paper's predictive eviction: approximate Belady ordering using
    the Bayesian reuse posterior (§III-C) as a predicted-reuse-distance
    bonus on top of exact recency.

        score = last_access + horizon * P_reuse(type, transition)
              + horizon * w_r * tanh(recompute_cost)
              + horizon * w_h * head_importance

    A system-prompt block (P ~ 0.95) effectively stays "recent" for an
    extra ~horizon of virtual time after its last access; scratch
    reasoning (P ~ 0) degenerates to plain LRU and is evicted first.
    Blocks are evicted in ascending score order (lowest = evict first).
    """
    name = "bayesian"

    def __init__(self, head_tracker: Optional[HeadImportanceTracker] = None,
                 recompute_weight: float = 0.1, head_weight: float = 0.05,
                 horizon: float = 100.0, decay: float = 0.6):
        super().__init__(decay=decay)
        self.head_tracker = head_tracker
        self.recompute_weight = recompute_weight
        self.head_weight = head_weight
        self.horizon = horizon
        self._head_cache = (None, 0.0)     # (clock, score)

    def _head_score(self, now: float) -> float:
        if self.head_tracker is None:
            return 0.0
        if self._head_cache[0] != now:     # refresh once per clock tick
            self._head_cache = (now, self.head_tracker.block_score())
        return self._head_cache[1]

    def score(self, meta: BlockMeta, now: float) -> float:
        s = meta.last_access + self.horizon * meta.reuse_prob
        s += self.horizon * self.recompute_weight * \
            math.tanh(meta.recompute_cost)
        s += self.horizon * self.head_weight * self._head_score(now)
        return s


POLICIES = {"lru": LRUPolicy, "ema": EMAPolicy, "bayesian": BayesianPolicy}
