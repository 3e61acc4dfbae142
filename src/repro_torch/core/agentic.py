"""Agentic task-transition prediction (paper §III-G).

A first-order Markov chain over tool invocations tracks
P(tool_j | tool_i) from observed sequences, combined with per-tool KV
cache size profiles (EMA-smoothed mean / variance / peak).  On a detected
tool switch the serving engine:

  1. pre-allocates KV capacity for the predicted next tool,
  2. adjusts head-granular importance multipliers for the transition,
  3. prefetches the predicted tool's context blocks from lower tiers.

Sessions are classified into memory-demand tiers (Light / Medium / Heavy /
Extreme) from aggregate features for proactive capacity planning.
"""
from __future__ import annotations

import math
import threading
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

SESSION_CLASSES = ("light", "medium", "heavy", "extreme")


@dataclass
class ToolProfile:
    """EMA-smoothed KV-cache memory profile of one tool."""
    mean: float = 0.0
    var: float = 0.0
    peak: float = 0.0
    count: int = 0
    _decay: float = 0.8

    def observe(self, nbytes: float) -> None:
        if self.count == 0:
            self.mean = nbytes
        else:
            d = self._decay
            delta = nbytes - self.mean
            self.mean = d * self.mean + (1 - d) * nbytes
            self.var = d * self.var + (1 - d) * delta * delta
        self.peak = max(self.peak, nbytes)
        self.count += 1

    @property
    def std(self) -> float:
        return math.sqrt(max(0.0, self.var))


class MarkovToolPredictor:
    """First-order Markov chain over tool invocations."""

    def __init__(self, smoothing: float = 0.5):
        self.smoothing = smoothing
        self._counts: Dict[str, Dict[str, float]] = defaultdict(
            lambda: defaultdict(float))
        self._tools: set = set()
        self.profiles: Dict[str, ToolProfile] = defaultdict(ToolProfile)
        self._lock = threading.RLock()

    def observe_transition(self, prev_tool: Optional[str], tool: str,
                           kv_bytes: float = 0.0) -> None:
        with self._lock:
            self._tools.add(tool)
            if prev_tool is not None:
                self._tools.add(prev_tool)
                self._counts[prev_tool][tool] += 1.0
            if kv_bytes > 0:
                self.profiles[tool].observe(kv_bytes)

    def transition_probs(self, tool: str) -> Dict[str, float]:
        """Laplace-smoothed P(next | tool); sums to 1 over known tools."""
        with self._lock:
            tools = sorted(self._tools)
            if not tools:
                return {}
            row = self._counts.get(tool, {})
            s = self.smoothing
            denom = sum(row.values()) + s * len(tools)
            return {t: (row.get(t, 0.0) + s) / denom for t in tools}

    def predict_next(self, tool: str, k: int = 1) -> List[Tuple[str, float]]:
        probs = self.transition_probs(tool)
        return sorted(probs.items(), key=lambda kv: -kv[1])[:k]

    def predicted_memory_demand(self, tool: str) -> float:
        """Expected KV bytes of the most likely next tool (mean + 1 std,
        the pre-allocation target of §III-G step 1)."""
        nxt = self.predict_next(tool, k=1)
        if not nxt:
            return 0.0
        t, p = nxt[0]
        prof = self.profiles.get(t)
        if prof is None or prof.count == 0:
            return 0.0
        return p * (prof.mean + prof.std)

    def transition_type(self, prev_tool: Optional[str], tool: str) -> str:
        """Map a raw tool transition onto the predictor's 4 categories."""
        if prev_tool is None:
            return "reasoning_step"
        if prev_tool == tool:
            return "same_tool_repeat"
        if tool.startswith("agent:") or prev_tool.startswith("agent:"):
            return "agent_handoff"
        return "tool_switch"


# ---------------------------------------------------------------------------
# Session memory-demand classification (paper §III-G last paragraph)
# ---------------------------------------------------------------------------
@dataclass
class SessionFeatures:
    total_tokens: int = 0
    n_tool_calls: int = 0
    distinct_tools: int = 0
    peak_kv_bytes: float = 0.0


def classify_session(f: SessionFeatures,
                     *, gb: float = 1024 ** 3) -> str:
    score = 0
    if f.total_tokens > 8_192 or f.peak_kv_bytes > 2 * gb:
        score += 1
    if f.total_tokens > 32_768 or f.peak_kv_bytes > 8 * gb:
        score += 1
    if f.n_tool_calls > 10 or f.distinct_tools > 5 \
            or f.peak_kv_bytes > 32 * gb or f.total_tokens > 131_072:
        score += 1
    return SESSION_CLASSES[score]
