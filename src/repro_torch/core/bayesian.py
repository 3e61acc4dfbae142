"""Bayesian reuse prediction with Beta conjugate priors (paper §III-C).

Reuse probability is modelled per (block-type, transition-type) pair —
|B| x |T| = 16 pairs, each with an independent Beta(alpha, beta) posterior
initialized from a weakly-informative Beta(1, 1) prior.  Posterior updates
are O(1): a reuse event increments alpha, a miss increments beta.

The final estimate blends the posterior mean with an empirical frequency
over a sliding window of recent observations, weighted by a confidence
score that saturates toward 1 as observations accumulate:

    confidence(n) = n / (n + k)                     (saturation constant k)
    P = confidence * posterior_mean + (1 - confidence) * empirical

Well-observed pairs therefore rely on the posterior; newly-created pairs
lean on the recent empirical window, giving rapid adaptation to
distribution shift (paper: "a new tool entering the agentic workflow").
"""
from __future__ import annotations

import threading
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, Iterable, Tuple

# Paper §III-C: the two categorical variables.
BLOCK_TYPES = ("system_prompt", "tool_context", "user_context",
               "intermediate_reasoning")
TRANSITION_TYPES = ("same_tool_repeat", "tool_switch", "reasoning_step",
                    "agent_handoff")

Pair = Tuple[str, str]


@dataclass
class BetaPosterior:
    alpha: float = 1.0               # weakly informative prior
    beta: float = 1.0

    @property
    def mean(self) -> float:
        return self.alpha / (self.alpha + self.beta)

    @property
    def observations(self) -> float:
        return self.alpha + self.beta - 2.0   # excludes the prior mass

    def update(self, reused: bool) -> None:
        if reused:
            self.alpha += 1.0
        else:
            self.beta += 1.0

    def variance(self) -> float:
        a, b = self.alpha, self.beta
        return (a * b) / ((a + b) ** 2 * (a + b + 1.0))


class BayesianReusePredictor:
    """Online reuse-probability estimator over 16 (block, transition) pairs.

    Thread-safe: serving threads observe events while the placement policy
    reads estimates concurrently (paper §IV Concurrency).
    """

    def __init__(self, *, prior_alpha: float = 1.0, prior_beta: float = 1.0,
                 confidence_k: float = 20.0, window: int = 256,
                 block_types: Iterable[str] = BLOCK_TYPES,
                 transition_types: Iterable[str] = TRANSITION_TYPES):
        self.block_types = tuple(block_types)
        self.transition_types = tuple(transition_types)
        self.confidence_k = float(confidence_k)
        self.window = int(window)
        self._lock = threading.RLock()
        self._post: Dict[Pair, BetaPosterior] = {}
        self._recent: Dict[Pair, Deque[bool]] = {}
        for b in self.block_types:
            for t in self.transition_types:
                self._post[(b, t)] = BetaPosterior(prior_alpha, prior_beta)
                self._recent[(b, t)] = deque(maxlen=self.window)

    # -- queries ----------------------------------------------------------
    def _key(self, block_type: str, transition: str) -> Pair:
        if block_type not in self.block_types:
            block_type = "user_context"
        if transition not in self.transition_types:
            transition = "reasoning_step"
        return (block_type, transition)

    def posterior_mean(self, block_type: str, transition: str) -> float:
        with self._lock:
            return self._post[self._key(block_type, transition)].mean

    def confidence(self, block_type: str, transition: str) -> float:
        """Saturates toward 1 with observation count: n / (n + k)."""
        with self._lock:
            n = self._post[self._key(block_type, transition)].observations
        return n / (n + self.confidence_k)

    def empirical(self, block_type: str, transition: str) -> float:
        with self._lock:
            buf = self._recent[self._key(block_type, transition)]
            if not buf:
                return 0.5
            return sum(buf) / len(buf)

    def reuse_probability(self, block_type: str, transition: str) -> float:
        """Confidence-blended estimate (paper §III-C, final paragraph)."""
        key = self._key(block_type, transition)
        with self._lock:
            post = self._post[key]
            buf = self._recent[key]
            n = post.observations
            c = n / (n + self.confidence_k)
            emp = (sum(buf) / len(buf)) if buf else post.mean
            return c * post.mean + (1.0 - c) * emp

    # -- updates ----------------------------------------------------------
    def observe(self, block_type: str, transition: str, reused: bool) -> None:
        key = self._key(block_type, transition)
        with self._lock:
            self._post[key].update(reused)
            self._recent[key].append(bool(reused))

    # -- introspection / metrics ------------------------------------------
    def snapshot(self) -> Dict[str, Dict[str, float]]:
        out: Dict[str, Dict[str, float]] = {}
        with self._lock:
            for (b, t), post in self._post.items():
                out[f"{b}|{t}"] = {
                    "alpha": post.alpha, "beta": post.beta,
                    "mean": post.mean, "obs": post.observations,
                    "confidence": post.observations /
                                  (post.observations + self.confidence_k),
                }
        return out

    def state_dict(self) -> dict:
        with self._lock:
            return {f"{b}|{t}": (p.alpha, p.beta)
                    for (b, t), p in self._post.items()}

    def load_state_dict(self, state: dict) -> None:
        with self._lock:
            for k, (a, bb) in state.items():
                b, t = k.split("|")
                self._post[(b, t)] = BetaPosterior(a, bb)


class ThompsonSampler:
    """Thompson-sampling placement exploration over the Beta posteriors
    (the paper cites Thompson 1933 for exactly this machinery): instead
    of the posterior mean, draw P_reuse ~ Beta(alpha, beta) — uncertain
    pairs occasionally win fast-tier placement, generating the
    observations that collapse their posteriors.  Used by the placement
    policy when exploration is enabled."""

    def __init__(self, predictor: BayesianReusePredictor, seed: int = 0):
        import random
        self.predictor = predictor
        self._rng = random.Random(seed)

    def sample_reuse(self, block_type: str, transition: str) -> float:
        key = self.predictor._key(block_type, transition)
        with self.predictor._lock:
            post = self.predictor._post[key]
            a, b = post.alpha, post.beta
        return self._rng.betavariate(a, b)
