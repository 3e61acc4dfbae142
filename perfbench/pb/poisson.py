"""Open-loop Poisson arrival times: a frozen copy of the arithmetic of
``PoissonLoadGen`` in ``repro_torch/traces/loadgen.py`` (exponential
gaps of mean 1/rate from a seeded numpy ``Generator``), kept here so
that a change to the program cannot move the yardstick."""
from __future__ import annotations

from typing import List, Optional

import numpy as np


class PoissonArrivals:
    def __init__(self, rate: float, *, seed: int = 0, rng=None):
        if rate <= 0:
            raise ValueError(f"rate must be > 0, got {rate}")
        self.rate = float(rate)
        self.rng = np.random.default_rng(seed) if rng is None else rng

    def interarrivals(self, n: int) -> np.ndarray:
        """n exponential gaps with mean 1/rate (seconds)."""
        return self.rng.exponential(1.0 / self.rate, size=n)

    def arrival_times(self, *, n: Optional[int] = None,
                      duration_s: Optional[float] = None) -> List[float]:
        """Monotone arrival times: exactly ``n``, or every arrival
        before ``duration_s``."""
        if (n is None) == (duration_s is None):
            raise ValueError("pass exactly one of n / duration_s")
        if n is not None:
            return [float(t) for t in np.cumsum(self.interarrivals(n))]
        out: List[float] = []
        t = 0.0
        while True:
            t += float(self.rng.exponential(1.0 / self.rate))
            if t >= duration_s:
                return out
            out.append(t)
