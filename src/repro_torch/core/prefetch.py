"""RoPE-aware prefetching (paper §III-E).

RoPE's rotational structure makes attention weights decay smoothly with
positional distance, so during decode at position n the blocks covering
positions [n, n + w] are the most likely next accesses.  The window w
adapts per layer: narrow for local-attention (early) layers, wide for
global-attention (late) layers, and grows/shrinks with the observed hit
rate of previous prefetches.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple


@dataclass
class PrefetchRequest:
    block_id: str
    target_tier: int
    reason: str = "rope_window"


class RoPEPrefetcher:
    def __init__(self, block_tokens: int, n_layers: int,
                 *, base_window: int = 512, min_window: int = 128,
                 max_window: int = 4096, adapt_rate: float = 0.1):
        self.block_tokens = block_tokens
        self.n_layers = max(1, n_layers)
        self.base_window = base_window
        self.min_window = min_window
        self.max_window = max_window
        self.adapt_rate = adapt_rate
        self._window = float(base_window)
        self._lock = threading.RLock()
        self.issued = 0
        self.useful = 0

    # ------------------------------------------------------------------
    def layer_window(self, layer: int) -> int:
        """Early layers attend locally, late layers globally — scale the
        dynamic window linearly from 0.5x to 1.5x across depth."""
        frac = 0.5 + (layer / max(1, self.n_layers - 1))
        return int(max(self.min_window, min(self.max_window,
                                            self._window * frac)))

    @property
    def window(self) -> int:
        return int(self._window)

    def plan(self, seq_blocks: Sequence[str], position: int,
             resident: Callable[[str], bool], *, layer: Optional[int] = None,
             target_tier: int = 0) -> List[PrefetchRequest]:
        """Blocks covering positions [position, position + w] that are not
        already resident in the target tier -> async promotion requests."""
        w = self.layer_window(layer) if layer is not None else int(self._window)
        bt = self.block_tokens
        first = position // bt
        last = (position + w) // bt
        out: List[PrefetchRequest] = []
        for bi in range(first, min(last + 1, len(seq_blocks))):
            bid = seq_blocks[bi]
            if not resident(bid):
                out.append(PrefetchRequest(bid, target_tier))
        with self._lock:
            self.issued += len(out)
        return out

    # ------------------------------------------------------------------
    def feedback(self, was_useful: bool) -> None:
        """Adapt the window: widen when prefetches hit, narrow when they
        waste bandwidth."""
        with self._lock:
            if was_useful:
                self.useful += 1
                self._window = min(self.max_window,
                                   self._window * (1.0 + self.adapt_rate))
            else:
                self._window = max(self.min_window,
                                   self._window * (1.0 - self.adapt_rate))

    def stats(self) -> dict:
        with self._lock:
            return {"window": int(self._window), "issued": self.issued,
                    "useful": self.useful,
                    "accuracy": self.useful / self.issued if self.issued else 0.0}
