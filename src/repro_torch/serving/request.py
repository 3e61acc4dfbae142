"""Request / session types for the serving engine."""
from __future__ import annotations

import itertools
import time
from dataclasses import dataclass, field
from enum import Enum
from typing import List, Optional, Sequence

_ids = itertools.count()


class Phase(Enum):
    WAITING = "waiting"
    PREFILL = "prefill"
    DECODE = "decode"
    PREEMPTED = "preempted"
    RESTORING = "restoring"        # KV fetch from a lower tier in flight
    DONE = "done"


@dataclass
class SamplingParams:
    max_new_tokens: int = 32
    temperature: float = 0.0          # 0 -> greedy
    top_k: int = 0
    top_p: float = 1.0
    stop_token: Optional[int] = None


@dataclass
class Request:
    prompt: Sequence[int]
    params: SamplingParams = field(default_factory=SamplingParams)
    session_id: Optional[str] = None
    block_type: str = "user_context"   # semantic role of the prompt blocks
    block_types: Optional[List[str]] = None   # per-block roles (index =
    #                                    prompt block number; overrides
    #                                    block_type where present)
    tool: Optional[str] = None         # agentic workloads: invoked tool
    retain_blocks: bool = False        # keep prompt blocks registered after
    #                                    finish (session continuation: the
    #                                    next turn resubmits this prefix)
    request_id: int = field(default_factory=lambda: next(_ids))
    arrival: float = field(default_factory=time.monotonic)

    # runtime state
    phase: Phase = Phase.WAITING
    phase_start: float = field(default_factory=time.monotonic)
    generated: List[int] = field(default_factory=list)
    slot: int = -1                     # decode batch slot
    block_ids: List[str] = field(default_factory=list)
    prefix_hit_blocks: int = 0         # radix-matched blocks (skipped prefill)
    hot_hit_blocks: int = 0            # ... of those, resident in tiers 0-1
    #                                    at access time (paper Table V hit)
    shared_hit_blocks: int = 0         # blocks imported from the fleet-shared
    #                                    tier (another replica's content; a
    #                                    tier-4 fetch, NOT a hot hit)
    segment_hit_blocks: int = 0        # blocks resumed mid-prompt via the
    #                                    content-segment index (beyond the
    #                                    contiguous radix prefix)
    seg_spans: List[tuple] = field(default_factory=list)
    #                                  # resumed (start_block, n_blocks)
    #                                    spans, ascending, for the gap-wise
    #                                    segment prefill path
    # chunked prefill: tokens to prefill (prompt [+ generated] minus the
    # final token) and the per-request chunk cursor into them
    prefill_tokens: Optional[List[int]] = None
    prefill_pos: int = 0
    t_first_token: Optional[float] = None
    t_done: Optional[float] = None

    @property
    def prompt_len(self) -> int:
        return len(self.prompt)

    @property
    def total_len(self) -> int:
        return len(self.prompt) + len(self.generated)

    @property
    def prefill_left(self) -> int:
        """Prompt tokens still to prefill (0 outside the chunked path)."""
        if self.prefill_tokens is None:
            return 0
        return max(0, len(self.prefill_tokens) - self.prefill_pos)

    @property
    def ttft(self) -> Optional[float]:
        if self.t_first_token is None:
            return None
        return self.t_first_token - self.arrival

    def reset_for_redispatch(self) -> None:
        """Wipe per-engine runtime state before re-dispatching to a
        different replica (failover): the slot, block ids, chunk cursor
        and prefix/hot hit accounting all referred to the dead engine's
        pool and cache manager, and the generated tokens' KV died with
        it — the successor re-prefills the prompt from scratch."""
        self.phase = Phase.WAITING
        self.phase_start = time.monotonic()
        self.generated.clear()
        self.slot = -1
        self.block_ids = []
        self.prefix_hit_blocks = 0
        self.hot_hit_blocks = 0
        self.shared_hit_blocks = 0
        self.segment_hit_blocks = 0
        self.seg_spans = []
        self.prefill_tokens = None
        self.prefill_pos = 0
        self.t_first_token = None
        self.t_done = None

    def finished(self) -> bool:
        p = self.params
        if len(self.generated) >= p.max_new_tokens:
            return True
        return (p.stop_token is not None and self.generated
                and self.generated[-1] == p.stop_token)
