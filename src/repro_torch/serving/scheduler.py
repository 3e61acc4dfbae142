"""Continuous-batching scheduler with sizing-engine admission, a
per-step token budget (Sarathi-style mixed batches), preemption and
straggler mitigation.

Admission control uses the paper's architecture-aware sizing engine
(§III-A): the decode slot count is B_s* = floor(M_target / (L * B(n_max)))
— an MLA model gets ~7x the slots of its MHA-equivalent sizing on the
same budget, which is where the paper's throughput claim comes from.

Each step's work is budget-selected (``plan_step``): every running
decode stream contributes one token, then prefill chunks from
``Phase.PREFILL`` requests (per-request chunk cursors) fill whatever is
left of ``max_step_tokens`` in admission order — decode is never
starved by a long prompt, and no step prefills more prompt tokens than
the budget allows.

Straggler mitigation: requests that exceed ``deadline_s`` *in their
current phase* are preempted (KV demoted to lower tiers) and re-queued
at the head; ``phase_start`` resets on every (re)admission, so a
preempted-then-readmitted request gets a fresh deadline instead of
instantly re-tripping it.  The cluster-level dispatcher
(launch/serve.py) additionally re-dispatches to a backup replica.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.config import ModelConfig
from repro_torch.core import sizing
from repro_torch.serving.request import Phase, Request


@dataclass
class SchedulerConfig:
    kv_budget_bytes: float = 1 << 30        # live-engine KV budget
    max_len: int = 512
    max_slots: int = 64
    deadline_s: float = 60.0
    status_quo_sizing: bool = False         # ablation: MHA-equivalent
    max_step_tokens: int = 256              # per-step token budget


class Scheduler:
    def __init__(self, cfg: ModelConfig, sched: SchedulerConfig):
        self.cfg = cfg
        self.sched = sched
        if sched.status_quo_sizing:
            n = sizing.status_quo_max_batch(cfg, sched.kv_budget_bytes,
                                            sched.max_len, tp=1)
        else:
            n = sizing.max_batch(cfg, sched.kv_budget_bytes, sched.max_len)
        self.n_slots = max(1, min(sched.max_slots, n))
        self.waiting: Deque[Request] = deque()
        self.running: Dict[int, Request] = {}
        self.preempted: Deque[Request] = deque()
        self.blocked: Dict[int, Request] = {}   # awaiting an async KV fetch
        self.done: List[Request] = []
        self.stragglers = 0
        self.transfer_events = 0
        self.async_restores = 0
        self._step_bufs: Optional[Dict[str, np.ndarray]] = None

    # ------------------------------------------------------------------
    def submit(self, req: Request) -> None:
        req.phase = Phase.WAITING
        req.phase_start = time.monotonic()
        self.waiting.append(req)

    def admissible(self, free_slots: int) -> List[Request]:
        """Next requests to admit (preempted ones first)."""
        out: List[Request] = []
        while free_slots > 0 and (self.preempted or self.waiting):
            q = self.preempted or self.waiting
            out.append(q.popleft())
            free_slots -= 1
        return out

    def start(self, req: Request, slot: int) -> None:
        req.phase = Phase.DECODE
        req.phase_start = time.monotonic()
        req.slot = slot
        self.running[req.request_id] = req

    def start_prefill(self, req: Request, slot: int) -> None:
        """Admit into the chunked-prefill phase: the request holds a
        slot and consumes budget via ``plan_step`` until its chunk
        cursor reaches the prompt end."""
        req.phase = Phase.PREFILL
        req.phase_start = time.monotonic()
        req.slot = slot
        self.running[req.request_id] = req

    def begin_decode(self, req: Request) -> None:
        """PREFILL -> DECODE transition (cursor reached the prompt end)."""
        req.phase = Phase.DECODE
        req.phase_start = time.monotonic()

    # ------------------------------------------------------------------
    # token-budget step planning (the mixed batch)
    # ------------------------------------------------------------------
    def plan_step(self) -> Tuple[List[Request], List[Tuple[Request, int]]]:
        """Select this step's work: (decode requests, prefill grants).

        Every ``Phase.DECODE`` request decodes one token — decode is
        never starved.  The remaining budget is granted to
        ``Phase.PREFILL`` requests in admission order as
        ``(request, n_tokens)`` pairs (the engine splits a grant into
        fixed-size kernel chunks).  Total per-step prompt tokens never
        exceed ``max_step_tokens``.
        """
        decode = [r for r in self.running.values()
                  if r.phase is Phase.DECODE]
        budget = self.sched.max_step_tokens - len(decode)
        grants: List[Tuple[Request, int]] = []
        for r in self.running.values():
            if r.phase is not Phase.PREFILL:
                continue
            if budget <= 0:
                break
            n = min(r.prefill_left, budget)
            if n > 0:
                grants.append((r, n))
                budget -= n
        return decode, grants

    def step_arrays(self, decode_reqs: List[Request],
                    n_slots: int) -> Dict[str, np.ndarray]:
        """Per-slot input tensors for the fused step closure — last
        token, active mask, and sampling params — pre-built host-side in
        ONE pass over the decode set.  The buffers are allocated once
        and reused every step (the closure's input shapes depend only on
        ``n_slots``, so the jit cache sees one signature)."""
        bufs = self._step_bufs
        if bufs is None or len(bufs["tokens"]) != n_slots:
            bufs = self._step_bufs = {
                "tokens": np.zeros((n_slots,), np.int32),
                "active": np.zeros((n_slots,), np.int32),
                "temperature": np.zeros((n_slots,), np.float32),
                "top_k": np.zeros((n_slots,), np.int32),
                "top_p": np.ones((n_slots,), np.float32),
            }
        bufs["tokens"][:] = 0
        bufs["active"][:] = 0
        bufs["temperature"][:] = 0.0
        bufs["top_k"][:] = 0
        bufs["top_p"][:] = 1.0
        for r in decode_reqs:
            s = r.slot
            bufs["tokens"][s] = (r.generated[-1] if r.generated
                                 else r.prompt[-1])
            bufs["active"][s] = 1
            bufs["temperature"][s] = r.params.temperature
            bufs["top_k"][s] = r.params.top_k
            bufs["top_p"][s] = r.params.top_p
        return bufs

    def finish(self, req: Request) -> None:
        req.phase = Phase.DONE
        req.t_done = time.monotonic()
        self.running.pop(req.request_id, None)
        self.done.append(req)

    def preempt(self, req: Request) -> None:
        req.phase = Phase.PREEMPTED
        req.phase_start = time.monotonic()
        self.running.pop(req.request_id, None)
        self.preempted.appendleft(req)

    # ------------------------------------------------------------------
    # async tier transfers (core/tiers.AsyncTierTransferWorker)
    # ------------------------------------------------------------------
    def poll_transfers(self, worker) -> list:
        """Drain the transfer worker's completion events (the engine
        interprets them; the scheduler only accounts and unblocks)."""
        if worker is None:
            return []
        events = worker.poll()
        self.transfer_events += len(events)
        return events

    def block_on_transfer(self, req: Request) -> None:
        """Park a request until its KV fetch from a lower tier lands."""
        req.phase = Phase.RESTORING
        self.blocked[req.request_id] = req
        self.async_restores += 1

    def on_transfer_complete(self, request_id: int) -> Optional[Request]:
        """Un-park a request whose restore fetch completed; it re-enters
        the admission queue at the head."""
        req = self.blocked.pop(request_id, None)
        if req is not None:
            req.phase = Phase.PREEMPTED
            self.preempted.appendleft(req)
        return req

    def check_stragglers(self, now: Optional[float] = None) -> List[Request]:
        """Requests over their deadline *in the current phase* ->
        candidates for preempt + re-dispatch.  Measured from
        ``phase_start`` (reset on every (re)admission), not ``arrival``
        — otherwise a preempted-then-readmitted request instantly
        exceeds the deadline again and livelocks."""
        now = time.monotonic() if now is None else now
        out = [r for r in self.running.values()
               if now - r.phase_start > self.sched.deadline_s]
        self.stragglers += len(out)
        return out

    def drain_requests(self) -> List[Request]:
        """Remove and return every live request — waiting, running,
        preempted AND transfer-blocked — in a deterministic order
        (failover requeue hook for the cluster dispatcher; finished
        requests stay in ``done``)."""
        out: List[Request] = list(self.waiting)
        out.extend(self.running[rid] for rid in sorted(self.running))
        out.extend(self.preempted)
        out.extend(self.blocked[rid] for rid in sorted(self.blocked))
        self.waiting.clear()
        self.running.clear()
        self.preempted.clear()
        self.blocked.clear()
        return out

    def has_work(self) -> bool:
        return bool(self.waiting or self.running or self.preempted
                    or self.blocked)

    def live_count(self) -> int:
        """Live (unfinished) requests across every queue — the load
        signal for least-loaded routing and failover victim choice."""
        return (len(self.waiting) + len(self.running)
                + len(self.preempted) + len(self.blocked))

    def session_stats(self) -> Dict[str, dict]:
        """Per-session rollup over finished requests (the trace replay's
        multi-turn sessions map one request per turn)."""
        out: Dict[str, dict] = {}
        for r in self.done:
            sid = r.session_id or f"req{r.request_id}"
            s = out.setdefault(sid, {"turns": 0, "prefix_hit_blocks": 0,
                                     "generated_tokens": 0,
                                     "prompt_tokens": 0})
            s["turns"] += 1
            s["prefix_hit_blocks"] += r.prefix_hit_blocks
            s["generated_tokens"] += len(r.generated)
            s["prompt_tokens"] += r.prompt_len
        return out

    def stats(self) -> dict:
        ttfts = sorted(r.ttft for r in self.done if r.ttft is not None)

        def pct(p):
            if not ttfts:
                return 0.0
            return ttfts[min(len(ttfts) - 1, int(p * len(ttfts)))]

        total_tokens = sum(len(r.generated) for r in self.done)
        return {"done": len(self.done), "slots": self.n_slots,
                "ttft_p50": pct(0.50), "ttft_p99": pct(0.99),
                "generated_tokens": total_tokens,
                "stragglers": self.stragglers,
                "transfer_events": self.transfer_events,
                "async_restores": self.async_restores,
                "prefix_hit_blocks": sum(r.prefix_hit_blocks
                                         for r in self.done),
                "hot_hit_blocks": sum(r.hot_hit_blocks for r in self.done)}
