"""Wall-clock serving front-end: concurrent submission, streaming
per-token callbacks, and SLO-aware admission control around a
``ServingEngine`` or ``ReplicaCluster``.

Every number before this module came from a *virtual* clock — the
replay harness validates hit rates and TTFT deltas, but the paper's
headline claims (sub-millisecond TTFT for hot entries, 1.7–2.9x
throughput under load) are claims about a real-time system with
concurrent arrivals.  The front-end is that layer:

  * **submission** is thread-safe and non-blocking: ``submit`` drops a
    ``StreamHandle`` into an inbox and returns immediately; the pump
    loop (a background thread via ``start()``, or the caller's thread
    via ``run_for``/``serve_schedule``) drains it each iteration;
  * **streaming**: after each engine step the pump delivers newly
    generated tokens to each handle's ``on_token(token, index)``
    callback — exactly once per token, in token order — and fires
    ``on_done(handle)`` exactly once when the request completes (or is
    shed);
  * **SLO-aware admission**: each arrival's TTFT is *projected* from
    observable state (prefill backlog, decode occupancy, an EWMA of the
    measured step time); when the projection breaches the configured
    budget the request is queued (bounded) or shed, so the p99 TTFT of
    what the server *accepts* stays under the budget instead of growing
    without bound under open-loop overload.  Goodput / shed accounting
    lives in ``stats()``.

Designed for testability first — wall-clock concurrency is where flaky
tests are born, so every source of nondeterminism is injectable:

  * the **clock** is a parameter (any object with ``monotonic()`` /
    ``sleep(dt)``; the ``time`` module is the default, ``VirtualClock``
    is the deterministic test double), and ``step_time_s`` optionally
    charges a fixed virtual cost per engine step so latency metrics are
    exact integers of steps;
  * ``run_for(n_steps=... | duration_s=...)`` pumps inline on the
    caller's thread — no background thread, no races — which is how the
    deterministic tests drive it;
  * admission decisions are **pure functions** of an
    ``AdmissionSnapshot`` (``admission_decision`` /
    ``projected_ttft_s``), unit-testable without any engine or timing.

The open-loop driver ``serve_schedule`` replays a
``traces/loadgen.py`` arrival schedule: submissions happen when the
clock passes each arrival's timestamp (never earlier), and a handle's
latency is measured from the *scheduled* arrival — under overload the
queueing delay lands in TTFT, which is exactly what an open-loop
latency-vs-QPS curve must show.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Deque, Dict, List, Optional, Sequence

from repro_torch.serving.request import Phase, Request, SamplingParams


# ---------------------------------------------------------------------------
# clocks
# ---------------------------------------------------------------------------
class VirtualClock:
    """Deterministic clock double: ``sleep`` advances time instead of
    waiting, so a pump loop driven under it is a pure function of its
    inputs.  The interface matches the ``time`` module (``monotonic`` /
    ``sleep``), which is the default real clock."""

    def __init__(self, start: float = 0.0):
        self._t = float(start)

    def monotonic(self) -> float:
        return self._t

    def sleep(self, dt: float) -> None:
        self._t += max(0.0, float(dt))

    def advance(self, dt: float) -> None:
        self.sleep(dt)


# ---------------------------------------------------------------------------
# SLO admission control (pure functions of observable state)
# ---------------------------------------------------------------------------
ADMIT, QUEUE, SHED = "admit", "queue", "shed"


@dataclass(frozen=True)
class SLOConfig:
    """Admission-control knobs.  ``ttft_budget_s=inf`` disables control
    entirely (every request is admitted — the uncontrolled A/B)."""
    ttft_budget_s: float = float("inf")
    action: str = "shed"            # on projected breach: "shed" | "queue"
    max_queue: int = 64             # bounded front-end queue (queue mode)

    def __post_init__(self):
        if self.action not in (SHED, QUEUE):
            raise ValueError(
                f"SLOConfig.action must be 'shed' or 'queue', "
                f"got {self.action!r}")


@dataclass(frozen=True)
class AdmissionSnapshot:
    """Observable state the admission decision is a pure function of.
    Built by ``ServingFrontend._snapshot`` from the engine scheduler(s)
    and the front-end queue; tests construct it directly."""
    pending_prefill_tokens: int    # engine-side backlog (waiting +
    #                                mid-prefill remainders + preempted)
    queued_prefill_tokens: int     # front-end SLO queue backlog
    queue_len: int                 # front-end SLO queue length
    live_decodes: int              # running decode streams
    free_slots: int                # unoccupied decode slots
    est_step_s: float              # EWMA of measured engine step time


def projected_ttft_s(prompt_len: int, snap: AdmissionSnapshot,
                     max_step_tokens: int) -> float:
    """Projected TTFT for a new arrival: every queued prompt token ahead
    of it (engine backlog + front-end queue + its own prompt) must flow
    through the per-step prefill budget — which running decodes eat
    into — plus one decode step to emit the first token."""
    backlog = (snap.pending_prefill_tokens + snap.queued_prefill_tokens
               + prompt_len)
    per_step = max(1, max_step_tokens - snap.live_decodes)
    steps = backlog / per_step + 1.0
    return steps * snap.est_step_s


def admission_decision(prompt_len: int, snap: AdmissionSnapshot,
                       slo: SLOConfig, max_step_tokens: int) -> str:
    """ADMIT / QUEUE / SHED for one arrival — pure and deterministic.

    Invariants the property tests pin:
      * an infinite budget always admits (uncontrolled mode);
      * an **idle system never sheds** (no backlog, no queue, no live
        decodes): whatever the offered rate, the server always serves at
        least its sequential service rate — the rate floor;
      * QUEUE is only returned while ``queue_len < max_queue`` — the
        front-end queue is bounded by construction.
    """
    if slo.ttft_budget_s == float("inf"):
        return ADMIT
    idle = (snap.pending_prefill_tokens == 0 and snap.queue_len == 0
            and snap.live_decodes == 0)
    if idle:
        return ADMIT
    if projected_ttft_s(prompt_len, snap, max_step_tokens) \
            <= slo.ttft_budget_s:
        return ADMIT
    if slo.action == QUEUE and snap.queue_len < slo.max_queue:
        return QUEUE
    return SHED


# ---------------------------------------------------------------------------
# stream handles
# ---------------------------------------------------------------------------
@dataclass
class StreamHandle:
    """Caller-facing view of one submitted request.  Mutated only by
    the pump thread; terminal exactly once (``done`` or ``shed``)."""
    prompt: List[int]
    params: SamplingParams
    session_id: Optional[str]
    arrival_t: float               # front-end clock (scheduled arrival)
    on_token: Optional[Callable[[int, int], None]] = None
    on_done: Optional[Callable[["StreamHandle"], None]] = None
    submit_kw: dict = field(default_factory=dict)
    status: str = "pending"        # pending → queued → running → done
    #                                        ↘ shed (terminal)
    request: Optional[Request] = None
    tokens: List[int] = field(default_factory=list)
    token_times: List[float] = field(default_factory=list)
    admit_t: Optional[float] = None
    first_token_t: Optional[float] = None
    done_t: Optional[float] = None

    @property
    def ttft(self) -> Optional[float]:
        if self.first_token_t is None:
            return None
        return self.first_token_t - self.arrival_t

    @property
    def tbts(self) -> List[float]:
        return [b - a for a, b in zip(self.token_times,
                                      self.token_times[1:])]


def _percentile(vals: Sequence[float], p: float) -> float:
    vals = sorted(vals)
    if not vals:
        return 0.0
    return vals[min(len(vals) - 1, int(p * len(vals)))]


# ---------------------------------------------------------------------------
# the front-end
# ---------------------------------------------------------------------------
class ServingFrontend:
    """Thread-pumped serving loop over a ``ServingEngine`` or
    ``ReplicaCluster``.

    ``step_time_s``: when set, each engine step charges that fixed
    virtual cost to the clock (``clock.sleep``) instead of relying on
    wall time passing — with a ``VirtualClock`` this makes every
    latency metric deterministic.  Leave ``None`` under the real clock
    (step cost is then the measured wall time).
    """

    def __init__(self, engine, *, slo: Optional[SLOConfig] = None,
                 clock=time, step_time_s: Optional[float] = None,
                 idle_sleep_s: float = 1e-4,
                 est_step_s: float = 5e-3, ewma_alpha: float = 0.2):
        self.engine = engine
        self.slo = slo if slo is not None else SLOConfig()
        self.clock = clock
        self.step_time_s = step_time_s
        self.idle_sleep_s = idle_sleep_s
        self._est_step_s = est_step_s
        self._ewma_alpha = ewma_alpha
        self._lock = threading.Lock()
        self._inbox: Deque[StreamHandle] = deque()
        self._queue: Deque[StreamHandle] = deque()     # SLO queue
        self._active: Dict[int, StreamHandle] = {}     # request_id → handle
        self._handles: List[StreamHandle] = []         # every submission
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._closed = False
        # ledger: offered == admitted + shed + (inbox + queue still open)
        self.offered = 0
        self.admitted = 0
        self.shed = 0
        self.done = 0
        self.goodput = 0           # done with TTFT ≤ budget
        self.queued_peak = 0
        self.pump_iterations = 0
        self._ttfts: List[float] = []
        self._tbts: List[float] = []

    # -- engine abstraction (single engine or cluster) ----------------------
    def _engines(self) -> list:
        eng = self.engine
        if hasattr(eng, "engines"):            # ReplicaCluster
            return list(eng.engines.values())
        return [eng]

    @property
    def max_step_tokens(self) -> int:
        return self._engines()[0].ecfg.max_step_tokens

    def _engine_has_work(self) -> bool:
        if hasattr(self.engine, "has_work"):   # cluster
            return self.engine.has_work()
        return self.engine.scheduler.has_work()

    # -- submission ---------------------------------------------------------
    def submit(self, prompt: Sequence[int], *,
               params: Optional[SamplingParams] = None,
               session_id: Optional[str] = None,
               arrival_t: Optional[float] = None,
               on_token: Optional[Callable[[int, int], None]] = None,
               on_done: Optional[Callable[[StreamHandle], None]] = None,
               **submit_kw) -> StreamHandle:
        """Thread-safe, non-blocking: enqueue an arrival for the pump.
        ``arrival_t`` defaults to now; the open-loop driver passes the
        *scheduled* arrival so queueing delay lands in TTFT."""
        if self._closed:
            raise RuntimeError("frontend is shut down")
        h = StreamHandle(
            prompt=list(prompt),
            params=params if params is not None else SamplingParams(),
            session_id=session_id,
            arrival_t=(self.clock.monotonic() if arrival_t is None
                       else arrival_t),
            on_token=on_token, on_done=on_done, submit_kw=dict(submit_kw))
        with self._lock:
            self.offered += 1
            self._inbox.append(h)
            self._handles.append(h)
        return h

    # -- admission ----------------------------------------------------------
    def _snapshot(self) -> AdmissionSnapshot:
        pend = live = free = 0
        for e in self._engines():
            sch = e.scheduler
            pend += sum(r.prompt_len for r in sch.waiting)
            pend += sum(r.prompt_len for r in sch.preempted)
            for r in sch.running.values():
                if r.phase is Phase.PREFILL:
                    pend += r.prefill_left
                elif r.phase is Phase.DECODE:
                    live += 1
            free += len(e.kv.free_slots())
        qtok = sum(len(h.prompt) for h in self._queue)
        return AdmissionSnapshot(
            pending_prefill_tokens=pend, queued_prefill_tokens=qtok,
            queue_len=len(self._queue), live_decodes=live,
            free_slots=free, est_step_s=self._est_step_s)

    def _engine_submit(self, h: StreamHandle) -> None:
        h.request = self.engine.submit(
            h.prompt, params=h.params, session_id=h.session_id,
            **h.submit_kw)
        h.status = "running"
        h.admit_t = self.clock.monotonic()
        self._active[h.request.request_id] = h
        self.admitted += 1

    def _terminal_shed(self, h: StreamHandle) -> None:
        h.status = "shed"
        h.done_t = self.clock.monotonic()
        self.shed += 1
        if h.on_done is not None:
            h.on_done(h)

    def _admit_arrival(self, h: StreamHandle) -> None:
        decision = admission_decision(len(h.prompt), self._snapshot(),
                                      self.slo, self.max_step_tokens)
        if decision == ADMIT:
            self._engine_submit(h)
        elif decision == QUEUE:
            h.status = "queued"
            self._queue.append(h)
            self.queued_peak = max(self.queued_peak, len(self._queue))
        else:
            self._terminal_shed(h)

    def _drain_queue(self) -> None:
        """Re-evaluate the SLO queue head as backlog drains: admit when
        its projection (head excluded from the queued backlog) fits; a
        head that has already waited past the budget can no longer make
        its SLO — shed it, so the queue's occupancy is bounded in time
        as well as length."""
        while self._queue:
            h = self._queue[0]
            if self.clock.monotonic() - h.arrival_t > self.slo.ttft_budget_s:
                self._queue.popleft()
                self._terminal_shed(h)
                continue
            snap = self._snapshot()
            snap = AdmissionSnapshot(
                pending_prefill_tokens=snap.pending_prefill_tokens,
                queued_prefill_tokens=(snap.queued_prefill_tokens
                                       - len(h.prompt)),
                queue_len=snap.queue_len - 1,
                live_decodes=snap.live_decodes,
                free_slots=snap.free_slots,
                est_step_s=snap.est_step_s)
            if projected_ttft_s(len(h.prompt), snap, self.max_step_tokens) \
                    <= self.slo.ttft_budget_s:
                self._queue.popleft()
                self._engine_submit(h)
            else:
                break

    # -- the pump -----------------------------------------------------------
    def _deliver(self) -> int:
        """Post-step delivery: new tokens → ``on_token`` (once each, in
        order), completions → ``on_done`` (terminal, once).  Handles are
        visited in request-id (submission) order for determinism."""
        now = self.clock.monotonic()
        delivered = 0
        for rid in sorted(self._active):
            h = self._active[rid]
            req = h.request
            new = req.generated[len(h.tokens):]
            for tok in new:
                idx = len(h.tokens)
                h.tokens.append(tok)
                h.token_times.append(now)
                if h.first_token_t is None:
                    h.first_token_t = now
                if h.on_token is not None:
                    h.on_token(tok, idx)
                delivered += 1
            if req.phase is Phase.DONE:
                self._active.pop(rid)
                h.status = "done"
                h.done_t = now
                self.done += 1
                ttft = h.ttft
                if ttft is not None:
                    self._ttfts.append(ttft)
                    if ttft <= self.slo.ttft_budget_s:
                        self.goodput += 1
                self._tbts.extend(h.tbts)
                if h.on_done is not None:
                    h.on_done(h)
        return delivered

    def pump_once(self) -> int:
        """One front-end iteration: drain the inbox through admission,
        re-evaluate the SLO queue, step the engine once (charging
        measured or fixed virtual time), deliver tokens/completions.
        Returns tokens delivered."""
        with self._lock:
            arrivals = list(self._inbox)
            self._inbox.clear()
        for h in arrivals:
            self._admit_arrival(h)
        self._drain_queue()
        stepped = False
        t0 = self.clock.monotonic()
        if self._engine_has_work():
            self.engine.step()
            stepped = True
            if self.step_time_s is not None:
                self.clock.sleep(self.step_time_s)
            dt = self.clock.monotonic() - t0
            if dt > 0:
                a = self._ewma_alpha
                self._est_step_s = (1 - a) * self._est_step_s + a * dt
        delivered = self._deliver()
        if not stepped:
            self.clock.sleep(self.idle_sleep_s)
        self.pump_iterations += 1
        return delivered

    # -- inline (deterministic) driving -------------------------------------
    def run_for(self, n_steps: Optional[int] = None,
                duration_s: Optional[float] = None) -> int:
        """Pump inline on the caller's thread — the deterministic mode
        the test suite drives (no background thread).  Bounded by
        ``n_steps`` pump iterations and/or ``duration_s`` on the
        front-end clock; returns iterations run."""
        if n_steps is None and duration_s is None:
            raise ValueError("pass n_steps and/or duration_s")
        t_end = (None if duration_s is None
                 else self.clock.monotonic() + duration_s)
        i = 0
        while (n_steps is None or i < n_steps) and \
                (t_end is None or self.clock.monotonic() < t_end):
            self.pump_once()
            i += 1
        return i

    def serve_schedule(self, arrivals, *, drain: bool = True,
                       on_token=None, on_done=None,
                       max_pumps: int = 2_000_000) -> List[StreamHandle]:
        """Open-loop driver: replay a ``traces/loadgen.py`` schedule
        against the front-end clock.  Each arrival submits once the
        clock passes its timestamp (with ``arrival_t`` pinned to the
        *scheduled* time, so catch-up delay lands in TTFT); with
        ``drain=True`` the loop pumps until every accepted request
        reaches a terminal state."""
        t0 = self.clock.monotonic()
        handles: List[StreamHandle] = []
        i, pumps = 0, 0
        while i < len(arrivals) or (drain and self.in_flight() > 0):
            now = self.clock.monotonic() - t0
            while i < len(arrivals) and arrivals[i].t <= now:
                a = arrivals[i]
                handles.append(self.submit(
                    list(a.prompt),
                    params=SamplingParams(max_new_tokens=a.max_new),
                    session_id=a.session_id,
                    arrival_t=t0 + a.t,
                    on_token=on_token, on_done=on_done,
                    block_types=list(a.block_types), tool=a.tool,
                    retain_blocks=not a.last_turn))
                i += 1
            if (not self._engine_has_work() and not self._queue
                    and not self._inbox and i < len(arrivals)):
                # idle gap: sleep the clock up to the next arrival
                gap = (t0 + arrivals[i].t) - self.clock.monotonic()
                if gap > 0:
                    self.clock.sleep(gap)
                continue
            self.pump_once()
            pumps += 1
            if pumps >= max_pumps:
                raise RuntimeError("serve_schedule did not converge "
                                   f"within {max_pumps} pump iterations")
        return handles

    # -- background thread --------------------------------------------------
    def start(self) -> None:
        """Launch the pump thread (real-clock serving)."""
        if self._thread is not None:
            raise RuntimeError("frontend already started")
        self._stop.clear()

        def _loop():
            while not self._stop.is_set():
                self.pump_once()

        self._thread = threading.Thread(target=_loop,
                                        name="frontend-pump", daemon=True)
        self._thread.start()

    def stop(self, drain: bool = True, timeout: float = 30.0) -> None:
        """Clean shutdown.  With ``drain=True`` (default) the pump keeps
        running until every accepted request is terminal — no request is
        leaked — then the thread exits and the engine(s) shut down.

        The drain is *bounded*: a request stuck behind a dead tier or a
        permanently stalled transfer cannot hold shutdown hostage.  At
        the drain deadline every still-open submission is cancelled in
        the engine (freeing its decode slot and KV blocks) and marked
        shed, so the ledger still balances (``offered == shed + done``)
        and ``check_ledger`` passes after a chaotic shutdown."""
        if self._thread is not None:
            if drain:
                deadline = time.monotonic() + timeout
                while self.in_flight() > 0:
                    if time.monotonic() >= deadline:
                        self._shed_stuck()
                        break
                    time.sleep(1e-3)
            self._stop.set()
            self._thread.join(timeout=timeout)
            self._thread = None
        elif drain:
            deadline = self.clock.monotonic() + timeout
            while self.in_flight() > 0:
                if self.clock.monotonic() >= deadline:
                    self._shed_stuck()
                    break
                self.pump_once()
        self._closed = True
        self.engine.shutdown()

    def _shed_stuck(self) -> None:
        """Drain-deadline escalation: cancel every open submission.

        Engine-resident requests are cancelled through
        ``cancel_request`` (slot released, KV blocks freed, tier copies
        dropped); inbox/queue entries never reached the engine and are
        shed directly.  Each open handle reaches its terminal state
        exactly once, preserving the ledger invariant."""
        with self._lock:
            pending = list(self._inbox) + list(self._queue)
            self._inbox.clear()
            self._queue.clear()
            stuck = [self._active.pop(rid) for rid in sorted(self._active)]
        for h in pending:
            self._terminal_shed(h)
        for h in stuck:
            if h.request is not None and hasattr(self.engine,
                                                "cancel_request"):
                self.engine.cancel_request(h.request)
            self._terminal_shed(h)

    # -- accounting ---------------------------------------------------------
    def in_flight(self) -> int:
        """Accepted-or-pending requests not yet terminal: inbox + SLO
        queue + engine-resident."""
        with self._lock:
            return len(self._inbox) + len(self._queue) + len(self._active)

    def check_ledger(self) -> None:
        """Every submission is in exactly one state; terminal states are
        reached exactly once.  The soak test calls this under load."""
        with self._lock:
            n_inbox, n_queue = len(self._inbox), len(self._queue)
            n_active = len(self._active)
            offered, shed, done = self.offered, self.shed, self.done
            n_handles = len(self._handles)
        assert offered == n_handles, (offered, n_handles)
        assert offered == shed + done + n_inbox + n_queue + n_active, (
            f"ledger leak: offered={offered} shed={shed} done={done} "
            f"inbox={n_inbox} queue={n_queue} active={n_active}")

    def stats(self) -> dict:
        with self._lock:
            in_flight = (len(self._inbox) + len(self._queue)
                         + len(self._active))
            out = {
                "offered": self.offered,
                "admitted": self.admitted,
                "shed": self.shed,
                "done": self.done,
                "goodput": self.goodput,
                "in_flight": in_flight,
                "queued_now": len(self._queue),
                "queued_peak": self.queued_peak,
                "pump_iterations": self.pump_iterations,
                "est_step_s": self._est_step_s,
                "ttft_budget_s": self.slo.ttft_budget_s,
                "ttft_p50": _percentile(self._ttfts, 0.50),
                "ttft_p99": _percentile(self._ttfts, 0.99),
                "tbt_p50": _percentile(self._tbts, 0.50),
                "tbt_p99": _percentile(self._tbts, 0.99),
                "generated_tokens": sum(len(h.tokens)
                                        for h in self._handles),
            }
        return out
