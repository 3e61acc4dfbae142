"""Open-loop Poisson load generation for the wall-clock serving
front-end (``serving/frontend.py``).

The trace replay (``serving_replay.py``) drives a *virtual* clock:
arrivals are a fixed interarrival ramp and a session's next turn waits
for the previous turn's completion.  A real latency-vs-QPS curve needs
**open-loop** load — arrivals keep coming at the offered rate whether or
not the server keeps up, so queueing delay (and the SLO admission
controller's response to it) is visible in the TTFT tail.  This module
produces that load as a *deterministic schedule*:

  * request bodies are drawn from the existing session generators
    (``generators.workload_sessions``: sharegpt / lmsys / agentic /
    ``file:<path>`` real-trace ingestion) through the same turn-spec
    materialization the replay uses, so the front-end sees the same
    prefix-reuse structure the virtual-clock replay validated;
  * arrival *times* are a Poisson process at ``rate_qps`` drawn from a
    seeded, injectable RNG — the whole schedule is a pure function of
    ``(workload, rate, seed)``, so every load test is reproducible and
    the property tests (``tests/test_loadgen.py``) can assert on the
    process statistics without timing races;
  * a session's turns stay in order in the schedule (turn k+1 is
    assigned a later arrival than turn k) but do **not** wait for
    completion — open loop, by construction.

The schedule is plain data (``List[Arrival]``); the front-end's
``serve_schedule`` replays it against a real or virtual clock.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np


@dataclass(frozen=True)
class Arrival:
    """One scheduled request: submit ``prompt`` at ``t`` seconds after
    the load run starts (timestamps are monotone across the schedule)."""
    t: float
    session_id: str
    turn: int                      # turn index within the session
    prompt: Tuple[int, ...]
    block_types: Tuple[str, ...]
    tool: Optional[str]
    max_new: int
    last_turn: bool                # False -> submit with retain_blocks


class PoissonLoadGen:
    """Seeded open-loop Poisson arrival-time generator.

    ``rng`` is injectable so tests can substitute any ``Generator``;
    by default a fresh ``np.random.default_rng(seed)`` makes the
    process a pure function of ``(rate_qps, seed)``.
    """

    def __init__(self, rate_qps: float, *, seed: int = 0, rng=None):
        if rate_qps <= 0:
            raise ValueError(f"rate_qps must be > 0, got {rate_qps}")
        self.rate_qps = float(rate_qps)
        self.rng = np.random.default_rng(seed) if rng is None else rng

    def interarrivals(self, n: int) -> np.ndarray:
        """n exponential gaps with mean 1/rate (seconds)."""
        return self.rng.exponential(1.0 / self.rate_qps, size=n)

    def arrival_times(self, *, n: Optional[int] = None,
                      duration_s: Optional[float] = None) -> List[float]:
        """Monotone non-decreasing arrival timestamps: either exactly
        ``n`` arrivals, or every arrival landing before ``duration_s``."""
        if (n is None) == (duration_s is None):
            raise ValueError("pass exactly one of n / duration_s")
        if n is not None:
            return list(np.cumsum(self.interarrivals(n)))
        out: List[float] = []
        t = 0.0
        while True:
            t += float(self.rng.exponential(1.0 / self.rate_qps))
            if t >= duration_s:
                return out
            out.append(t)


def _turn_bodies(workload: str, *, n_sessions: int, max_turns: int,
                 block_tokens: int, max_new_cap: int, seed: int
                 ) -> List[list]:
    """Session turn specs through the replay's materialization (one
    trace block -> one ``block_tokens``-token engine block), so the
    front-end load carries the same reuse structure the replay
    validated.  Imported lazily — the schedule shape (timing) never
    depends on it."""
    from repro_torch.core import sizing
    from repro_torch.traces.generators import TraceConfig, workload_sessions
    from repro_torch.traces.serving_replay import _turn_spec, replay_model_config
    cfg = replay_model_config(block_tokens)
    bt = sizing.block_tokens(cfg)
    sessions = workload_sessions(
        workload, TraceConfig(n_sessions=n_sessions, seed=seed))
    cache: Dict[Tuple, List[int]] = {}
    return [[_turn_spec(t, bt, cfg.vocab_size, max_new_cap, cache)
             for t in sess[:max_turns]] for sess in sessions]


def trace_load(workload: str, rate_qps: float, *,
               duration_s: Optional[float] = None,
               n_requests: Optional[int] = None,
               seed: int = 0, n_sessions: int = 16, max_turns: int = 4,
               block_tokens: int = 16, max_new_cap: int = 4,
               concurrency: int = 8) -> List[Arrival]:
    """An open-loop request schedule: session turns drawn from the
    ``workload`` generator (or ``file:<path>`` ingestion), interleaved
    over a ``concurrency`` window (so consecutive arrivals mix
    sessions, like real traffic), with Poisson arrival times at
    ``rate_qps``.

    Deterministic: the same ``(workload, rate_qps, seed, ...)`` yields a
    byte-identical schedule.  Timestamps are strictly ordered per
    session (turn k+1 after turn k) and monotone overall; the stream
    cycles through the session pool if ``duration_s``/``n_requests``
    demands more turns than the pool holds.
    """
    specs = _turn_bodies(workload, n_sessions=n_sessions,
                         max_turns=max_turns, block_tokens=block_tokens,
                         max_new_cap=max_new_cap, seed=seed)
    if not any(specs):
        raise ValueError(f"workload {workload!r} produced no turns")
    gen = PoissonLoadGen(rate_qps, seed=seed + 1)
    times = gen.arrival_times(n=n_requests, duration_s=duration_s)

    # deterministic session interleave (mirrors the trace generators'
    # turn-quantum interleaving): keep up to `concurrency` sessions
    # live, draw the next turn from a seeded-random live session
    rng = np.random.default_rng(seed + 2)
    out: List[Arrival] = []
    pending: List[Tuple[int, List]] = []
    live: List[List] = []
    epoch = 0
    for k, t in enumerate(times):
        if not pending and not live:
            # (re)fill from the session pool; later epochs get fresh
            # session ids so a cycled schedule doesn't alias sessions
            pending = [(i, list(s)) for i, s in enumerate(specs) if s]
            rng.shuffle(pending)
            epoch += 1
        while pending and len(live) < concurrency:
            idx, turns = pending.pop()
            sid = turns[0].session_id
            if epoch > 1:
                sid = f"{sid}.e{epoch}"
            live.append([sid, 0, turns])
        j = int(rng.integers(0, len(live)))
        sid, turn_i, turns = live[j]
        spec = turns[turn_i]
        last = turn_i + 1 >= len(turns)
        out.append(Arrival(
            t=float(t), session_id=sid, turn=turn_i,
            prompt=tuple(spec.prompt),
            block_types=tuple(spec.block_types),
            tool=spec.tool, max_new=spec.max_new, last_turn=last))
        if last:
            live.pop(j)
        else:
            live[j][1] = turn_i + 1
    return out


def offered_summary(arrivals: List[Arrival]) -> dict:
    """Schedule-level accounting (the load side of the goodput
    ledger): request count, span, realized offered rate, prompt-token
    volume."""
    if not arrivals:
        return {"requests": 0, "span_s": 0.0, "offered_qps": 0.0,
                "prompt_tokens": 0, "sessions": 0}
    span = arrivals[-1].t - arrivals[0].t
    return {
        "requests": len(arrivals),
        "span_s": span,
        "offered_qps": len(arrivals) / span if span > 0 else float("inf"),
        "prompt_tokens": sum(len(a.prompt) for a in arrivals),
        "sessions": len({a.session_id for a in arrivals}),
    }
