"""The measured window: the program's ``ServingFrontend`` over one
``ServingEngine``, pumped on this thread (``pump_once``, as
``run_for`` / ``serve_schedule`` pump it), fed an open-loop schedule.

Each arrival is submitted once the clock passes its due time, with
``arrival_t`` set to that due time, so a request's latency runs from
when it was due; how late the submission came is recorded as the
generator's lag.  Admission control stays at its default (off).

Around ``ServingEngine.step`` the harness records, on the host and
without touching the device, each step's clock, the prompt tokens it
prefilled, the rows it decoded, the pool pages held after it and the
requests still waiting for a slot or for their prompt's prefill."""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import List

from pb.traffic import Arrival


@dataclass
class StepRecord:
    t0: float
    t1: float
    prefill_tokens: int
    decode_rows: int
    pages_used: int
    waiting: int                  # requests not yet admitted after it
    prefilling: int               # admitted requests still prefilling


@dataclass
class WindowResult:
    t_open: float
    t_close: float
    handles: list
    due: List[float]              # absolute due time of each handle
    lags: List[float]
    steps: List[StepRecord] = field(default_factory=list)
    prefill_tokens: int = 0       # the engine's counter over the window
    pool_pages: int = 1

    @property
    def seconds(self) -> float:
        return self.t_close - self.t_open


def record_steps(engine, steps: List[StepRecord], clock=time):
    """Wrap ``engine.step`` to append a ``StepRecord`` per step; returns
    a function that takes the wrap off."""
    inner = engine.step
    alloc = engine.kv.allocator if engine.paged else None
    sch = engine.scheduler
    from repro_torch.serving.request import Phase
    prefill = Phase.PREFILL

    def step():
        t0 = clock.monotonic()
        produced = inner()
        t1 = clock.monotonic()
        steps.append(StepRecord(t0, t1, engine.last_step_prefill_tokens,
                                produced,
                                alloc.in_use if alloc is not None else 0,
                                len(sch.waiting),
                                sum(1 for r in sch.running.values()
                                    if r.phase is prefill)))
        return produced

    engine.step = step
    return lambda: setattr(engine, "step", inner)


def serve_window(frontend, engine, arrivals: List[Arrival], seconds: float,
                 temperature: float = 0.0) -> WindowResult:
    """Serve ``arrivals`` for ``seconds`` of the front-end's clock (the
    wall clock, or in the test suite a virtual one that each step
    advances by a fixed cost) and stop: what is still in flight at the
    close stays unfinished."""
    from repro_torch.serving.request import SamplingParams
    clock = frontend.clock
    steps: List[StepRecord] = []
    unwrap = record_steps(engine, steps, clock)
    prefill0 = engine.prefill_tokens_total
    handles, due, lags = [], [], []
    t_open = clock.monotonic()
    t_close = t_open + seconds
    i, n = 0, len(arrivals)
    try:
        while True:
            now = clock.monotonic()
            if now >= t_close:
                break
            while i < n and t_open + arrivals[i].t <= now:
                a = arrivals[i]
                at = t_open + a.t
                handles.append(frontend.submit(
                    list(a.prompt),
                    params=SamplingParams(max_new_tokens=a.max_new,
                                          temperature=temperature),
                    session_id=f"s{a.session}", arrival_t=at,
                    retain_blocks=not a.last_turn))
                due.append(at)
                lags.append(now - at)
                i += 1
            if frontend.in_flight() == 0:
                nxt = t_open + arrivals[i].t if i < n else t_close
                clock.sleep(max(0.0, min(nxt, t_close) - now))
                continue
            frontend.pump_once()
    finally:
        unwrap()
    res = WindowResult(t_open, t_close, handles, due, lags, steps,
                       engine.prefill_tokens_total - prefill0,
                       engine.kv.n_pages - 1 if engine.paged else 1)
    return res
