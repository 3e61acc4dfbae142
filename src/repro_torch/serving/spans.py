"""Host spans of the serving step, kept in memory while a torch profiler
records.

A span is its name, its start and end in ``time.time_ns()`` (the clock
of the profiler's events, so a span lies over the device trace as
recorded), its own id and its parent's (0: none), the request it
belongs to (-1: none) and one integer attribute.  ``ServingEngine``
records these:

  ``engine.step``     the whole of ``step``; attribute: rows decoded
  ``engine.admit``    transfer polling, stragglers, admission
  ``engine.plan``     ``Scheduler.plan_step``
  ``engine.prefill``  one request's chunks; its request id, attribute:
                      prompt tokens prefilled
  ``model.forward``   one call into the model (a prefill chunk; the
                      decode step with the sampler's launch)
  ``engine.decode``   the batched decode; attribute: rows
  ``engine.sync``     a copy between host and card that blocks the host
                      (``to_device`` / ``to_host``); attribute: bytes
  ``engine.finish``   releasing the finished requests
  ``engine.gc``       unpinning the pages of demoted blocks
  ``cache.tick``      the cache manager's tick and ageing
  ``sched.wait``      ``submit`` to the request's first slot; its
                      request id; no parent

The recorder follows the profiler, which is one per process, so there is
one recorder per process (``RECORDER``).  ``poll`` reads whether a
profiler records; the engine polls once a step and at each submission,
and the first poll that finds a recording after none clears what the
last one kept.  Spans stay readable after the recording stops, until the
next one starts.  While nothing records, each site tests ``on`` and
records nothing.  Spans nest on one stack: the engine is stepped from one
thread at a time (the front-end's pump, the cluster's loop).  On the CPU
the ``engine.sync`` sites are recorded too, though nothing waits there.
"""
from __future__ import annotations

import time
from typing import Dict, List, NamedTuple

import numpy as np
import torch

_profiling = torch._C._autograd._profiler_enabled


class Span(NamedTuple):
    name: str
    t0: int          # time.time_ns()
    t1: int          # -1 while open
    sid: int
    parent: int      # 0: a root span
    rid: int         # request id, -1 for none
    attr: int


class SpanRecorder:
    def __init__(self):
        self.on = False
        self._done: List[Span] = []
        self._open: Dict[int, tuple] = {}      # sid -> (name, t0, parent, rid)
        self._stack: List[int] = []
        self._next = 1

    def poll(self) -> bool:
        """Whether a profiler records; a new recording clears the spans
        of the last."""
        now = _profiling()
        if now and not self.on:
            self._done.clear()
            self._open.clear()
            self._stack.clear()
        self.on = now
        return now

    def begin(self, name: str, rid: int = -1, nest: bool = True) -> int:
        """Open a span under the innermost open nested span; ``nest``
        False keeps it off the stack and parentless (a wait that outlives
        the step).  Returns its id."""
        sid = self._next
        self._next += 1
        parent = self._stack[-1] if nest and self._stack else 0
        self._open[sid] = (name, time.time_ns(), parent, rid)
        if nest:
            self._stack.append(sid)
        return sid

    def end(self, sid: int, attr: int = 0) -> None:
        """Close a span.  Nested spans left open inside it (an exception
        passed through them) are dropped; a span a new recording cleared
        is ignored."""
        t1 = time.time_ns()
        rec = self._open.pop(sid, None)
        if rec is None:
            return
        if sid in self._stack:
            while self._stack[-1] != sid:
                self._open.pop(self._stack.pop(), None)
            self._stack.pop()
        name, t0, parent, rid = rec
        self._done.append(Span(name, t0, t1, sid, parent, rid, attr))

    def finished(self) -> List[Span]:
        return list(self._done)

    def still_open(self) -> List[Span]:
        """The spans not yet closed, each with ``t1`` -1."""
        return [Span(name, t0, -1, sid, parent, rid, 0)
                for sid, (name, t0, parent, rid) in self._open.items()]


RECORDER = SpanRecorder()


def to_device(data, dtype, device) -> torch.Tensor:
    """``torch.tensor(data, dtype=dtype, device=device)``, a copy: from
    pageable host memory onto the card it waits for the stream to drain,
    so it is an ``engine.sync`` span."""
    if not RECORDER.on:
        return torch.tensor(data, dtype=dtype, device=device)
    sid = RECORDER.begin("engine.sync")
    t = torch.tensor(data, dtype=dtype, device=device)
    RECORDER.end(sid, t.nbytes)
    return t


def to_host(t: torch.Tensor) -> np.ndarray:
    """``t.cpu().numpy()``: waits for the stream to drain, so it is an
    ``engine.sync`` span."""
    if not RECORDER.on:
        return t.cpu().numpy()
    sid = RECORDER.begin("engine.sync")
    a = t.cpu().numpy()
    RECORDER.end(sid, a.nbytes)
    return a
