"""The serving step's span recorder (``repro_torch.serving.spans``) on the
CPU: it records only while a torch profiler records, the engine's spans
form the tree its docstring gives, a new recording starts empty, and the
spans share the profiler's clock.  Imports neither ``jax`` nor ``repro``."""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch.config import reduce_config  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.serving import engine as engine_mod  # noqa: E402
from repro_torch.serving import spans  # noqa: E402
from repro_torch.serving.engine import (EngineConfig,  # noqa: E402
                                        ServingEngine)
from repro_torch.serving.request import SamplingParams  # noqa: E402

CFG = reduce_config(get_config("llama3.2-1b"))

# where each span may sit: its parent's name, None for a root
PARENTS = {
    "engine.step": {None},
    "sched.wait": {None},
    "engine.admit": {"engine.step"},
    "engine.plan": {"engine.step"},
    "engine.prefill": {"engine.step"},
    "engine.decode": {"engine.step"},
    "engine.finish": {"engine.step"},
    "engine.gc": {"engine.step"},
    "cache.tick": {"engine.step"},
    # the monolithic prefill (dense layout) runs at admission
    "model.forward": {"engine.prefill", "engine.decode", "engine.admit"},
    "engine.sync": {"engine.admit", "engine.prefill", "engine.decode",
                    "model.forward"},
}


@pytest.fixture
def rec(monkeypatch):
    """A recorder of this test's own, in the engine's and the helpers'
    place."""
    r = spans.SpanRecorder()
    monkeypatch.setattr(spans, "RECORDER", r)
    monkeypatch.setattr(engine_mod, "RECORDER", r)
    return r


def _engine(**kw):
    return ServingEngine(CFG, EngineConfig(max_len=256, kv_budget_bytes=2e6,
                                           **kw), device="cpu")


def _submit(eng, n, seed, length=100, new=4):
    rng = np.random.default_rng(seed)
    return [eng.submit([int(x) for x in rng.integers(1, CFG.vocab_size,
                                                     length)],
                       params=SamplingParams(max_new_tokens=new))
            for _ in range(n)]


def _serve(eng, limit=50):
    produced = 0
    for _ in range(limit):
        if not eng.scheduler.has_work():
            break
        produced += eng.step()
    return produced


def test_nothing_is_recorded_without_a_profiler(rec):
    eng = _engine()
    _submit(eng, 3, 0)
    assert _serve(eng) > 0
    assert not rec.on
    assert rec.finished() == [] and rec.still_open() == []
    eng.shutdown()


@pytest.mark.parametrize("path", [{}, {"fused_step": False},
                                  {"paged": False}],
                         ids=["default", "unfused", "dense"])
def test_profiled_steps_record_the_tree(rec, path):
    eng = _engine(**path)
    with profile(activities=[ProfilerActivity.CPU]):
        reqs = _submit(eng, 3, 1)
        produced = _serve(eng)
    assert produced == sum(len(r.generated) for r in reqs) > 0
    done = rec.finished()
    assert rec.still_open() == []
    by_id = {s.sid: s for s in done}
    names = {s.name for s in done}
    assert {"engine.step", "engine.admit", "engine.plan", "engine.decode",
            "model.forward", "engine.sync", "engine.finish", "cache.tick",
            "sched.wait"} <= names
    for s in done:
        assert s.t0 <= s.t1
        parent = by_id[s.parent] if s.parent else None
        assert (parent.name if parent else None) in PARENTS[s.name], s
        if parent is not None:      # a parent holds its children
            assert parent.t0 <= s.t0 and s.t1 <= parent.t1
    steps = [s for s in done if s.name == "engine.step"]
    assert len(steps) == eng.steps
    assert sum(s.attr for s in steps) == produced
    # every request waited once for its slot, under its own id, and got
    # it inside a step
    waits = {s.rid: s for s in done if s.name == "sched.wait"}
    assert sorted(waits) == sorted(r.request_id for r in reqs)
    assert all(any(st.t0 <= w.t1 <= st.t1 for st in steps)
               for w in waits.values())
    if eng.chunked:
        pre = [s for s in done if s.name == "engine.prefill"]
        assert {s.rid for s in pre} == set(waits)
        assert sum(s.attr for s in pre) == eng.prefill_tokens_total
    syncs = [s for s in done if s.name == "engine.sync"]
    assert all(s.attr > 0 for s in syncs)     # bytes copied
    eng.shutdown()


def test_a_wait_stays_open_until_the_slot(rec):
    """With more requests than slots, the late ones' waits stay open
    while the early ones decode."""
    eng = _engine()
    n = eng.scheduler.n_slots + 2
    with profile(activities=[ProfilerActivity.CPU]):
        reqs = _submit(eng, n, 2, length=40, new=8)
        eng.step()
    waiting = {s.rid for s in rec.still_open() if s.name == "sched.wait"}
    assert waiting == {r.request_id for r in reqs if r.slot is None
                       or r.slot < 0}
    assert len(waiting) >= 2
    # cancelling a waiting request forgets its wait; the span stays open
    eng.cancel_request(reqs[-1])
    assert reqs[-1].request_id not in eng._slot_waits
    eng.shutdown()


def test_the_buffer_resets_at_each_new_recording(rec):
    eng = _engine()
    with profile(activities=[ProfilerActivity.CPU]):
        _submit(eng, 2, 3)
        _serve(eng)
    first = rec.finished()
    assert first
    # the spans stay readable after the recording stops; a step outside
    # any recording adds nothing
    _submit(eng, 1, 4)
    eng.step()
    assert rec.finished() == first
    _serve(eng)
    with profile(activities=[ProfilerActivity.CPU]):
        t_start = spans.time.time_ns()
        _submit(eng, 1, 5)
        _serve(eng)
    second = rec.finished()
    assert second and all(s.t0 >= t_start for s in second)
    assert not {s.sid for s in second} & {s.sid for s in first}
    eng.shutdown()


def test_spans_share_the_profilers_clock(rec):
    """A torch op run inside a span has its profiler event inside it."""
    a = torch.randn(64, 64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert rec.poll()
        sid = rec.begin("engine.step")
        torch.mm(a, a)
        rec.end(sid)
    (span,) = rec.finished()
    events = [e for e in prof.profiler.kineto_results.events()
              if e.name() == "aten::mm"]
    assert events
    for e in events:
        assert span.t0 <= e.start_ns() <= e.end_ns() <= span.t1


def test_copies_are_sync_spans_with_their_bytes(rec):
    with profile(activities=[ProfilerActivity.CPU]):
        rec.poll()
        t = spans.to_device(np.arange(6, dtype=np.int32), torch.long, "cpu")
        a = spans.to_host(t)
    assert t.dtype == torch.long and a.tolist() == list(range(6))
    assert [(s.name, s.attr) for s in rec.finished()] == [
        ("engine.sync", 48), ("engine.sync", 48)]


def test_an_exception_drops_the_spans_it_left_open(rec):
    with profile(activities=[ProfilerActivity.CPU]):
        rec.poll()
        outer = rec.begin("engine.step")
        rec.begin("engine.decode")          # never ended
        rec.end(outer)
        after = rec.begin("engine.step")
        rec.end(after)
    done = rec.finished()
    assert [s.name for s in done] == ["engine.step", "engine.step"]
    assert all(s.parent == 0 for s in done) and rec.still_open() == []
