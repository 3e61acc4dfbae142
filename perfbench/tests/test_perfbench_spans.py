"""The readers of the program's spans (``metrics/engine.*`` and
``metrics/sched.slot_wait_p95_ms.py``) on a tiny CPU run.  Under a CPU
profiler the program records its spans; the profiler also covers the
warm-up engine, so these check that each reader gives a number and that
the three times sum to the mean step, not the values.  Without a
profiler the program records nothing and each reader gives None."""
from __future__ import annotations

import pytest
from torch.profiler import ProfilerActivity, profile

import pbtiny
from pb import spec
from repro_torch.serving import engine as engine_mod
from repro_torch.serving import spans

TIMES = ("engine.forward_host_ms", "engine.sync_wait_ms",
         "engine.bookkeeping_ms")
NAMES = TIMES + ("engine.host_syncs_per_step", "sched.slot_wait_p95_ms")


@pytest.fixture
def rec(monkeypatch):
    r = spans.SpanRecorder()
    monkeypatch.setattr(spans, "RECORDER", r)
    monkeypatch.setattr(engine_mod, "RECORDER", r)
    return r


def test_span_readers_under_a_cpu_profiler(rec):
    with profile(activities=[ProfilerActivity.CPU]):
        out, _, _ = pbtiny.run("mla", seconds=3.0, trace=True,
                               per_layer=NAMES)
    m = {k: v["value"] for k, v in out["metrics"].items()}
    assert set(NAMES) <= set(m)
    steps = [s.t1 - s.t0 for s in rec.finished() if s.name == "engine.step"]
    mean_step_ms = sum(steps) / len(steps) / 1e6
    assert sum(m[k] for k in TIMES) == pytest.approx(mean_step_ms,
                                                     rel=1e-9)
    assert all(m[k] > 0 for k in TIMES)
    # every decode step copies its tokens in and the sampled ones out
    assert m["engine.host_syncs_per_step"] >= 2
    assert m["sched.slot_wait_p95_ms"] >= 0
    assert out["correct"]


def test_span_readers_give_none_without_a_profiler(rec):
    out, _, ctx = pbtiny.run("mla", seconds=3.0, trace=True,
                             per_layer=NAMES)
    assert rec.finished() == [] and rec.still_open() == []
    assert not set(NAMES) & set(out["metrics"])
    assert all(spec.metric_reader(n)(ctx) is None for n in NAMES)
