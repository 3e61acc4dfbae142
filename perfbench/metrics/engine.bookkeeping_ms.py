"""Host time of ``ServingEngine.step`` outside the model's launches and
the waits for the card, over the window's steps, in ms: the
``engine.step`` spans less their ``model.forward`` and ``engine.sync``
spans.  Once a wait has returned the stream is empty, so this host work
leaves the card idle.  With ``engine.forward_host_ms`` and
``engine.sync_wait_ms`` it sums to the mean ``engine.step`` span.

The spans are the program's (``repro_torch.serving.spans``), kept while
the profiler records (``--trace 1``); ``breakdown`` is None where there
are none: an untraced run, or a program that records no spans."""


def breakdown():
    """Sums over the finished ``engine.step`` spans and the spans under
    them: ``steps``, ``step_ns``; ``forward_ns``, the ``model.forward``
    spans less the ``engine.sync`` spans under them; ``sync_ns`` and
    ``syncs``, the ``engine.sync`` spans.  None without a step."""
    try:
        from repro_torch.serving.spans import RECORDER
    except ImportError:
        return None
    spans = RECORDER.finished()
    by_id = {s.sid: s for s in spans}
    steps = [s for s in spans if s.name == "engine.step"]
    if not steps:
        return None
    out = {"steps": len(steps), "step_ns": sum(s.t1 - s.t0 for s in steps),
           "forward_ns": 0, "sync_ns": 0, "syncs": 0}
    for s in spans:
        if s.name not in ("model.forward", "engine.sync"):
            continue
        up = []
        a = s
        while a.parent in by_id:
            a = by_id[a.parent]
            up.append(a.name)
        if not up or up[-1] != "engine.step":
            continue
        d = s.t1 - s.t0
        if s.name == "model.forward":
            out["forward_ns"] += d
            continue
        out["sync_ns"] += d
        out["syncs"] += 1
        if "model.forward" in up:
            out["forward_ns"] -= d
    return out


def read(ctx):
    b = breakdown()
    if b is None:
        return None
    return (b["step_ns"] - b["forward_ns"] - b["sync_ns"]) / b["steps"] / 1e6
