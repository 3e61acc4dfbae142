"""Nearest-rank 95th percentile of the program's ``sched.wait`` spans
(``ServingEngine.submit`` to the request's first slot) over the requests
submitted before the last ``engine.step`` span's end, in ms; a wait
still open then counts to it.  Spans from ``repro_torch.serving.spans``
(``--trace 1``); None where there are none."""
from pb.readers import pctl


def read(ctx):
    try:
        from repro_torch.serving.spans import RECORDER
    except ImportError:
        return None
    done = RECORDER.finished()
    close = max((s.t1 for s in done if s.name == "engine.step"), default=None)
    if close is None:
        return None
    waits = [(s.t0, s.t1) for s in done if s.name == "sched.wait"]
    waits += [(s.t0, close) for s in RECORDER.still_open()
              if s.name == "sched.wait"]
    v = pctl([min(t1, close) - t0 for t0, t1 in waits if t0 <= close], 0.95)
    return None if v is None else v / 1e6
