"""Host time inside the program's ``engine.sync`` spans (a copy between
host and card that waits for the stream to drain) under the window's
``engine.step`` spans, over their count, in ms: the host blocked on the
card.  Spans from ``repro_torch.serving.spans`` (``--trace 1``)."""
from pb.spec import load_module


def read(ctx):
    b = load_module("metrics", "engine.bookkeeping_ms").breakdown()
    return None if b is None else b["sync_ns"] / b["steps"] / 1e6
