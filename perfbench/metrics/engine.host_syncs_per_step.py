"""The program's ``engine.sync`` spans (copies between host and card
that wait for the stream to drain) under the window's ``engine.step``
spans, over their count.  Spans from ``repro_torch.serving.spans``
(``--trace 1``)."""
from pb.spec import load_module


def read(ctx):
    b = load_module("metrics", "engine.bookkeeping_ms").breakdown()
    return None if b is None else b["syncs"] / b["steps"]
