"""Host time inside the program's ``model.forward`` spans (each call into
the model: a prefill chunk, or the decode step with the sampler's
launch), less the ``engine.sync`` spans under them, over the window's
``engine.step`` spans, in ms: the host launching the model's work.
Spans from ``repro_torch.serving.spans`` (``--trace 1``)."""
from pb.spec import load_module


def read(ctx):
    b = load_module("metrics", "engine.bookkeeping_ms").breakdown()
    return None if b is None else b["forward_ns"] / b["steps"] / 1e6
