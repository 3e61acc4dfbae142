"""The plain reference (``reference/<model_type>.py`` on
``reference/forward.py``) held to the port's CPU path at a tiny size,
float32 on both sides: every position's logits of the MLA
configuration, and of the MoE configuration with the port's capacity
rule over one dispatch group; then the control (the reference in
float8) judged by the comparison and verdict that pass the port's own
served tokens of a tiny cell, and found not correct."""
from __future__ import annotations

import math

import pytest

import pbtiny

torch = pytest.importorskip("torch")


def port_logits(kind, params, tokens):
    from pb import spec
    from repro_torch.models.model import build_model
    cfg = spec.model_config(pbtiny.config(kind), "tiny-" + kind)
    model = build_model(cfg)
    t = torch.as_tensor([tokens], dtype=torch.int32)
    pos = torch.arange(len(tokens))[None]
    with torch.no_grad():
        x, _ = model._forward_layers(params, t, pos, backend="torch")
        return model._logits(params, x)[0].float()


@pytest.mark.parametrize("kind", ["mla", "moe"])
def test_reference_equals_the_port_on_the_cpu(kind):
    from reference import forward
    c = pbtiny.config(kind)
    params = pbtiny.params(kind, 11, dtype=torch.float32)
    g = torch.Generator().manual_seed(3)
    tokens = torch.randint(1, c["vocab_size"], (200,), generator=g).tolist()
    ours = port_logits(kind, params, tokens)
    cap = None
    if kind == "moe":
        k, e = c["num_experts_per_tok"], c["num_local_experts"]
        cf = c["assumed"]["capacity_factor"]

        def cap(n):      # the port's: one group of n tokens
            return max(4, math.ceil(n * k / e * cf))
    ref = forward.load(c, params, "fp32").logits([tokens], [0], "cpu",
                                                 capacity=cap)[0]
    scale = ref.abs().max()
    assert float((ours - ref).abs().max() / scale) < 2e-4
    assert torch.equal(ours.argmax(-1), ref.argmax(-1))


def test_control_fails_where_the_port_passes():
    """At a tiny cell's size the float8 control's picks, at the
    positions of longer prompts than the cell serves, read far above the
    limit that the port's served tokens keep, and the verdict calls them
    not correct."""
    from pb import check
    from reference import forward
    out, _, ctx = pbtiny.run("mla", seconds=3.0, seed=2**31 + 9)
    assert out["correct"]
    gap = ctx.check["gap_max"]
    params = pbtiny.params("mla", 2**31 + 9)
    c = pbtiny.config("mla")
    g = torch.Generator().manual_seed(5)
    samples = [check.Sample(
        torch.randint(1, c["vocab_size"], (n,), generator=g).tolist(),
        torch.randint(1, c["vocab_size"], (40,), generator=g).tolist())
        for n in (300, 520)]
    picks = check.control_picks(forward.load(c, params, "fp8"), samples,
                                "cpu")
    got = check.served_gap(forward.load(c, params, "fp32"), samples, "cpu",
                           chosen=picks)
    limit = out["check"]["served_gap"]["limit"]
    assert gap <= limit < got["gap_max"]
    assert not check.verdict(got["gap_max"], limit)


def test_control_run_reads_not_correct():
    """The path ``readings.py`` takes: one run whose sample is judged,
    then the float8 reference put in the program's place on the same
    sample, through the same comparison and verdict."""
    out, lines, ctx = pbtiny.run("mla", seconds=3.0, seed=2**31 + 9,
                                 control=True)
    assert out["correct"]
    assert ctx.check["control_correct"] is False, lines
    assert ctx.check["control"] > out["check"]["served_gap"]["limit"]
    assert any(ln.startswith("control served_gap") and
               ln.endswith("NOT correct") for ln in lines)
    assert lines[-1].startswith("check served_gap")


@pytest.mark.parametrize("kind", ["mla", "moe"])
def test_each_family_has_its_reference(kind):
    """``load`` finds ``reference/<model_type>.py`` by the configuration's
    ``model_type``."""
    from reference import forward
    c = pbtiny.config(kind)
    ref = forward.load(c, {}, "fp32")
    assert type(ref).__module__ == "reference." + c["model_type"]
    assert isinstance(ref, forward.Reference)
