"""A run with the timed path broken underneath comes out not correct:
the harness's look for a card is skipped and the rest of a run (weights,
warm-up, the window, the check) is driven on the CPU at a tiny size,
once for each fault a serving cell can have.  A one-chip cell has no
exchange between chips to leave out."""
from __future__ import annotations

import pytest

import pbtiny

torch = pytest.importorskip("torch")


def _token_altered(mp):
    """A served token altered where it is produced (the sampler)."""
    from repro_torch.serving import engine
    inner = engine.sampler_mod.sample_batched
    vocab = pbtiny.config("mla")["vocab_size"]
    mp.setattr(engine.sampler_mod, "sample_batched",
               lambda *a, **k: (inner(*a, **k) + 1) % vocab)


def _state_unchanged(mp):
    """A prefill step that leaves the KV pool as it was."""
    from repro_torch.serving import kvcache
    mp.setattr(kvcache.PagedKVCache, "_scatter", lambda *a, **k: None)


def _half_batch(mp):
    """Half of the decode batch left out: the first half of the rows get
    no logits of their own."""
    from repro_torch.models.model import DecoderModel
    inner = DecoderModel.decode_step_paged

    def step(self, params, state, tokens, backend=None):
        lg, st = inner(self, params, state, tokens, backend)
        lg = lg.clone()
        lg[:lg.shape[0] // 2] = 0
        return lg, st
    mp.setattr(DecoderModel, "decode_step_paged", step)


def test_clean_run_is_correct():
    out, _, ctx = pbtiny.run("mla", seconds=3.0)
    assert out["correct"] and ctx.check["positions"] > 0


@pytest.mark.parametrize("fault", [_token_altered, _state_unchanged,
                                   _half_batch])
def test_fault_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    out, lines, ctx = pbtiny.run("mla", seconds=3.0)
    assert not out["correct"], (fault.__name__, lines)
    assert out["failed"] >= 1 and ctx.check["positions"] > 0
