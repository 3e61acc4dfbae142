"""The port's ``ServingEngine`` against the JAX ``ServingEngine`` on the
same float32 params (the JAX ``init_params`` tree crossed through
numpy), the same tier specs and the same block-recompute constant:
greedy tokens identical, and equal prefill-chunk, CoW-share and
segment-chunk counts, on three workloads — the 4 x 48-token batch of
``tests/test_paged_serving.py``, a shared-prefix pair, and a segment-
reuse pair.  Also the port's own contract: no CUDA means the engine
raises unless given ``device="cpu"``, the A/B flags select their paths,
and bf16 tier payloads travel as uint16 bits."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config import reduce_config  # noqa: E402
from repro.configs import get_config  # noqa: E402
from repro.core.tiers import PAPER_TIER_SPECS as J_TIERS  # noqa: E402
from repro.models.model import build_model as jax_build  # noqa: E402
from repro.serving import EngineConfig as JConfig  # noqa: E402
from repro.serving import SamplingParams as JSampling  # noqa: E402
from repro.serving import ServingEngine as JEngine  # noqa: E402
from repro_torch.config import reduce_config as t_reduce  # noqa: E402
from repro_torch.configs import get_config as t_get  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.serving import EngineConfig as TConfig  # noqa: E402
from repro_torch.serving import SamplingParams as TSampling  # noqa: E402
from repro_torch.serving import ServingEngine as TEngine  # noqa: E402
from repro_torch.serving import engine as t_engine  # noqa: E402
from repro_torch.serving.kvcache import (payload_from_tensor,  # noqa: E402
                                         tensor_from_payload)

import test_torch_moe as moe_tests  # noqa: E402

COUNTERS = ("prefill_chunks", "cow_share_hits", "segment_chunks",
            "segment_share_hits", "inject_hits")
# the JAX engine prices block recompute at the TPU v5e bf16 peak
JAX_RECOMPUTE_FLOPS = 197e12


@pytest.fixture(autouse=True)
def _jax_recompute_constant(monkeypatch):
    monkeypatch.setattr(t_engine, "H100_BF16_PEAK_FLOPS", JAX_RECOMPUTE_FLOPS)


def _pair(block_tokens=0, **ecfg):
    """(JAX engine, port engine) on the same f32 params and tiers."""
    jcfg = reduce_config(get_config("llama3.2-1b"))
    tcfg = t_reduce(t_get("llama3.2-1b"))
    if block_tokens:
        jcfg = dataclasses.replace(jcfg, kv_block_tokens=block_tokens)
        tcfg = dataclasses.replace(tcfg, kv_block_tokens=block_tokens)
    params = jax.tree.map(lambda a: a.astype(jnp.float32),
                          jax_build(jcfg).init_params(jax.random.PRNGKey(0)))
    jeng = JEngine(jcfg, JConfig(tier_specs=J_TIERS, **ecfg), params=params)
    teng = TEngine(tcfg, TConfig(**ecfg),
                   params=params_from_numpy(jax.tree.map(np.asarray, params),
                                            device="cpu"),
                   device="cpu")
    return jeng, teng


def _run(eng, batches, sampling):
    """Submit each batch of prompts, then run to completion."""
    reqs = []
    for prompts in batches:
        reqs += [eng.submit(p, params=sampling(max_new_tokens=5))
                 for p in prompts]
        eng.run()
    eng.shutdown()
    return [list(r.generated) for r in reqs], eng.stats()


def _assert_same(batches, **kw):
    jeng, teng = _pair(**kw)
    jtoks, jst = _run(jeng, batches, JSampling)
    ttoks, tst = _run(teng, batches, TSampling)
    assert ttoks == jtoks
    assert all(len(t) == 5 for t in ttoks)
    for key in COUNTERS:
        assert tst[key] == jst[key], key
    return tst


def test_engine_batch_matches_jax():
    rng = np.random.default_rng(7)
    prompts = [[int(t) for t in rng.integers(0, 250, size=48)]
               for _ in range(4)]
    st = _assert_same([prompts], max_len=128, kv_budget_bytes=5e5)
    assert st["prefill_chunks"] > 0


def test_engine_shared_prefix_matches_jax():
    rng = np.random.default_rng(8)
    prefix = [int(t) for t in rng.integers(0, 250, size=32)]
    a = prefix + [int(t) for t in rng.integers(0, 250, size=21)]
    b = prefix + [int(t) for t in rng.integers(0, 250, size=13)]
    st = _assert_same([[a], [b]], block_tokens=16, page_tokens=16,
                      max_len=128, kv_budget_bytes=4e6)
    assert st["cow_share_hits"] > 0


def test_engine_segment_reuse_matches_jax():
    """A = [S0 S1 S2 | tail], then B = [X0 S1 S2 | tail']: B resumes S1
    and S2 mid-prompt and its gaps run through the segment kernel."""
    rng = np.random.default_rng(9)
    seg = [[int(t) for t in rng.integers(0, 250, size=16)]
           for _ in range(3)]
    x0 = [int(t) for t in rng.integers(0, 250, size=16)]
    a = seg[0] + seg[1] + seg[2] + [int(t) for t in
                                    rng.integers(0, 250, size=9)]
    b = x0 + seg[1] + seg[2] + [int(t) for t in
                                rng.integers(0, 250, size=11)]
    st = _assert_same([[a], [b]], block_tokens=16, page_tokens=16,
                      max_len=128, kv_budget_bytes=4e6)
    assert st["segment_chunks"] > 0 and st["segment_share_hits"] > 0


def _batch_waves():
    rng = np.random.default_rng(7)
    return [[[int(t) for t in rng.integers(0, 250, size=48)]
             for _ in range(4)]]


def _prefix_waves():
    rng = np.random.default_rng(8)
    prefix = [int(t) for t in rng.integers(0, 250, size=32)]
    return [[prefix + [int(t) for t in rng.integers(0, 250, size=21)]],
            [prefix + [int(t) for t in rng.integers(0, 250, size=13)]]]


def _segment_waves():
    rng = np.random.default_rng(9)
    seg = [[int(t) for t in rng.integers(0, 250, size=16)]
           for _ in range(3)]
    x0 = [int(t) for t in rng.integers(0, 250, size=16)]
    return [[seg[0] + seg[1] + seg[2]
             + [int(t) for t in rng.integers(0, 250, size=9)]],
            [x0 + seg[1] + seg[2]
             + [int(t) for t in rng.integers(0, 250, size=11)]]]


# the three workloads above on the default path, with the counter each
# must exercise
SCALED_WORKLOADS = {
    "batch": (_batch_waves, 0, dict(max_len=128, kv_budget_bytes=5e5),
              "prefill_chunks"),
    "prefix": (_prefix_waves, 16, dict(page_tokens=16, max_len=128,
                                       kv_budget_bytes=4e6),
               "cow_share_hits"),
    "segments": (_segment_waves, 16, dict(page_tokens=16, max_len=128,
                                          kv_budget_bytes=4e6),
                 "segment_share_hits"),
}


@pytest.mark.parametrize("workload", sorted(SCALED_WORKLOADS))
def test_engine_matches_jax_on_scaled_weights(monkeypatch, workload):
    """The batch, shared-prefix and segment-reuse workloads on the
    default path with the layer weights scaled x8 but for the attention
    score path (``test_torch_moe.engine_params``): greedy tokens that are
    mostly no echo of the prompt's last token, equal to the JAX engine's
    (float32 params), and equal counters."""
    waves_fn, block, kw, counter = SCALED_WORKLOADS[workload]
    jcfg = reduce_config(get_config("llama3.2-1b"))
    tcfg = t_reduce(t_get("llama3.2-1b"))
    if block:
        jcfg = dataclasses.replace(jcfg, kv_block_tokens=block)
        tcfg = dataclasses.replace(tcfg, kv_block_tokens=block)
    waves = waves_fn()
    jax_run, port_run = moe_tests.serve_pair(monkeypatch, jcfg, tcfg, {},
                                             waves, **kw)
    moe_tests.assert_engines_agree(waves, jax_run, port_run, bf16=False)
    assert port_run[1][counter] > 0


def test_engine_preempt_restore_matches_jax():
    """Preempt mid-decode: the slot's KV leaves as a tier payload (bf16
    bits as uint16 here), the async demotion lands, and the restore —
    an async tier fetch — decodes the same tokens as the JAX engine."""
    prompt = list(range(40, 168))
    outs = []
    for eng, sampling in zip(_pair(max_len=256, kv_budget_bytes=32e6),
                             (JSampling, TSampling)):
        ref = eng.submit(prompt, params=sampling(max_new_tokens=8))
        eng.run()
        req = eng.submit(prompt, params=sampling(max_new_tokens=8))
        eng.step()
        eng.preempt(req)
        payload = eng._preempted_payloads[req.request_id][0]
        assert eng.worker.drain(5.0)
        eng._poll_transfers()
        assert eng._preempted_payloads[req.request_id][0] is None
        eng.run()
        assert req.generated == ref.generated
        assert eng.stats()["scheduler"]["async_restores"] >= 1
        eng.shutdown()
        outs.append((req.generated, payload.shape, payload.nbytes))
    assert outs[0] == outs[1]


def test_engine_needs_cuda_or_explicit_cpu(monkeypatch):
    cfg = t_reduce(t_get("llama3.2-1b"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TEngine(cfg, TConfig())
    # the A/B flags select the dense, monolithic and unfused paths
    # (tests/test_torch_dense.py holds them to the JAX engine)
    for flag, attr in (("paged", "paged"), ("chunked_prefill", "chunked"),
                       ("fused_step", "fused")):
        eng = TEngine(cfg, TConfig(max_len=128, kv_budget_bytes=5e5,
                                   **{flag: False}), device="cpu")
        assert getattr(eng, attr) is False and eng.stats()[attr] is False
        eng.shutdown()
    assert not hasattr(TConfig(), "kernel_backend")
    eng = TEngine(cfg, TConfig(max_len=128, kv_budget_bytes=5e5),
                  device="cpu")
    assert eng.kernel_backend == "torch"
    assert eng.ecfg.tier_specs[0].name == "gpu_hbm"
    eng.shutdown()


def test_bf16_payload_roundtrip_as_uint16():
    rng = np.random.default_rng(10)
    t = torch.from_numpy(rng.normal(size=(2, 3, 4, 2, 8)).astype(
        np.float32)).bfloat16()
    pl = payload_from_tensor(t)
    assert pl.dtype == np.uint16 and pl.nbytes == t.numel() * 2
    # the same bits as the JAX engine's bf16 payload
    jpl = np.asarray(jnp.asarray(t.float().numpy(), jnp.bfloat16))
    assert np.array_equal(pl, jpl.view(np.uint16))
    assert torch.equal(tensor_from_payload(pl, "cpu"), t)
    f = torch.ones(3)
    assert payload_from_tensor(f).dtype == np.float32
