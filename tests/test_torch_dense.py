"""The port's dense layout and monolithic / unfused serving paths against
the JAX package on the same numpy inputs and the same params (the JAX
``init_params`` tree crossed through ``params_from_numpy``):

* ``attention.causal_attention`` (flash prefill from position 0, plain
  attention after a prefix), ``cache_write``, ``quantize_kv`` /
  ``dequantize_kv`` and ``decode_attention`` (the paged decode kernels
  over the slot cache seen as pages, bf16 or int8), float32, 1e-4;
* ``DecoderModel.prefill`` / ``prefill_suffix`` / ``decode_step`` (bf16
  and int8 caches) on reduced llama3.2-1b with float32 params, 1e-4 on
  logits and K/V (the int8 step: exact int8 values and scales);
* the engine's A/B paths — ``paged=False``, ``chunked_prefill=False``,
  ``fused_step=False`` — generate the JAX engine's greedy tokens on the
  same bf16 params (the JAX dense cache takes only bf16 K/V) and the
  port's own default path's tokens, with the same prefill / prefix-hit
  counters; a dense-layout preemption round-trips its payload; reduced
  DeepSeek-V3 (MLA) on the same three paths, on scaled weights;
* plain attention with Q/K wider than V (the MLA suffix);
* the port's device rule: with no card, entry points raise unless given
  ``device="cpu"``.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config import reduce_config  # noqa: E402
from repro.configs import get_config  # noqa: E402
from repro.configs.paper_models import \
    DEEPSEEK_V3 as J_DEEPSEEK_V3  # noqa: E402
from repro.core.tiers import PAPER_TIER_SPECS as J_TIERS  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models.model import build_model as jax_build  # noqa: E402
from repro.serving import EngineConfig as JConfig  # noqa: E402
from repro.serving import SamplingParams as JSampling  # noqa: E402
from repro.serving import ServingEngine as JEngine  # noqa: E402
from repro.serving import sampler as jsampler  # noqa: E402
from repro_torch.config import reduce_config as t_reduce  # noqa: E402
from repro_torch.configs import get_config as t_get  # noqa: E402
from repro_torch.configs.paper_models import \
    DEEPSEEK_V3 as T_DEEPSEEK_V3  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models.convert import (params_from_numpy,  # noqa: E402
                                        tensor_from_numpy)
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.serving import EngineConfig as TConfig  # noqa: E402
from repro_torch.serving import SamplingParams as TSampling  # noqa: E402
from repro_torch.serving import ServingEngine as TEngine  # noqa: E402
from repro_torch.serving import engine as t_engine  # noqa: E402
from repro_torch.serving.kvcache import (PagedKVCache,  # noqa: E402
                                        SlotKVCache)
from repro_torch.serving import sampler  # noqa: E402

import test_torch_moe as moe_tests  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
# the JAX engine prices block recompute at the TPU v5e bf16 peak
JAX_RECOMPUTE_FLOPS = 197e12
COUNTERS = ("prefill_chunks", "cow_share_hits", "inject_hits",
            "segment_chunks", "paged", "chunked", "fused")


def _rand(rng, shape):
    return rng.normal(size=shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(t, j, **tol):
    np.testing.assert_allclose(t.detach().float().numpy(),
                               np.asarray(j, np.float32), **(tol or TOL))


# ---------------------------------------------------------------------------
# attention building blocks
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("sq,sk,q_offset", [(40, 40, 0), (24, 40, 16),
                                            (1, 33, 32)])
def test_causal_attention_matches_jax(sq, sk, q_offset):
    """From position 0 over its own keys (the flash prefill op) and as a
    suffix after a cached prefix (plain attention), GQA 4/2."""
    rng = np.random.default_rng(0)
    q, k, v = (_rand(rng, (2, sq, 4, 16)), _rand(rng, (2, sk, 2, 16)),
               _rand(rng, (2, sk, 2, 16)))
    out = attn.causal_attention(_t(q), _t(k), _t(v), q_offset=q_offset)
    _close(out, jattn.causal_attention(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), q_offset=q_offset))


def test_causal_attention_unequal_widths_matches_jax():
    """Plain attention after a cached prefix with Q/K wider than V (the
    MLA suffix: 16 + 8 over 16 here, 192 over 128 at DeepSeek-V3
    width): the output takes V's width, the scale Q's."""
    rng = np.random.default_rng(9)
    q, k, v = (_rand(rng, (2, 12, 4, 24)), _rand(rng, (2, 30, 4, 24)),
               _rand(rng, (2, 30, 4, 16)))
    out = attn.causal_attention(_t(q), _t(k), _t(v), q_offset=18)
    assert out.shape == (2, 12, 4, 16)
    _close(out, jattn.causal_attention(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), q_offset=18))


def test_cache_write_matches_jax():
    """One token per row at its length, in place; a length past the
    cache clamps to the last slot as ``dynamic_update_slice`` does."""
    rng = np.random.default_rng(1)
    cache, new = _rand(rng, (3, 8, 2, 4)), _rand(rng, (3, 1, 2, 4))
    lengths = np.asarray([0, 5, 11], np.int32)
    tc = _t(cache)
    got = attn.cache_write(tc, _t(new), _t(lengths))
    assert got is tc
    _close(got, jattn.cache_write(jnp.asarray(cache), jnp.asarray(new),
                                  jnp.asarray(lengths)), rtol=0, atol=0)


def test_quantize_kv_matches_jax():
    rng = np.random.default_rng(2)
    x = _rand(rng, (3, 5, 2, 16)) * 3.0
    x[0, 0, 0] = 0.0                            # an all-zero row
    x[1, 2, 1, 3] = 127.5 / 127.0               # a half-way rounding case
    q, s = attn.quantize_kv(_t(x))
    jq, js = jattn.quantize_kv(jnp.asarray(x))
    assert q.dtype == torch.int8 and s.dtype == torch.bfloat16
    assert np.array_equal(q.numpy(), np.asarray(jq))
    assert np.array_equal(s.float().numpy(),
                          np.asarray(js.astype(jnp.float32)))
    _close(attn.dequantize_kv(q, s, torch.float32),
           jattn.dequantize_kv(jq, js, jnp.float32), rtol=0, atol=0)


@pytest.mark.parametrize("s_len", [48, 40, 64])
def test_slot_pages_view_identity(s_len):
    """The slot cache seen as pages is a free view whose identity table
    addresses row b's tokens in order."""
    rng = np.random.default_rng(3)
    cache = _t(_rand(rng, (3, s_len, 2, 4)))
    (pages,), tables = attn.slot_pages(cache)
    page = pages.shape[1]
    assert page == {48: 16, 40: 8, 64: 64}[s_len]
    assert tables.shape == (3, s_len // page)
    assert pages.data_ptr() == cache.data_ptr()
    assert tables.dtype == torch.int32
    for b in range(3):
        got = pages[tables[b].long()].reshape(s_len, 2, 4)
        assert torch.equal(got, cache[b])


@pytest.mark.parametrize("int8", [False, True])
def test_decode_attention_matches_jax(int8):
    """The paged decode op over the slot cache (int8: the int8 op over
    int8 values and bf16 scales) against the JAX dense decode attention
    (int8: over ``dequantize_kv``, whose bf16 product is exact for these
    values up to the bf16 rounding the tolerance covers)."""
    rng = np.random.default_rng(4)
    b, s_len, hq, hkv, hd = 3, 48, 4, 2, 16
    q = _rand(rng, (b, 1, hq, hd))
    k, v = _rand(rng, (b, s_len, hkv, hd)), _rand(rng, (b, s_len, hkv, hd))
    lengths = np.asarray([1, 30, 48], np.int32)
    if not int8:
        out = attn.decode_attention(_t(q), _t(k), _t(v), _t(lengths))
        jout = jattn.decode_attention(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), jnp.asarray(lengths))
        _close(out, jout)
        return
    kq, ks = jattn.quantize_kv(jnp.asarray(k))
    vq, vs = jattn.quantize_kv(jnp.asarray(v))
    out = attn.decode_attention(
        _t(q), _t(kq), _t(vq), _t(lengths),
        tensor_from_numpy(np.asarray(ks), "cpu"),
        tensor_from_numpy(np.asarray(vs), "cpu"))
    jout = jattn.decode_attention(
        jnp.asarray(q), jattn.dequantize_kv(kq, ks, jnp.float32),
        jattn.dequantize_kv(vq, vs, jnp.float32), jnp.asarray(lengths))
    # bf16 rounding of the JAX package's dequantized product: one bf16
    # step (2^-8 relative) of |k|, |v| < 4 moves an output by < 2^-5
    _close(out, jout, rtol=0, atol=2.0 ** -5)


# ---------------------------------------------------------------------------
# the model's dense entry points
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def models():
    jcfg = reduce_config(get_config("llama3.2-1b"))
    jp = jax.tree.map(lambda a: a.astype(jnp.float32),
                      jax_build(jcfg).init_params(jax.random.PRNGKey(0)))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, jp, t_reduce(t_get("llama3.2-1b")), tp


def test_decode_state_specs_match_jax(models):
    jcfg, _, tcfg, _ = models
    for kv_dtype in ("bfloat16", "int8"):
        jspec = jax_build(jcfg, kv_dtype=kv_dtype).abstract_decode_state(
            3, 32)
        state = build_model(tcfg, kv_dtype=kv_dtype).init_decode_state(
            3, 32, device="cpu")
        assert set(state) == set(jspec)
        for key, sds in jspec.items():
            assert tuple(state[key].shape) == sds.shape, key
            assert str(state[key].dtype) == f"torch.{sds.dtype}", key


def test_prefill_and_suffix_match_jax(models):
    """Monolithic prefill (logits of the last position, K/V of every
    token), then the suffix after a 24-token cached prefix: the same
    logits as the whole prompt's prefill."""
    jcfg, jp, tcfg, tp = models
    jm, tm = jax_build(jcfg), build_model(tcfg)
    toks = np.random.default_rng(5).integers(0, 256, (2, 40)).astype(
        np.int32)
    jl, js = jm.prefill(jp, {"tokens": jnp.asarray(toks)})
    tl, ts = tm.prefill(tp, {"tokens": _t(toks)})
    _close(tl, jl)
    for key in ("k", "v"):
        _close(ts[key], js[key])
    assert torch.equal(ts["lengths"], torch.full((2,), 40,
                                                 dtype=torch.int32))
    pre = 24
    jl2, jkv = jm.prefill_suffix(jp, {"tokens": jnp.asarray(toks[:, pre:])},
                                 (js["k"][:, :, :pre], js["v"][:, :, :pre]),
                                 pre)
    tl2, tkv = tm.prefill_suffix(tp, {"tokens": _t(toks[:, pre:])},
                                 (ts["k"][:, :, :pre], ts["v"][:, :, :pre]),
                                 pre)
    _close(tl2, jl2)
    _close(tl2, tl)
    for mine, ref in zip(tkv, jkv):
        _close(mine, ref)


@pytest.mark.parametrize("kv_dtype", ["bfloat16", "int8"])
def test_decode_step_matches_jax(models, kv_dtype):
    """One dense decode step over a float32 (or int8 + bf16 scales)
    slot state with a fresh row, a mid row and a row at the last slot;
    the state is written in place and lengths advance."""
    jcfg, jp, tcfg, tp = models
    jm = jax_build(jcfg, kv_dtype=kv_dtype)
    tm = build_model(tcfg, kv_dtype=kv_dtype)
    rng = np.random.default_rng(6)
    shape = (tcfg.n_layers, 3, 48, tcfg.n_kv_heads, tcfg.hd)
    k, v = _rand(rng, shape), _rand(rng, shape)
    lengths = np.asarray([0, 17, 47], np.int32)
    tokens = np.asarray([3, 200, 41], np.int32)
    if kv_dtype == "int8":
        (kq, ks), (vq, vs) = (jattn.quantize_kv(jnp.asarray(a))
                              for a in (k, v))
        jstate = {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
    else:
        jstate = {"k": jnp.asarray(k), "v": jnp.asarray(v)}
    jstate["lengths"] = jnp.asarray(lengths)
    tstate = {key: tensor_from_numpy(np.asarray(a), "cpu")
              for key, a in jstate.items()}
    jl, jnew = jm.decode_step(jp, jstate, jnp.asarray(tokens))
    tl, tnew = tm.decode_step(tp, tstate, _t(tokens))
    _close(tl, jl)
    assert torch.equal(tnew["lengths"], _t(lengths + 1))
    for key in jstate:
        if key == "lengths":
            continue
        assert tnew[key] is tstate[key]          # written in place
        if kv_dtype == "int8":
            assert np.array_equal(tnew[key].float().numpy(),
                                  np.asarray(jnew[key], np.float32)), key
        else:
            _close(tnew[key], jnew[key])


def test_mla_dense_paths_raise():
    """MLA's dense layout and monolithic prefill are ported (they raised
    before): the model gives a latent slot state and a prefill, and the
    engine flags that need them select their paths."""
    cfg = t_reduce(T_DEEPSEEK_V3)
    m = build_model(cfg)
    state = m.init_decode_state(2, 32, device="cpu")
    assert set(state) == {"latent", "lengths"}
    assert state["latent"].shape == (cfg.n_layers, 2, 32,
                                      cfg.d_latent + cfg.d_rope)
    params = m.init_params(0, device="cpu", dtype=torch.float32)
    logits, st = m.prefill(params, {"tokens": torch.zeros(
        (1, 4), dtype=torch.int32)})
    assert logits.shape == (1, cfg.vocab_size)
    assert st["latent"].shape == (cfg.n_layers, 1, 4,
                                  cfg.d_latent + cfg.d_rope)
    for flags, paged, chunked in ((dict(paged=False), False, False),
                                  (dict(chunked_prefill=False), True, False),
                                  (dict(fused_step=False), True, True)):
        eng = TEngine(cfg, TConfig(max_len=128, kv_budget_bytes=4e6,
                                   **flags), device="cpu")
        assert (eng.paged, eng.chunked) == (paged, chunked)
        eng.shutdown()


@pytest.mark.parametrize("flag", ["dense", "monolithic", "unfused"])
def test_mla_ab_path_matches_jax_engine(monkeypatch, flag):
    """Reduced DeepSeek-V3 on each A/B path: greedy tokens and counters
    equal the JAX engine's (``test_torch_moe.assert_engines_agree``: on
    layer weights scaled x8, bf16 on the dense slots, where the two may
    part only at a near tie)."""
    jcfg = dataclasses.replace(reduce_config(J_DEEPSEEK_V3),
                               kv_block_tokens=16)
    tcfg = dataclasses.replace(t_reduce(T_DEEPSEEK_V3), kv_block_tokens=16)
    waves = moe_tests.engine_waves()
    jax_run, port_run = moe_tests.serve_pair(
        monkeypatch, jcfg, tcfg, moe_tests.FLAGS[flag], waves,
        **moe_tests.ENGINE_KW)
    moe_tests.assert_engines_agree(waves, jax_run, port_run,
                                   bf16=flag == "dense")
    st = port_run[1]
    assert st["cow_share_hits"] + st["inject_hits"] > 0
    assert (st["monolithic_prefills"] > 0) == (flag != "unfused")


def test_sample_matches_jax_on_deterministic_rows():
    """Greedy, top-k = 1 and a tiny top-p leave one candidate: the
    per-request sampler picks the JAX sampler's token."""
    logits = np.random.default_rng(7).normal(size=(3, 50)).astype(
        np.float32)
    gen = torch.Generator().manual_seed(0)
    for kw in (dict(), dict(temperature=0.7, top_k=1),
               dict(temperature=1.3, top_p=1e-6)):
        got = sampler.sample(_t(logits), gen, **kw)
        ref = jsampler.sample(jnp.asarray(logits), jax.random.PRNGKey(0),
                              **kw)
        assert got.dtype == torch.int32
        assert got.tolist() == np.asarray(ref).tolist()


# ---------------------------------------------------------------------------
# the engine's A/B paths
# ---------------------------------------------------------------------------
@pytest.fixture(autouse=True)
def _jax_recompute_constant(monkeypatch):
    monkeypatch.setattr(t_engine, "H100_BF16_PEAK_FLOPS", JAX_RECOMPUTE_FLOPS)


def _pair(block_tokens=0, **ecfg):
    """(JAX engine, port engine) on the same bf16 params and tiers."""
    jcfg = reduce_config(get_config("llama3.2-1b"))
    tcfg = t_reduce(t_get("llama3.2-1b"))
    if block_tokens:
        jcfg = dataclasses.replace(jcfg, kv_block_tokens=block_tokens)
        tcfg = dataclasses.replace(tcfg, kv_block_tokens=block_tokens)
    params = jax_build(jcfg).init_params(jax.random.PRNGKey(0))
    jeng = JEngine(jcfg, JConfig(tier_specs=J_TIERS, **ecfg), params=params)
    teng = TEngine(tcfg, TConfig(**ecfg), device="cpu",
                   params=params_from_numpy(jax.tree.map(np.asarray, params),
                                            device="cpu"))
    return jeng, teng


def _serve(eng, waves, sampling):
    reqs = []
    for prompts in waves:
        reqs += [eng.submit(p, params=sampling(max_new_tokens=5))
                 for p in prompts]
        eng.run()
    eng.shutdown()
    return [list(r.generated) for r in reqs], eng.stats()


def _words(rng, n):
    return [int(t) for t in rng.integers(0, 250, size=n)]


def _batch_waves():
    rng = np.random.default_rng(7)
    return [[_words(rng, 48) for _ in range(4)]]


def _prefix_waves():
    """A, then B sharing A's first two 16-token blocks: B's prefix is a
    CoW page map (paged) or a payload injection (dense), and its suffix
    prefills after the cached prefix."""
    rng = np.random.default_rng(8)
    prefix = _words(rng, 32)
    return [[prefix + _words(rng, 21)], [prefix + _words(rng, 13)]]


WORKLOADS = {
    "batch": (_batch_waves, dict(max_len=128, kv_budget_bytes=5e5)),
    "prefix": (_prefix_waves, dict(block_tokens=16, page_tokens=16,
                                   max_len=128, kv_budget_bytes=4e6)),
}
FLAGS = {"dense": dict(paged=False),
         "monolithic": dict(chunked_prefill=False),
         "unfused": dict(fused_step=False)}


@pytest.mark.parametrize("workload", sorted(WORKLOADS))
@pytest.mark.parametrize("flag", sorted(FLAGS))
def test_ab_path_matches_jax_engine(flag, workload):
    """Greedy tokens and prefill / prefix-hit counters of each A/B path
    equal the JAX engine's on the same params and prompts."""
    waves_fn, kw = WORKLOADS[workload]
    jeng, teng = _pair(**kw, **FLAGS[flag])
    jtoks, jst = _serve(jeng, waves_fn(), JSampling)
    ttoks, tst = _serve(teng, waves_fn(), TSampling)
    assert ttoks == jtoks
    assert all(len(t) == 5 for t in ttoks)
    for key in COUNTERS:
        assert tst[key] == jst[key], key
    if workload == "prefix":
        assert tst["cow_share_hits"] + tst["inject_hits"] > 0


@pytest.mark.parametrize("workload", sorted(WORKLOADS))
@pytest.mark.parametrize("flag", sorted(FLAGS))
def test_ab_path_matches_jax_engine_on_scaled_weights(monkeypatch, flag,
                                                      workload):
    """The same workloads and paths with the layer weights scaled x8 but
    for the attention score path (``test_torch_moe.engine_params``):
    greedy tokens that are mostly no echo, equal to the JAX engine's
    (bf16 on the dense slots, where the two may part only at a near
    tie), and equal counters."""
    waves_fn, kw = WORKLOADS[workload]
    kw = dict(kw)
    block = kw.pop("block_tokens", 0)
    jcfg = reduce_config(get_config("llama3.2-1b"))
    tcfg = t_reduce(t_get("llama3.2-1b"))
    if block:
        jcfg = dataclasses.replace(jcfg, kv_block_tokens=block)
        tcfg = dataclasses.replace(tcfg, kv_block_tokens=block)
    waves = waves_fn()
    jax_run, port_run = moe_tests.serve_pair(monkeypatch, jcfg, tcfg,
                                             FLAGS[flag], waves, **kw)
    moe_tests.assert_engines_agree(waves, jax_run, port_run,
                                   bf16=flag == "dense")
    if workload == "prefix":
        st = port_run[1]
        assert st["cow_share_hits"] + st["inject_hits"] > 0


@pytest.mark.parametrize("flag", sorted(FLAGS))
def test_ab_path_matches_port_default_path(flag):
    """Each A/B path generates the port's default (paged, chunked,
    fused) path's greedy tokens."""
    waves_fn, kw = WORKLOADS["prefix"]
    outs = []
    for flags in (FLAGS[flag], {}):
        _, teng = _pair(**kw, **flags)
        outs.append(_serve(teng, waves_fn(), TSampling)[0])
    assert outs[0] == outs[1]


def test_dense_preempt_restore_matches_jax():
    """Preempt mid-decode on the dense layout: the slot's KV leaves as a
    tier payload (bf16 bits as uint16 here), is restored by an async
    tier fetch, and decodes the same tokens as the JAX engine."""
    prompt = list(range(40, 168))
    outs = []
    for eng, sampling in zip(_pair(paged=False, max_len=256,
                                   kv_budget_bytes=32e6),
                             (JSampling, TSampling)):
        ref = eng.submit(prompt, params=sampling(max_new_tokens=8))
        eng.run()
        req = eng.submit(prompt, params=sampling(max_new_tokens=8))
        eng.step()
        eng.preempt(req)
        payload = eng._preempted_payloads[req.request_id][0]
        assert eng.worker.drain(5.0)
        eng._poll_transfers()
        eng.run()
        assert req.generated == ref.generated
        eng.shutdown()
        outs.append((req.generated, payload.shape, payload.nbytes,
                     payload.dtype.itemsize))
    assert outs[0] == outs[1]


def test_dense_preempt_restore_matches_jax_on_scaled_weights():
    """The dense-layout preemption on bf16 weights scaled x8 but for the
    attention score path: the restored request decodes its reference
    run's tokens in each engine, most of them no echo, and the two
    engines' tokens and payloads agree."""
    jcfg = reduce_config(get_config("llama3.2-1b"))
    tcfg = t_reduce(t_get("llama3.2-1b"))
    params = moe_tests.engine_params(jcfg, {"paged": False})
    kw = dict(paged=False, max_len=256, kv_budget_bytes=32e6)
    engines = (JEngine(jcfg, JConfig(tier_specs=J_TIERS, **kw),
                       params=params),
               TEngine(tcfg, TConfig(**kw), device="cpu",
                       params=params_from_numpy(
                           jax.tree.map(np.asarray, params), device="cpu")))
    prompt = list(range(40, 168))
    outs = []
    for eng, sampling in zip(engines, (JSampling, TSampling)):
        ref = eng.submit(prompt, params=sampling(max_new_tokens=8))
        eng.run()
        req = eng.submit(prompt, params=sampling(max_new_tokens=8))
        eng.step()
        eng.preempt(req)
        payload = eng._preempted_payloads[req.request_id][0]
        assert eng.worker.drain(5.0)
        eng._poll_transfers()
        eng.run()
        assert req.generated == ref.generated
        eng.shutdown()
        moe_tests.assert_no_echo([[prompt]], [req.generated])
        outs.append((req.generated, payload.shape, payload.nbytes,
                     payload.dtype.itemsize))
    assert outs[0] == outs[1]


# ---------------------------------------------------------------------------
# the device rule
# ---------------------------------------------------------------------------
def test_entry_points_need_cuda_or_explicit_cpu(monkeypatch):
    """No card: every entry point that makes tensors raises unless it is
    given a device; ``device="cpu"`` works."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = t_reduce(t_get("llama3.2-1b"))
    model = build_model(cfg)
    tree = {"a": np.ones((2, 3), np.float32)}
    calls = [lambda **kw: model.init_params(0, **kw),
             lambda **kw: model.init_decode_state(2, 16, **kw),
             lambda **kw: params_from_numpy(tree, **kw),
             lambda **kw: tensor_from_numpy(tree["a"], **kw),
             lambda **kw: SlotKVCache(model, 2, 16, **kw),
             lambda **kw: PagedKVCache(model, 2, 64, page_tokens=16, **kw)]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
        assert call(device="cpu") is not None
    assert params_from_numpy(tree, device="cpu")["a"].device.type == "cpu"
