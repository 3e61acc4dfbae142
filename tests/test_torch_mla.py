"""The port's absorbed-MLA serving path against the JAX package, on
reduced DeepSeek-V3 (2 layers, D 64, 4 heads, dl 32, dr 8):

* the three plain MLA ops (the CPU path of ``ops.mla_decode`` /
  ``mla_prefill`` / ``mla_prefill_seg``) against ``repro.kernels.ref``,
  the ``xla`` fallbacks and interpret-mode Pallas, on the same numpy
  inputs, within 1e-4 in float32;
* ``decode_step_paged`` / ``prefill_chunk`` / ``prefill_chunk_seg``
  against the JAX ``DecoderModel`` on the same converted float32 params;
* the port's ``ServingEngine`` against the JAX engine: greedy tokens
  identical and equal chunk / CoW / segment counters;
* the MLA tier payload [1, L, n, dl+dr], bf16 carried as uint16 bits;
* the dense layout: ``attention.mla_attention_prefill`` (the chunk
  prefill op at offset 0, absorbed) and ``mla_attention_decode`` (the
  decode op over the latent slots seen as pages) against the JAX
  package's, and the model's ``prefill`` / ``prefill_suffix`` /
  ``decode_step`` against the JAX ``DecoderModel``, float32, 1e-4; the
  latent slot cache's payloads.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config import reduce_config  # noqa: E402
from repro.configs.paper_models import DEEPSEEK_V3  # noqa: E402
from repro.core.tiers import PAPER_TIER_SPECS as J_TIERS  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models.model import build_model as jax_build  # noqa: E402
from repro.serving import EngineConfig as JConfig  # noqa: E402
from repro.serving import SamplingParams as JSampling  # noqa: E402
from repro.serving import ServingEngine as JEngine  # noqa: E402
from repro_torch.config import reduce_config as t_reduce  # noqa: E402
from repro_torch.configs.paper_models import \
    DEEPSEEK_V3 as T_DEEPSEEK_V3  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.serving import EngineConfig as TConfig  # noqa: E402
from repro_torch.serving import SamplingParams as TSampling  # noqa: E402
from repro_torch.serving import ServingEngine as TEngine  # noqa: E402
from repro_torch.serving import engine as t_engine  # noqa: E402
from repro_torch.serving.kvcache import (PagedKVCache,  # noqa: E402
                                        SlotKVCache)

TOL = dict(rtol=1e-4, atol=1e-4)
DL, DR = 32, 8
# the JAX engine prices block recompute at the TPU v5e bf16 peak
JAX_RECOMPUTE_FLOPS = 197e12


def _rand(rng, shape):
    return rng.normal(size=shape).astype(np.float32)


def _close(t, j, **tol):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j),
                               **(tol or TOL))


def _t(a):
    return torch.from_numpy(np.array(a))


def _cpos(rows, c):
    return np.asarray([list(r) + [-1] * (c - len(r)) for r in rows],
                      np.int32)


def _lat_inputs(rng, b, c, hq, page, pages, extra=2):
    n = b * pages + extra
    return (_rand(rng, (b, c, hq, DL)), _rand(rng, (b, c, hq, DR)),
            _rand(rng, (b, c, DL + DR)), _rand(rng, (n, page, DL + DR)),
            rng.permutation(n)[:b * pages].reshape(b, pages).astype(np.int32))


# ---------------------------------------------------------------------------
# the three plain MLA ops
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("scale", [None, 0.1])
def test_mla_decode_matches_jax(scale):
    """Ragged lengths, a full table, a zero-length row (zeros, as the
    Pallas kernel's gating gives) and default / explicit scale."""
    rng = np.random.default_rng(0)
    ql, qr, _, lp, bt = _lat_inputs(rng, 3, 1, 8, 16, 4)
    ql, qr = ql[:, 0], qr[:, 0]
    ln = np.asarray([64, 0, 23], np.int32)
    args = (ql, qr, lp, bt, ln)
    out = ops.mla_decode(*map(_t, args), d_latent=DL, scale=scale)
    jargs = [jnp.asarray(a) for a in args]
    assert torch.equal(out[1], torch.zeros_like(out[1]))
    live = [0, 2]
    for other in (jref.mla_paged_decode_ref(*jargs, d_latent=DL,
                                            scale=scale),
                  jops.mla_decode(*jargs, d_latent=DL, scale=scale,
                                  backend="xla")):
        _close(out[live], np.asarray(other)[live])
    _close(out, jops.mla_decode(*jargs, d_latent=DL, scale=scale,
                                backend="interpret"))


def test_mla_decode_clamps_table_entries():
    """Out-of-range table entries clamp into the pool (the ``xla``
    fallback's clip) and tokens past the length never reach the output."""
    rng = np.random.default_rng(1)
    ql, qr, _, lp, _ = _lat_inputs(rng, 2, 1, 4, 8, 4, extra=1)
    ql, qr = ql[:, 0], qr[:, 0]
    bt = np.asarray([[1, 2, 99, 4], [3, -7, 5, 6]], np.int32)
    ln = np.asarray([21, 13], np.int32)
    out = ops.mla_decode(*map(_t, (ql, qr, lp, bt, ln)), d_latent=DL)
    _close(out, jops.mla_decode(*map(jnp.asarray, (ql, qr, lp, bt, ln)),
                                d_latent=DL, backend="xla"))
    lp2 = lp.copy()                       # poison every slot past a length
    lp2[8, 5:] = 999.0                    # row 0: entry 99 clamps to page 8
    lp2[0, 5:] = 999.0                    # row 1: entry -7 clamps to page 0
    lp2[[4, 5, 6]] = 999.0
    out2 = ops.mla_decode(*map(_t, (ql, qr, lp2, bt, ln)), d_latent=DL)
    assert torch.allclose(out, out2, **TOL)


@pytest.mark.parametrize("offs", [(0, 19), (32, 7)])
def test_mla_prefill_matches_jax(offs):
    rng = np.random.default_rng(2)
    args = (*_lat_inputs(rng, 2, 8, 4, 8, 5), np.asarray(offs, np.int32))
    out = ops.mla_prefill(*map(_t, args), d_latent=DL)
    jargs = [jnp.asarray(a) for a in args]
    _close(out, jref.mla_paged_prefill_ref(*jargs, d_latent=DL))
    _close(out, jops.mla_prefill(*jargs, d_latent=DL, backend="xla"))
    _close(out, jops.mla_prefill(*jargs, d_latent=DL, backend="interpret"))
    scaled = ops.mla_prefill(*map(_t, args), d_latent=DL, scale=0.2)
    _close(scaled, jref.mla_paged_prefill_ref(*jargs, d_latent=DL,
                                              scale=0.2))


MLA_SEG_ROWS = [
    # two runs around a resumed island, and a ragged padded row
    ([3, 4, 5, 6, 21, 22, 23, 24], [0, 1, 2, 3, 4, 5]),
    # a run crossing a page boundary and a far gap; an all-padding row
    ([5, 6, 7, 8, 9, 30, 31, 32], []),
]


@pytest.mark.parametrize("rows", MLA_SEG_ROWS)
def test_mla_prefill_seg_matches_jax(rows):
    rng = np.random.default_rng(3)
    args = (*_lat_inputs(rng, 2, 8, 4, 8, 5), _cpos(rows, 8))
    out = ops.mla_prefill_seg(*map(_t, args), d_latent=DL)
    jargs = [jnp.asarray(a) for a in args]
    _close(out, jref.mla_paged_prefill_segments_ref(*jargs, d_latent=DL))
    _close(out, jops.mla_prefill_seg(*jargs, d_latent=DL, backend="xla"))
    _close(out, jops.mla_prefill_seg(*jargs, d_latent=DL,
                                     backend="interpret"))


def test_mla_prefill_seg_ignores_unresident_slots():
    """The chunk's own pool slots and everything past the last query
    hold garbage: it never reaches the output."""
    rng = np.random.default_rng(4)
    ql, qr, lc, lp, _ = _lat_inputs(rng, 1, 8, 4, 8, 4, extra=1)
    bt = np.arange(1, 5, dtype=np.int32)[None]
    rows = [2, 3, 4, 20, 21, 22]
    cp = _cpos([rows], 8)
    out = ops.mla_prefill_seg(*map(_t, (ql, qr, lc, lp, bt, cp)),
                              d_latent=DL)
    lp2 = lp.copy()
    for p in rows + list(range(rows[-1] + 1, 32)):
        lp2[1 + p // 8, p % 8] = 999.0
    out2 = ops.mla_prefill_seg(*map(_t, (ql, qr, lc, lp2, bt, cp)),
                               d_latent=DL)
    assert torch.allclose(out, out2, **TOL)


def test_mla_prefill_seg_contiguous_equals_offset_bitwise():
    rng = np.random.default_rng(5)
    ql, qr, lc, lp, bt = map(_t, _lat_inputs(rng, 2, 8, 4, 8, 5))
    offs = (19, 0)
    cp = _t(_cpos([[o + i for i in range(8)] for o in offs], 8))
    seg = ops.mla_prefill_seg(ql, qr, lc, lp, bt, cp, d_latent=DL)
    off = ops.mla_prefill(ql, qr, lc, lp, bt,
                          torch.tensor(offs, dtype=torch.int32), d_latent=DL)
    assert torch.equal(seg, off)


def test_mla_ops_on_cpu_tensors_refuse_cuda_backend():
    rng = np.random.default_rng(6)
    ql, qr, _, lp, bt = map(_t, _lat_inputs(rng, 1, 1, 4, 8, 2))
    with pytest.raises(ValueError, match="CUDA"):
        ops.mla_decode(ql[:, 0], qr[:, 0], lp, bt,
                       torch.tensor([3], dtype=torch.int32), d_latent=DL,
                       backend="cuda")


# ---------------------------------------------------------------------------
# model entry points
# ---------------------------------------------------------------------------
PAGE, PAGES, SLOTS = 16, 6, 3


@pytest.fixture(scope="module")
def models():
    jcfg = reduce_config(DEEPSEEK_V3)
    jm = jax_build(jcfg)
    jp = jax.tree.map(lambda a: a.astype(jnp.float32),
                      jm.init_params(jax.random.PRNGKey(0)))
    tm = build_model(t_reduce(T_DEEPSEEK_V3))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jm, jp, tm, tp


def _pool(rng, cfg, n):
    return _rand(rng, (cfg.n_layers, n, PAGE, cfg.d_latent + cfg.d_rope))


def test_mla_param_tree_matches_jax(models):
    jm, jp, tm, tp = models
    jleaves = {tuple(p.key for p in path): leaf.shape for path, leaf in
               jax.tree_util.tree_flatten_with_path(jp)[0]}
    mine = tm.init_params(0, device="cpu",
                          dtype=torch.float32)
    flat = {}

    def walk(tree, path):
        if isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, path + (k,))
        else:
            flat[path] = tuple(tree.shape)
    walk(mine, ())
    assert flat == jleaves


def test_mla_decode_step_paged_matches_jax(models):
    jm, jp, tm, tp = models
    rng = np.random.default_rng(7)
    lat = _pool(rng, tm.cfg, SLOTS * PAGES + 1)
    tables = np.zeros((SLOTS, PAGES), np.int32)
    tables[0, :4] = [3, 7, 1, 9]
    tables[2, :2] = [12, 5]
    lengths = np.asarray([50, 0, 17], np.int32)      # row 1 inactive
    tokens = np.asarray([11, 0, 200], np.int32)
    jstate = {"latent_pages": jnp.asarray(lat),
              "block_tables": jnp.asarray(tables),
              "lengths": jnp.asarray(lengths)}
    tstate = {"latent_pages": _t(lat), "block_tables": _t(tables),
              "lengths": _t(lengths)}
    jl, jnew = jm.decode_step_paged(jp, jstate, jnp.asarray(tokens),
                                    backend="xla")
    tl, tnew = tm.decode_step_paged(tp, tstate, _t(tokens))
    _close(tl[[0, 2]], np.asarray(jl)[[0, 2]])
    _close(tnew["latent_pages"], jnew["latent_pages"])
    assert tnew["latent_pages"] is tstate["latent_pages"]
    assert torch.equal(tnew["lengths"], _t(lengths + 1))


def _chunk_states(rng, cfg):
    lat = _pool(rng, cfg, PAGES + 2)
    table = np.asarray([[4, 2, 6, 1, 3, 7]], np.int32)
    return ({"latent_pages": jnp.asarray(lat),
             "block_table": jnp.asarray(table)},
            {"latent_pages": _t(lat), "block_table": _t(table)})


@pytest.mark.parametrize("offset", [0, 21])
def test_mla_prefill_chunk_matches_jax(models, offset):
    jm, jp, tm, tp = models
    rng = np.random.default_rng(8 + offset)
    js, ts = _chunk_states(rng, tm.cfg)
    toks = rng.integers(0, 256, size=(1, 16)).astype(np.int32)
    off = np.asarray([offset], np.int32)
    jout = jm.prefill_chunk(jp, js, jnp.asarray(toks), jnp.asarray(off),
                            backend="xla")
    tout = tm.prefill_chunk(tp, ts, _t(toks), _t(off))
    assert set(tout) == {"latent"}
    assert tout["latent"].shape == jout["latent"].shape
    _close(tout["latent"], jout["latent"])


def test_mla_prefill_chunk_seg_matches_jax(models):
    jm, jp, tm, tp = models
    rng = np.random.default_rng(9)
    js, ts = _chunk_states(rng, tm.cfg)
    toks = rng.integers(0, 256, size=(1, 16)).astype(np.int32)
    cpos = _cpos([[5, 6, 7, 8, 9, 10, 40, 41, 42, 43, 44, 45, 46]], 16)
    jout = jm.prefill_chunk_seg(jp, js, jnp.asarray(toks),
                                jnp.asarray(cpos), backend="xla")
    tout = tm.prefill_chunk_seg(tp, ts, _t(toks), _t(cpos))
    _close(tout["latent"], jout["latent"])


def test_build_model_takes_dense_mla_only():
    """MLA with a dense FFN, and MLA with an MoE FFN (as the JAX
    ``DecoderModel`` builds it: ``n_experts > 0`` picks the MoE specs)."""
    cfg = t_reduce(T_DEEPSEEK_V3)
    assert build_model(cfg).mla
    m = build_model(dataclasses.replace(cfg, n_experts=4, top_k=2,
                                        expert_d_ff=32))
    assert m.mla
    assert m.specs["layers"]["ffn"]["w_gate"].shape == (cfg.n_layers, 4,
                                                         cfg.d_model, 32)
    jm = jax_build(dataclasses.replace(reduce_config(DEEPSEEK_V3),
                                       n_experts=4, top_k=2, expert_d_ff=32))
    assert jm.specs["layers"]["ffn"]["w_gate"].shape == \
        m.specs["layers"]["ffn"]["w_gate"].shape


# ---------------------------------------------------------------------------
# the dense layout: monolithic prefill, suffix after a cached prefix and
# decode over the latent slot cache
# ---------------------------------------------------------------------------
def _layer(tree, i=0):
    return {k: _layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def test_mla_attention_prefill_matches_jax(models):
    """The absorbed form through the MLA chunk prefill op at offset 0
    against the JAX package's non-absorbed causal MLA, over two ragged
    prompts of 37 tokens."""
    jm, jp, tm, tp = models
    cfg = tm.cfg
    x = _rand(np.random.default_rng(12), (2, 37, cfg.d_model))
    jo, jlat = jattn.mla_attention_prefill(_layer(jp["layers"]["attn"]),
                                           jnp.asarray(x),
                                           jnp.arange(37)[None], jm.cfg)
    to, tlat = attn.mla_attention_prefill(_layer(tp["layers"]["attn"]),
                                          _t(x), cfg)
    _close(to, jo)
    _close(tlat, jlat)


def test_mla_attention_decode_matches_jax(models):
    """Absorbed decode over the latent slot cache seen as pages (the
    MLA decode op) against the JAX ``mla_attention_decode``: a fresh
    row, a mid row and a row at the last slot; the new latent is
    written in place."""
    jm, jp, tm, tp = models
    cfg = tm.cfg
    rng = np.random.default_rng(13)
    x = _rand(rng, (3, 1, cfg.d_model))
    cache = _rand(rng, (3, 48, DL + DR))
    lengths = np.asarray([1, 18, 48], np.int32)
    jo, jc = jattn.mla_attention_decode(_layer(jp["layers"]["attn"], 1),
                                        jnp.asarray(x), jnp.asarray(cache),
                                        jnp.asarray(lengths), jm.cfg)
    tc = _t(cache)
    to, tc2 = attn.mla_attention_decode(_layer(tp["layers"]["attn"], 1),
                                        _t(x), tc, _t(lengths), cfg)
    assert tc2 is tc
    _close(to, jo)
    _close(tc, jc)


def test_mla_dense_entry_points_match_jax(models):
    """``prefill`` (logits and latents of two 40-token prompts),
    ``prefill_suffix`` after a 24-token cached prefix (its plain
    attention over Q/K wider than V) and one ``decode_step`` over the
    prefill's latents, all against the JAX ``DecoderModel``."""
    jm, jp, tm, tp = models
    toks = np.random.default_rng(14).integers(0, 256, (2, 40)).astype(
        np.int32)
    jl, js = jm.prefill(jp, {"tokens": jnp.asarray(toks)})
    tl, ts = tm.prefill(tp, {"tokens": _t(toks)})
    assert set(ts) == set(js) == {"latent", "lengths"}
    _close(tl, jl)
    _close(ts["latent"], js["latent"])
    pre = 24
    jl2, (jlat,) = jm.prefill_suffix(
        jp, {"tokens": jnp.asarray(toks[:, pre:])},
        (js["latent"][:, :, :pre],), pre)
    tl2, (tlat,) = tm.prefill_suffix(tp, {"tokens": _t(toks[:, pre:])},
                                     (ts["latent"][:, :, :pre],), pre)
    _close(tl2, jl2)
    _close(tl2, tl)
    _close(tlat, jlat)
    # decode the next token over a 48-slot cache holding the prompts
    lat = np.zeros((tm.cfg.n_layers, 2, 48, DL + DR), np.float32)
    lat[:, :, :40] = np.asarray(js["latent"])
    state = {"latent": lat, "lengths": np.full((2,), 40, np.int32)}
    nxt = np.asarray([5, 77], np.int32)
    jl3, jnew = jm.decode_step(jp, {k: jnp.asarray(v)
                                    for k, v in state.items()},
                               jnp.asarray(nxt))
    tstate = {k: _t(v) for k, v in state.items()}
    tl3, tnew = tm.decode_step(tp, tstate, _t(nxt))
    _close(tl3, jl3)
    assert tnew["latent"] is tstate["latent"]
    _close(tnew["latent"], jnew["latent"])
    assert torch.equal(tnew["lengths"], torch.full((2,), 41,
                                                   dtype=torch.int32))


def test_mla_slot_cache_payloads():
    """The dense latent slots hand out [1, L, n, dl+dr] payloads (bf16
    as uint16 bits), the prefix for a suffix prefill is (latent,), and a
    payload injects back unchanged."""
    cfg = t_reduce(T_DEEPSEEK_V3)
    kv = SlotKVCache(build_model(cfg), 2, 64, device="cpu")
    assert set(kv.state) == {"latent", "lengths"}
    rng = np.random.default_rng(15)
    lat = torch.from_numpy(_rand(rng, (cfg.n_layers, 1, 40, DL + DR)))
    kv.acquire(0, 40)
    kv.write_prefill(0, {"latent": lat}, 40)
    pl = kv.extract_block(0, 8, 24)
    assert pl.shape == (1, cfg.n_layers, 24, DL + DR)
    assert pl.dtype == np.uint16
    (pre,) = kv.prefix_kv(0, 16)
    assert pre.shape == (cfg.n_layers, 1, 16, DL + DR)
    assert torch.equal(pre, lat[:, :, :16].to(torch.bfloat16))
    kv.acquire(1, 0)
    kv.inject_block(1, pl, 16)
    assert np.array_equal(kv.extract_block(1, 16, 24), pl)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------
@pytest.fixture
def _jax_recompute_constant(monkeypatch):
    monkeypatch.setattr(t_engine, "H100_BF16_PEAK_FLOPS", JAX_RECOMPUTE_FLOPS)


def _engines(**ecfg):
    """(JAX engine, port engine) on the same f32 params, 32-token blocks
    over 16-token pages so short prompts share blocks."""
    jcfg = dataclasses.replace(reduce_config(DEEPSEEK_V3), kv_block_tokens=32)
    tcfg = dataclasses.replace(t_reduce(T_DEEPSEEK_V3), kv_block_tokens=32)
    params = jax.tree.map(lambda a: a.astype(jnp.float32),
                          jax_build(jcfg).init_params(jax.random.PRNGKey(1)))
    kw = dict(page_tokens=16, max_len=160, kv_budget_bytes=4e6, **ecfg)
    jeng = JEngine(jcfg, JConfig(tier_specs=J_TIERS, **kw), params=params)
    teng = TEngine(tcfg, TConfig(**kw),
                   params=params_from_numpy(jax.tree.map(np.asarray, params),
                                            device="cpu"),
                   device="cpu")
    return jeng, teng


def _serve(eng, waves, sampling):
    reqs = []
    for prompts in waves:
        reqs += [eng.submit(p, params=sampling(max_new_tokens=4))
                 for p in prompts]
        eng.run()
    eng.shutdown()
    return [list(r.generated) for r in reqs], eng.stats()


def _words(rng, n):
    return [int(t) for t in rng.integers(0, 250, size=n)]


@pytest.mark.usefixtures("_jax_recompute_constant")
def test_mla_engine_matches_jax():
    """One engine pair, three waves: a batch of three 40-token prompts;
    a shared-prefix pair (one 32-token block then different tails); a
    segment pair A = [S0 S1 S2 | tail], B = [X0 S1 S2 | tail'] whose
    gaps run through the segment kernel."""
    rng = np.random.default_rng(10)
    batch = [_words(rng, 40) for _ in range(3)]
    prefix = _words(rng, 32)
    seg = [_words(rng, 32) for _ in range(3)]
    waves = [batch,
             [prefix + _words(rng, 11)], [prefix + _words(rng, 7)],
             [seg[0] + seg[1] + seg[2] + _words(rng, 9)],
             [_words(rng, 32) + seg[1] + seg[2] + _words(rng, 5)]]
    jeng, teng = _engines()
    jtoks, jst = _serve(jeng, waves, JSampling)
    ttoks, tst = _serve(teng, waves, TSampling)
    assert ttoks == jtoks
    assert all(len(t) == 4 for t in ttoks)
    for key in ("prefill_chunks", "cow_share_hits", "segment_chunks",
                "segment_share_hits", "inject_hits"):
        assert tst[key] == jst[key], key
    assert tst["cow_share_hits"] > 0 and tst["segment_chunks"] > 0
    assert set(teng.kv.pools) == {"latent_pages"}


def test_mla_payload_roundtrip_as_uint16():
    """A bf16 latent pool hands out [1, L, n, dl+dr] payloads of uint16
    bits — the JAX engine's bytes — and injects them back unchanged."""
    cfg = t_reduce(T_DEEPSEEK_V3)
    kv = PagedKVCache(build_model(cfg), 2, 64, page_tokens=16,
                      device="cpu")
    rng = np.random.default_rng(11)
    lat = torch.from_numpy(_rand(rng, (cfg.n_layers, 1, 40, DL + DR)))
    kv.acquire(0, 40)
    kv.write_chunk(0, {"latent": lat}, 0, 40)
    pl = kv.extract_block(0, 8, 24)
    assert pl.shape == (1, cfg.n_layers, 24, DL + DR)
    assert pl.dtype == np.uint16 and pl.nbytes == 24 * cfg.n_layers * 80
    jbits = np.asarray(jnp.asarray(lat[:, 0, 8:32].numpy(), jnp.bfloat16))
    assert np.array_equal(pl[0], jbits.view(np.uint16))
    kv.acquire(1, 0)
    kv.inject_block(1, pl, 16)
    assert np.array_equal(kv.extract_block(1, 16, 24), pl)
