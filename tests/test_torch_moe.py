"""The port's MoE FFN and MoE decoders against the JAX package, on the
same numpy inputs and the same params (the JAX ``init_params`` tree
crossed through ``params_from_numpy``):

* ``moe.moe_ffn`` in float32 within 1e-4 (the aux loss too), with the
  routing decisions equal exactly: the same top-k experts and the same
  kept (group, token, expert, capacity slot) set as the JAX dispatch
  tensor, read from the JAX function itself; four cases: no drops, a
  biased router that makes JAX drop assignments, padded layout experts
  and t = 512 tokens in two groups;
* every entry point of reduced granite-moe-3b-a800m (decode with bf16
  and int8 slot caches) and of reduced DeepSeek-V3 with 4 experts top-2
  (MLA + MoE), float32, 1e-4 on logits and caches;
* the engine: greedy tokens and counters equal to the JAX engine's for
  reduced granite-moe on the default path and on the three A/B flags,
  on layer weights scaled x8 so that the tokens are no echo of the
  prompt.
"""
import dataclasses
import math
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config import reduce_config  # noqa: E402
from repro.configs import get_config  # noqa: E402
from repro.configs.paper_models import DEEPSEEK_V3  # noqa: E402
from repro.core.tiers import PAPER_TIER_SPECS as J_TIERS  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models.model import build_model as jax_build  # noqa: E402
from repro.serving import EngineConfig as JConfig  # noqa: E402
from repro.serving import SamplingParams as JSampling  # noqa: E402
from repro.serving import ServingEngine as JEngine  # noqa: E402
from repro_torch.config import reduce_config as t_reduce  # noqa: E402
from repro_torch.configs import get_config as t_get  # noqa: E402
from repro_torch.configs.paper_models import \
    DEEPSEEK_V3 as T_DEEPSEEK_V3  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.convert import (params_from_numpy,  # noqa: E402
                                        tensor_from_numpy)
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.serving import EngineConfig as TConfig  # noqa: E402
from repro_torch.serving import SamplingParams as TSampling  # noqa: E402
from repro_torch.serving import ServingEngine as TEngine  # noqa: E402
from repro_torch.serving import engine as t_engine  # noqa: E402
from repro_torch.serving import sampler as t_sampler  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
# the JAX engine prices block recompute at the TPU v5e bf16 peak
JAX_RECOMPUTE_FLOPS = 197e12
COUNTERS = ("prefill_chunks", "cow_share_hits", "inject_hits",
            "segment_chunks", "paged", "chunked", "fused")
GRANITE = "granite-moe-3b-a800m"
MOE = dict(n_experts=4, top_k=2, expert_d_ff=32)


def _rand(rng, shape):
    return rng.normal(size=shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(t, j, **tol):
    np.testing.assert_allclose(t.detach().float().numpy(),
                               np.asarray(j, np.float32), **(tol or TOL))


# ---------------------------------------------------------------------------
# moe_ffn
# ---------------------------------------------------------------------------
def _jax_routing(monkeypatch, p, x, cfg):
    """Run the JAX ``moe_ffn`` and read its routing from its own
    tensors: ``top_i`` from ``jax.lax.top_k`` and the dispatch [G,t,E,C]
    from the expert-input einsum.  Returns (out, aux, top_i, kept set)."""
    seen = {}
    top_k = jax.lax.top_k

    def spy_top_k(a, k):
        out = top_k(a, k)
        seen["top_i"] = np.asarray(out[1])
        return out

    def spy_einsum(spec, *ops, **kw):
        if spec == "gtec,gtd->gecd":
            seen["dispatch"] = np.asarray(ops[0], np.float32)
        return jnp.einsum(spec, *ops, **kw)

    proxy = types.SimpleNamespace(**{n: getattr(jnp, n) for n in dir(jnp)
                                     if not n.startswith("__")})
    proxy.einsum = spy_einsum
    with monkeypatch.context() as m:
        m.setattr(jax.lax, "top_k", spy_top_k)
        m.setattr(jmoe, "jnp", proxy)
        out, aux = jmoe.moe_ffn({k: jnp.asarray(v) for k, v in p.items()},
                                jnp.asarray(x), cfg)
    disp = seen["dispatch"]
    assert set(np.unique(disp)) <= {0.0, 1.0}
    kept = {tuple(int(i) for i in ix) for ix in np.argwhere(disp > 0)}
    return out, aux, seen["top_i"], kept


MOE_CASES = {
    # (batch, seq, config overrides, router column bias)
    "no_drops": (2, 8, dict(capacity_factor=4.0), None),
    "drops": (2, 16, {}, np.asarray([4.0, 3.0, 0.0, 0.0], np.float32)),
    "pad_experts": (2, 12, dict(internal_pad_experts=6), None),
    "two_groups": (4, 128, {}, None),
}


@pytest.mark.parametrize("case", sorted(MOE_CASES))
def test_moe_ffn_matches_jax(monkeypatch, case):
    """Float32 output and aux loss within 1e-4; the top-k experts and
    the kept (group, token, expert, slot) set equal to JAX's exactly."""
    b, s, over, bias = MOE_CASES[case]
    jcfg = dataclasses.replace(reduce_config(get_config(GRANITE)), **over)
    tcfg = dataclasses.replace(t_reduce(t_get(GRANITE)), **over)
    rng = np.random.default_rng(sorted(MOE_CASES).index(case))
    d, e, f = tcfg.d_model, tcfg.layout_n_experts, tcfg.moe_ff
    p = {"router": _rand(rng, (d, e)) * 0.3,
         "w_gate": _rand(rng, (e, d, f)) * 0.1,
         "w_up": _rand(rng, (e, d, f)) * 0.1,
         "w_down": _rand(rng, (e, f, d)) * 0.1}
    x = _rand(rng, (b, s, d))
    if bias is not None:
        # a shared input direction whose router weights favour experts
        # 0 and 1: most tokens pick them, and capacity drops the excess
        u = np.full(d, d ** -0.5, np.float32)
        x = (x * 0.2 + u).astype(np.float32)
        p["router"] += np.outer(u, bias).astype(np.float32)
    out, aux, top_i, kept = _jax_routing(monkeypatch, p, x, jcfg)

    tp = {k: _t(v) for k, v in p.items()}
    mine, maux = moe.moe_ffn(tp, _t(x), tcfg)
    _close(mine, out)
    _close(maux, aux)
    ng = moe._n_groups(b * s)
    assert ng == jmoe._n_groups(b * s, 1) == (2 if case == "two_groups"
                                              else 1)
    xg = _t(x).reshape(ng, -1, d)
    _, _, ti, pos, keep = moe.route(tp, xg, tcfg)
    assert np.array_equal(ti.numpy(), top_i)
    g, t, j = np.nonzero(keep.numpy())
    mine_kept = {(int(a), int(bb), int(ti[a, bb, c]), int(pos[a, bb, c]))
                 for a, bb, c in zip(g, t, j)}
    assert mine_kept == kept
    dropped = b * s * tcfg.top_k - len(kept)
    if case == "drops":
        assert dropped > 0
    elif case == "no_drops":
        assert dropped == 0
    if case == "pad_experts":
        assert (ti < tcfg.n_experts).all()


def test_moe_top_k_ties_break_to_the_lower_index():
    """Equal probabilities (a zero router) choose experts 0, 1, ... in
    order, as ``jax.lax.top_k`` does; capacity then drops by token
    order."""
    tcfg = t_reduce(t_get(GRANITE))
    d, e = tcfg.d_model, tcfg.n_experts
    p = {"router": torch.zeros((d, e))}
    xg = torch.randn((1, 24, d), generator=torch.Generator().manual_seed(0))
    _, top_p, ti, pos, keep = moe.route(p, xg, tcfg)
    _, jti = jax.lax.top_k(jnp.full((1, 24, e), 1.0 / e), tcfg.top_k)
    assert np.array_equal(ti.numpy(), np.asarray(jti))
    assert torch.equal(ti[0, :, 0], torch.zeros(24, dtype=ti.dtype))
    cap = moe.capacity(24, tcfg)
    assert torch.equal(keep[0, :, 0], torch.arange(24) < cap)
    assert torch.allclose(top_p, torch.full_like(top_p, 0.5))


# ---------------------------------------------------------------------------
# model entry points
# ---------------------------------------------------------------------------
def _configs(name):
    if name == GRANITE:
        return reduce_config(get_config(GRANITE)), t_reduce(t_get(GRANITE))
    return (dataclasses.replace(reduce_config(DEEPSEEK_V3), **MOE),
            dataclasses.replace(t_reduce(T_DEEPSEEK_V3), **MOE))


MODELS = (GRANITE, "deepseek-v3-moe")


@pytest.fixture(scope="module", params=MODELS)
def models(request):
    jcfg, tcfg = _configs(request.param)
    jp = jax.tree.map(lambda a: a.astype(jnp.float32),
                      jax_build(jcfg).init_params(jax.random.PRNGKey(0)))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, jp, tcfg, tp


def _pool_keys(cfg):
    return ("latent_pages",) if cfg.d_latent else ("k_pages", "v_pages")


def _pool(rng, cfg, n, page=16):
    row = ((cfg.d_latent + cfg.d_rope,) if cfg.d_latent
           else (cfg.n_kv_heads, cfg.hd))
    return {key: _rand(rng, (cfg.n_layers, n, page) + row)
            for key in _pool_keys(cfg)}


def test_moe_param_tree_matches_jax(models):
    jcfg, jp, tcfg, _ = models
    jleaves = {tuple(p.key for p in path): leaf.shape for path, leaf in
               jax.tree_util.tree_flatten_with_path(jp)[0]}
    mine = build_model(tcfg).init_params(0, device="cpu",
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
    assert set(mine["layers"]["ffn"]) == {"router", "w_gate", "w_up",
                                          "w_down"}


def test_moe_decode_step_paged_matches_jax(models):
    """Three rows, one inactive (token 0, length 0), as the engine feeds
    them: its routing takes capacity in both frameworks."""
    jcfg, jp, tcfg, tp = models
    rng = np.random.default_rng(1)
    pools = _pool(rng, tcfg, 19)
    tables = np.zeros((3, 6), np.int32)
    tables[0, :4] = [3, 7, 1, 9]
    tables[2, :2] = [12, 5]
    lengths = np.asarray([50, 0, 17], np.int32)
    tokens = np.asarray([11, 0, 200], np.int32)
    extra = {"block_tables": tables, "lengths": lengths}
    jstate = {k: jnp.asarray(v) for k, v in {**pools, **extra}.items()}
    tstate = {k: _t(v) for k, v in {**pools, **extra}.items()}
    jl, jnew = jax_build(jcfg).decode_step_paged(jp, jstate,
                                                 jnp.asarray(tokens),
                                                 backend="xla")
    tl, tnew = build_model(tcfg).decode_step_paged(tp, tstate, _t(tokens))
    _close(tl[[0, 2]], np.asarray(jl)[[0, 2]])
    for key in pools:
        _close(tnew[key], jnew[key])
        assert tnew[key] is tstate[key]


@pytest.mark.parametrize("seg", [False, True])
def test_moe_prefill_chunks_match_jax(models, seg):
    """A 16-token chunk at offset 21 (zero-padded past 13 tokens, as the
    engine pads) and a segment chunk with padding."""
    jcfg, jp, tcfg, tp = models
    rng = np.random.default_rng(2 + seg)
    pools = _pool(rng, tcfg, 8)
    table = np.asarray([[4, 2, 6, 1, 3, 7]], np.int32)
    jstate = {k: jnp.asarray(v) for k, v in pools.items()}
    tstate = {k: _t(v) for k, v in pools.items()}
    jstate["block_table"], tstate["block_table"] = jnp.asarray(table), \
        _t(table)
    toks = rng.integers(0, 256, size=(1, 16)).astype(np.int32)
    toks[0, 13:] = 0
    if seg:
        arg = np.asarray([[5, 6, 7, 8, 9, 10, 40, 41, 42, 43, 44, 45, 46,
                           -1, -1, -1]], np.int32)
    else:
        arg = np.asarray([21], np.int32)
    jm, tm = jax_build(jcfg), build_model(tcfg)
    jfn = jm.prefill_chunk_seg if seg else jm.prefill_chunk
    tfn = tm.prefill_chunk_seg if seg else tm.prefill_chunk
    jout = jfn(jp, jstate, jnp.asarray(toks), jnp.asarray(arg),
               backend="xla")
    tout = tfn(tp, tstate, _t(toks), _t(arg))
    assert set(tout) == set(jout)
    for key in jout:
        _close(tout[key], jout[key])


def test_moe_prefill_and_suffix_match_jax(models):
    """Monolithic prefill of two 40-token prompts (80 tokens, one
    routing group), then the suffix after a 24-token cached prefix."""
    jcfg, jp, tcfg, tp = models
    jm, tm = jax_build(jcfg), build_model(tcfg)
    toks = np.random.default_rng(4).integers(0, 256, (2, 40)).astype(
        np.int32)
    jl, js = jm.prefill(jp, {"tokens": jnp.asarray(toks)})
    tl, ts = tm.prefill(tp, {"tokens": _t(toks)})
    _close(tl, jl)
    assert set(ts) == set(js)
    for key in js:
        _close(ts[key], js[key])
    pre = 24
    keys = ("latent",) if tcfg.d_latent else ("k", "v")
    jl2, jkv = jm.prefill_suffix(jp, {"tokens": jnp.asarray(toks[:, pre:])},
                                 tuple(js[k][:, :, :pre] for k in keys), pre)
    tl2, tkv = tm.prefill_suffix(tp, {"tokens": _t(toks[:, pre:])},
                                 tuple(ts[k][:, :, :pre] for k in keys), pre)
    _close(tl2, jl2)
    assert len(tkv) == len(jkv)
    for mine, ref in zip(tkv, jkv):
        _close(mine, ref)


@pytest.mark.parametrize("kv_dtype", ["bfloat16", "int8"])
def test_moe_decode_step_matches_jax(models, kv_dtype):
    """One dense decode step over a slot state with a fresh row, a mid
    row and a row at the last slot (MLA keeps a bf16 latent cache
    whatever ``kv_dtype`` says, as in JAX: its int8 case is the same
    step)."""
    jcfg, jp, tcfg, tp = models
    jm = jax_build(jcfg, kv_dtype=kv_dtype)
    tm = build_model(tcfg, kv_dtype=kv_dtype)
    rng = np.random.default_rng(6)
    lengths = np.asarray([0, 17, 47], np.int32)
    tokens = np.asarray([3, 200, 41], np.int32)
    if tcfg.d_latent:
        jstate = {"latent": jnp.asarray(_rand(
            rng, (tcfg.n_layers, 3, 48, tcfg.d_latent + tcfg.d_rope)))}
    else:
        shape = (tcfg.n_layers, 3, 48, tcfg.n_kv_heads, tcfg.hd)
        k, v = _rand(rng, shape), _rand(rng, shape)
        if kv_dtype == "int8":
            (kq, ks), (vq, vs) = (jattn.quantize_kv(jnp.asarray(a))
                                  for a in (k, v))
            jstate = {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
        else:
            jstate = {"k": jnp.asarray(k), "v": jnp.asarray(v)}
    spec = build_model(tcfg, kv_dtype=kv_dtype).decode_state_specs(3, 48)
    assert set(spec) == set(jstate) | {"lengths"}
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
        assert tnew[key] is tstate[key]
        if tnew[key].dtype == torch.int8 or key.endswith("_scale"):
            assert np.array_equal(tnew[key].float().numpy(),
                                  np.asarray(jnew[key], np.float32)), key
        else:
            _close(tnew[key], jnew[key])


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------
@pytest.fixture(autouse=True)
def _jax_recompute_constant(monkeypatch):
    monkeypatch.setattr(t_engine, "H100_BF16_PEAK_FLOPS", JAX_RECOMPUTE_FLOPS)


# The layers' weights are scaled so that greedy tokens are no echo of the
# prompt's last token (the seeded JAX init gives only echoes), all but
# the attention score path: x8 on ln1, wq and wk (MLA: wq, w_dkv, w_kr,
# w_uk) would scale the scores 8^4-fold, and the JAX dense layout rounds
# its scores to bf16 (``causal_attention``, ``mla_attention_decode``),
# an O(1) error at that size.
LAYER_SCALE = 8.0
SCORE_PATH = {"ln1", "wq", "wk", "bq", "bk", "w_dkv", "w_kr", "w_uk"}
FLAGS = {"default": {}, "dense": dict(paged=False),
         "monolithic": dict(chunked_prefill=False),
         "unfused": dict(fused_step=False)}


def engine_params(jcfg, flags):
    """The JAX init with the layers scaled: float32 where the JAX engine
    takes float32 params, bf16 on ``paged=False`` (the JAX slot cache
    takes bf16 writes only)."""
    params = jax_build(jcfg).init_params(jax.random.PRNGKey(0))
    dt = jnp.bfloat16 if flags.get("paged") is False else jnp.float32

    def scale(path, a):
        keys = {getattr(k, "key", None) for k in path}
        return a if keys & SCORE_PATH else a * LAYER_SCALE
    params = dict(params, layers=jax.tree_util.tree_map_with_path(
        scale, params["layers"]))
    return jax.tree.map(lambda a: a.astype(dt), params)


def record_jax(eng):
    """Log the JAX engine's fused decode steps: logits [B,V] (a host
    callback inside the jitted step) and sampled tokens [B]."""
    log = {"logits": [], "tokens": []}
    model = eng.model
    for name in ("decode_step", "decode_step_paged"):
        def rec(*a, _fn=getattr(model, name), **kw):
            logits, state = _fn(*a, **kw)
            jax.debug.callback(lambda lg: log["logits"].append(
                np.asarray(lg, np.float32)), logits)
            return logits, state
        setattr(model, name, rec)       # read when the step is traced
    fused = eng._fused_decode

    def fused_rec(*a):
        toks, state = fused(*a)
        log["tokens"].append(np.asarray(toks))
        return toks, state
    eng._fused_decode = fused_rec
    return log


def record_port(eng, monkeypatch):
    """The same log of the port engine's fused steps, plus each step's
    active rows."""
    log = {"logits": [], "tokens": [], "active": []}
    for name in ("decode_step", "decode_step_paged"):
        def rec(*a, _fn=getattr(eng.model, name), **kw):
            logits, state = _fn(*a, **kw)
            log["logits"].append(logits.float().numpy().copy())
            return logits, state
        setattr(eng.model, name, rec)
    step_arrays = eng.scheduler.step_arrays

    def arrays_rec(*a):
        sa = step_arrays(*a)
        log["active"].append(sa["active"].astype(bool))
        return sa
    eng.scheduler.step_arrays = arrays_rec
    sample = t_sampler.sample_batched

    def sample_rec(*a, **kw):
        toks = sample(*a, **kw)
        log["tokens"].append(toks.numpy().copy())
        return toks
    monkeypatch.setattr(t_sampler, "sample_batched", sample_rec)
    return log


def serve_pair(monkeypatch, jcfg, tcfg, flags, waves, max_new=5, **ecfg):
    """Serve ``waves`` on the JAX engine and the port's, same params;
    per engine (tokens per request, stats, fused-step log)."""
    params = engine_params(jcfg, flags)
    jeng = JEngine(jcfg, JConfig(tier_specs=J_TIERS, **ecfg, **flags),
                   params=params)
    teng = TEngine(tcfg, TConfig(**ecfg, **flags), device="cpu",
                   params=params_from_numpy(jax.tree.map(np.asarray, params),
                                            device="cpu"))
    logs = (record_jax(jeng), record_port(teng, monkeypatch))
    out = []
    for eng, sampling, log in zip((jeng, teng), (JSampling, TSampling), logs):
        reqs = []
        for prompts in waves:
            reqs += [eng.submit(p, params=sampling(max_new_tokens=max_new))
                     for p in prompts]
            eng.run()
        eng.shutdown()
        out.append(([list(r.generated) for r in reqs], eng.stats(), log))
    return out


def bf16_step(v: float) -> float:
    """The spacing of bf16 values at magnitude |v| (8 significant bits)."""
    return 2.0 ** (math.floor(math.log2(abs(v))) - 7)


# the engines' bf16 logits may differ by a few bf16 steps (the JAX dense
# layout rounds attention scores and probabilities to bf16, the port
# keeps them in float32; JAX's jitted argmax sees its logits before their
# bf16 rounding): at most this share of the largest logit
LOGIT_AGREEMENT = 2.0 ** -4


def assert_near_tie(jlog, tlog):
    """At the first fused decode step where the engines' greedy tokens
    part on an active row, that row is at a near tie: in the JAX
    engine's logits and in the port's, both tokens lie within ``d`` of
    the row's largest logit, where ``d`` (at least one bf16 step) is the
    largest difference between the two engines' logits on that step's
    active rows, itself within LOGIT_AGREEMENT of the largest logit.
    Past that step the runs' contexts differ."""
    for jt, tt, act, jl, tl in zip(jlog["tokens"], tlog["tokens"],
                                   tlog["active"], jlog["logits"],
                                   tlog["logits"]):
        rows = np.nonzero((jt != tt) & act)[0]
        if not rows.size:
            continue
        d = float(np.abs(jl - tl)[act].max())
        assert d <= LOGIT_AGREEMENT * float(np.abs(jl[act]).max()), d
        for r in rows:
            for lg in (jl[r], tl[r]):
                floor = lg.max() - max(d, bf16_step(lg.max()))
                assert lg[jt[r]] >= floor and lg[tt[r]] >= floor, \
                    (r, lg[jt[r]], lg[tt[r]], lg.max(), d)
        return
    raise AssertionError("the tokens part outside the fused decode steps")


def assert_engines_agree(waves, jax_run, port_run, bf16: bool):
    """Equal counters; greedy tokens that are no echo and equal the JAX
    engine's, except that with bf16 params they may part at a near tie
    (``assert_near_tie``)."""
    (jtoks, jst, jlog), (ttoks, tst, tlog) = jax_run, port_run
    for key in COUNTERS:
        assert tst[key] == jst[key], key
    assert all(len(t) == len(ttoks[0]) for t in ttoks + jtoks)
    assert_no_echo(waves, ttoks)
    assert_no_echo(waves, jtoks)
    if ttoks != jtoks:
        assert bf16, (ttoks, jtoks)
        assert_near_tie(jlog, tlog)


def assert_no_echo(waves, toks):
    """Most generated tokens differ from their prompt's last token."""
    prompts = [p for wave in waves for p in wave]
    echo = sum(t == p[-1] for p, gen in zip(prompts, toks) for t in gen)
    assert echo < 0.5 * sum(len(g) for g in toks), (echo, toks)


def engine_waves():
    """A batch of four 48-token prompts, then a pair sharing two
    16-token blocks (CoW pages, or payload injection on the dense
    slots)."""
    rng = np.random.default_rng(7)

    def words(n):
        return [int(t) for t in rng.integers(0, 250, size=n)]
    prefix = words(32)
    return [[words(48) for _ in range(4)], [prefix + words(21)],
            [prefix + words(13)]]


ENGINE_KW = dict(page_tokens=16, max_len=128, kv_budget_bytes=4e6)


@pytest.mark.parametrize("flag", sorted(FLAGS))
def test_moe_engine_matches_jax(monkeypatch, flag):
    """Reduced granite-moe: greedy tokens and counters of each path
    equal the JAX engine's."""
    jcfg = dataclasses.replace(reduce_config(get_config(GRANITE)),
                               kv_block_tokens=16)
    tcfg = dataclasses.replace(t_reduce(t_get(GRANITE)), kv_block_tokens=16)
    waves = engine_waves()
    jax_run, port_run = serve_pair(monkeypatch, jcfg, tcfg, FLAGS[flag],
                                   waves, **ENGINE_KW)
    assert_engines_agree(waves, jax_run, port_run,
                         bf16=flag == "dense")
    assert port_run[1]["cow_share_hits"] + port_run[1]["inject_hits"] > 0
