"""The port's RWKV6 mixers (``models/rwkv.py``), ``layer_norm`` and
``RWKVModel`` (reduced rwkv6: 2 layers, D 64, 4 heads of 16) against the
JAX package's, on float32 params from the JAX ``init_params`` tree
crossed through numpy and numpy-made inputs: within 1e-4, the bar of
``tests/test_torch_model.py``.  The port's chunked WKV against the
sequential oracle at the shapes and bar of
``tests/test_model_consistency.py`` and at a ragged length where the
JAX ``wkv_chunked`` overflows; its own decode against teacher forcing at
that file's bar, and the state's bytes at full width against
``sizing.decode_state_bytes``."""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config import reduce_config  # noqa: E402
from repro.configs import get_config  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models import rwkv as jrwkv  # noqa: E402
from repro.models.model import build_model as jax_build  # noqa: E402
from repro_torch.config import reduce_config as t_reduce  # noqa: E402
from repro_torch.configs import get_config as t_get  # noqa: E402
from repro_torch.core import sizing  # noqa: E402
from repro_torch.models import common, rwkv  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
RWKV = "rwkv6-1.6b"
STEPS = 6
LAYER_KEYS = ("wkv", "tm_x", "cm_x")


def _close(t, j, **tol):
    np.testing.assert_allclose(t.detach().float().numpy(),
                               np.asarray(j, np.float32), **(tol or TOL))


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def pair():
    """(JAX model, JAX params, port model, port params), reduced rwkv6,
    float32."""
    jm = jax_build(reduce_config(get_config(RWKV)))
    tree = jax.tree.map(lambda a: np.array(a, np.float32),
                        jax.jit(jm.init_params)(jax.random.PRNGKey(0)))
    tm = build_model(t_reduce(t_get(RWKV)))
    return (jm, jax.tree.map(jnp.asarray, tree), tm,
            params_from_numpy(tree, device="cpu"))


def _layer(pair, i):
    jm, jp, tm, tp = pair
    return (jax.tree.map(lambda a: a[i], jp["layers"]),
            {k: v[i] for k, v in tp["layers"].items()})


def test_param_and_state_specs_match_jax():
    """Same leaves, shapes, axes, init kinds and dtypes as the JAX spec
    trees (params and the decode state), at full width and reduced."""
    for jcfg, tcfg in ((get_config(RWKV), t_get(RWKV)),
                       (reduce_config(get_config(RWKV)),
                        t_reduce(t_get(RWKV)))):
        jm, tm = jax_build(jcfg), build_model(tcfg)
        for jtree, ttree in ((jm.specs, tm.specs),
                             (jm.decode_state_specs(3, 128),
                              tm.decode_state_specs(3, 128))):
            jleaves = jax.tree_util.tree_flatten_with_path(
                jtree, is_leaf=lambda x: isinstance(x, jcommon.PSpec))[0]
            mine = {}
            for k, v in ttree.items():
                if isinstance(v, dict):
                    mine.update({(k, kk): vv for kk, vv in v.items()})
                else:
                    mine[(k,)] = v
            assert len(mine) == len(jleaves)
            for path, spec in jleaves:
                got = mine[tuple(p.key for p in path)]
                assert (got.shape, got.axes, got.init, got.scale,
                        got.dtype) == (spec.shape, spec.axes, spec.init,
                                       spec.scale, spec.dtype)


def test_layer_norm_matches_jax():
    """float32 statistics with the population variance, bf16 and
    float32 inputs."""
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(3, 5, 64)) * 3 + 1).astype(np.float32)
    g = rng.normal(size=(64,)).astype(np.float32)
    b = rng.normal(size=(64,)).astype(np.float32)
    _close(common.layer_norm(_t(x), _t(g), _t(b)),
           jcommon.layer_norm(jnp.asarray(x), jnp.asarray(g),
                              jnp.asarray(b)))
    got = common.layer_norm(_t(x).bfloat16(), _t(g).bfloat16(),
                            _t(b).bfloat16())
    want = jcommon.layer_norm(jnp.asarray(x, jnp.bfloat16),
                              jnp.asarray(g, jnp.bfloat16),
                              jnp.asarray(b, jnp.bfloat16))
    assert got.dtype == torch.bfloat16
    _close(got, want, rtol=2 ** -7, atol=2 ** -7)


def _wkv_inputs(rng, b, s, h, dk, lo=0.001, hi=4.9, init=False):
    r, k, v = (rng.normal(size=(b, s, h, dk)).astype(np.float32)
               for _ in range(3))
    logw = -rng.uniform(lo, hi, size=(b, s, h, dk)).astype(np.float32)
    u = rng.normal(size=(h, dk)).astype(np.float32)
    s0 = rng.normal(size=(b, h, dk, dk)).astype(np.float32) if init else None
    return r, k, v, logw, u, s0


@pytest.mark.parametrize("s,init", [(64, False), (96, True), (100, False),
                                    (7, True)])
def test_wkv_chunked_matches_jax(s, init):
    """Whole 16-token chunks, and ragged lengths where JAX runs one chunk
    of the whole prompt (still finite at these decays), the port its
    full chunks and a remainder chunk."""
    r, k, v, logw, u, s0 = _wkv_inputs(np.random.default_rng(s), 2, s, 2, 8,
                                       0.5, 0.9, init)
    jy, js = jax.jit(jrwkv.wkv_chunked)(
        *map(jnp.asarray, (r, k, v, logw, u)),
        init_state=None if s0 is None else jnp.asarray(s0))
    assert np.isfinite(np.asarray(jy)).all()
    ty, ts = rwkv.wkv_chunked(*map(_t, (r, k, v, logw, u)),
                              init_state=None if s0 is None else _t(s0))
    _close(ty, jy)
    _close(ts, js)


def test_wkv_chunked_vs_reference():
    """The port's chunked WKV against the sequential oracle, at
    ``tests/test_model_consistency.py``'s shapes, decays and bar."""
    r, k, v, logw, u, _ = _wkv_inputs(np.random.default_rng(1), 2, 64, 2, 8)
    args = tuple(map(_t, (r, k, v, logw, u)))
    y1, s1 = rwkv.wkv_chunked(*args, chunk=16)
    y2, s2 = rwkv.wkv_reference(*args)
    _close(y1, y2.numpy(), rtol=1e-3, atol=1e-3)
    _close(s1, s2.numpy(), rtol=1e-3, atol=1e-3)


def test_wkv_chunked_finite_at_ragged_length():
    """S = 130 (not a multiple of 16) at log-decays in [-0.9, -0.5]: the
    JAX ``wkv_chunked`` falls back to one chunk of 130 tokens, whose
    factored exponent exp(-cumsum) passes the float32 range (its output
    is not finite there; not asserted).  The port stays finite and equals
    the JAX sequential oracle within 1e-3."""
    r, k, v, logw, u, _ = _wkv_inputs(np.random.default_rng(2), 2, 130, 2, 8,
                                      0.5, 0.9)
    ty, ts = rwkv.wkv_chunked(*map(_t, (r, k, v, logw, u)))
    assert torch.isfinite(ty).all() and torch.isfinite(ts).all()
    jy, js = jrwkv.wkv_reference(*map(jnp.asarray, (r, k, v, logw, u)))
    _close(ty, jy, rtol=1e-3, atol=1e-3)
    _close(ts, js, rtol=1e-3, atol=1e-3)


def test_wkv_step_matches_jax():
    r, k, v, logw, u, s0 = _wkv_inputs(np.random.default_rng(3), 2, 1, 3, 8,
                                       init=True)
    args = (s0, r[:, 0], k[:, 0], v[:, 0], logw[:, 0], u)
    js, jy = jax.jit(jrwkv.wkv_step)(*map(jnp.asarray, args))
    ts, ty = rwkv.wkv_step(*map(_t, args))
    _close(ts, js)
    _close(ty, jy)


def _mixer_inputs(pair, seed):
    """Layer 1's params, a 37-token input (two chunks and a remainder)
    and a carried float32 state."""
    cfg = pair[2].cfg
    jlp, tlp = _layer(pair, 1)
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, 37, cfg.d_model)).astype(np.float32)
    st = {"wkv": rng.normal(size=(2, cfg.n_heads, cfg.hd, cfg.hd)),
          "tm_x": rng.normal(size=(2, cfg.d_model)),
          "cm_x": rng.normal(size=(2, cfg.d_model))}
    st = {k: v.astype(np.float32) for k, v in st.items()}
    return jlp, tlp, x, st


def test_time_mix_matches_jax(pair):
    """The prompt's time-mix, and one token's from a carried state."""
    jm, cfg = pair[0], pair[2].cfg
    jlp, tlp, x, st = _mixer_inputs(pair, 4)
    _close(rwkv.time_mix(tlp, _t(x), cfg),
           jax.jit(lambda p, x: jrwkv.time_mix(p, x, jm.cfg))(
               jlp, jnp.asarray(x)))
    jout, jst = jax.jit(lambda p, x, s: jrwkv.rwkv_decode_step(
        p, x, None, s, jm.cfg))(jlp, jnp.asarray(x[:, 0]),
                                jax.tree.map(jnp.asarray, st))
    tout, tst = rwkv.rwkv_decode_step(tlp, _t(x[:, 0]),
                                      {k: _t(v) for k, v in st.items()}, cfg)
    _close(tout, jout)
    for k in LAYER_KEYS:
        _close(tst[k], jst[k])


def test_channel_mix_matches_jax(pair):
    """The prompt's channel-mix, and one token's from a carried state."""
    jlp, tlp, x, st = _mixer_inputs(pair, 5)
    _close(rwkv.channel_mix(tlp, _t(x)),
           jax.jit(jrwkv.channel_mix)(jlp, jnp.asarray(x)))
    jout, jst = jax.jit(jrwkv.channel_mix_step)(
        jlp, jnp.asarray(x[:, 0]), jax.tree.map(jnp.asarray, st))
    tout, tst = rwkv.channel_mix_step(tlp, _t(x[:, 0]),
                                      {k: _t(v) for k, v in st.items()})
    _close(tout, jout)
    for k in LAYER_KEYS:
        _close(tst[k], jst[k])


def test_prefill_matches_jax(pair):
    """A 37-token prompt: the logits and every state leaf (the wkv state
    bf16, as JAX returns it)."""
    jm, jp, tm, tp = pair
    toks = np.random.default_rng(5).integers(0, tm.cfg.vocab_size,
                                             size=(2, 37)).astype(np.int32)
    jl, js = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(toks)})
    tl, ts = tm.prefill(tp, {"tokens": _t(toks)})
    _close(tl, jl)
    assert set(ts) == set(js) == set(LAYER_KEYS) | {"lengths"}
    assert ts["wkv"].dtype == torch.bfloat16
    for k in LAYER_KEYS:
        assert tuple(ts[k].shape) == js[k].shape
        _close(ts[k], js[k], rtol=2 ** -8 if k == "wkv" else 1e-4,
               atol=1e-4)
    assert ts["lengths"].tolist() == [37, 37]


def test_decode_matches_jax(pair):
    """Two prompts of different lengths, each prefilled alone and copied
    into row b of one float32 state (on both sides), then STEPS
    teacher-forced decode steps: the logits equal at every step, and
    every state leaf after them."""
    jm, jp, tm, tp = pair
    cfg = tm.cfg
    rng = np.random.default_rng(6)
    lens = (21, 9)
    jstate = {k: np.zeros(p.shape, np.float32 if p.dtype is None
                          else p.dtype)
              for k, p in jm.decode_state_specs(2, 64).items()}
    tstate = {k: t.float() if t.is_floating_point() else t
              for k, t in tm.init_decode_state(2, 64, device="cpu").items()}
    prefill = jax.jit(jm.prefill)
    for b, n in enumerate(lens):
        toks = rng.integers(0, cfg.vocab_size, size=(1, n)).astype(np.int32)
        _, js = prefill(jp, {"tokens": jnp.asarray(toks)})
        _, ts = tm.prefill(tp, {"tokens": _t(toks)})
        for k in LAYER_KEYS:
            jstate[k][:, b] = np.asarray(js[k][:, 0], np.float32)
            tstate[k][:, b] = ts[k][:, 0]
        jstate["lengths"][b] = tstate["lengths"][b] = n
    jstate = {k: jnp.asarray(v) for k, v in jstate.items()}
    step = jax.jit(jm.decode_step)
    for t in rng.integers(0, cfg.vocab_size, size=(STEPS, 2)).astype(
            np.int32):
        jl, jstate = step(jp, jstate, jnp.asarray(t))
        tl, tstate = tm.decode_step(tp, tstate, _t(t))
        _close(tl, jl)
    assert tstate["lengths"].tolist() == [n + STEPS for n in lens]
    for k in LAYER_KEYS:
        _close(tstate[k], jstate[k])


def test_decode_matches_teacher_forcing():
    """The port alone, seeded bf16 weights: prefill(t[:k]) + decode
    steps == prefill(t[:k+j]) logits, at the bar of
    ``tests/test_model_consistency.py``."""
    m = build_model(t_reduce(t_get(RWKV)))
    params = m.init_params(1, device="cpu")
    toks = torch.randint(0, m.cfg.vocab_size, (1, 40),
                         generator=torch.Generator().manual_seed(0),
                         dtype=torch.int32)
    ref, _ = m.prefill(params, {"tokens": toks})
    k = 32
    lg, state = m.prefill(params, {"tokens": toks[:, :k]})
    for t in toks[0, k:]:
        lg, state = m.decode_step(params, state, t[None])
    np.testing.assert_allclose(lg.float().numpy(), ref.float().numpy(),
                               rtol=0.05, atol=0.15)


def test_state_bytes_equal_sizing():
    """rwkv6-1.6b at 4 rows: the state's bytes (every leaf but lengths)
    are ``decode_state_bytes`` exactly, 25,952,256."""
    cfg = t_get(RWKV)
    specs = build_model(cfg).decode_state_specs(4, 1024)
    nbytes = sum(math.prod(p.shape) * torch.empty(
        (), dtype=getattr(torch, p.dtype or "bfloat16")).element_size()
        for k, p in specs.items() if k != "lengths")
    assert nbytes == sizing.decode_state_bytes(cfg, 1024, 4) == 25_952_256
