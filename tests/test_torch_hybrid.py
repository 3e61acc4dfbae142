"""The port's Mamba2 mixer (``models/ssm.py``) and hybrid model
(``HybridModel``, reduced zamba2: 4 Mamba2 layers with the shared
attention block after every 2nd, d_inner 128, 8 SSM heads of 16, state
16) against the JAX package's, on float32 params from the JAX
``init_params`` tree crossed through numpy and numpy-made inputs: within
1e-4, the bar of ``tests/test_torch_model.py``.  The port's chunked SSD
against its sequential oracle at the shapes and bar of
``tests/test_model_consistency.py``, its own decode against teacher
forcing at that file's bar, and the state's bytes at full width against
``sizing.decode_state_bytes``: the state holds K-1 conv taps where the
formula counts K."""
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
from repro.models import ssm as jssm  # noqa: E402
from repro.models.model import build_model as jax_build  # noqa: E402
from repro_torch.config import reduce_config as t_reduce  # noqa: E402
from repro_torch.configs import get_config as t_get  # noqa: E402
from repro_torch.core import sizing  # noqa: E402
from repro_torch.models import ssm  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
ZAMBA = "zamba2-1.2b"
GROWN = 64          # the decode tests' slot length
STEPS = 6


def _close(t, j, **tol):
    np.testing.assert_allclose(t.detach().float().numpy(),
                               np.asarray(j, np.float32), **(tol or TOL))


def _t(a):
    return torch.from_numpy(np.array(a))


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


@pytest.fixture(scope="module")
def pair():
    """(JAX model, JAX params, port model, port params), reduced zamba2,
    float32."""
    jm = jax_build(reduce_config(get_config(ZAMBA)))
    tree = jax.tree.map(lambda a: np.array(a, np.float32),
                        jax.jit(jm.init_params)(jax.random.PRNGKey(0)))
    tm = build_model(t_reduce(t_get(ZAMBA)))
    return (jm, jax.tree.map(jnp.asarray, tree), tm,
            params_from_numpy(tree, device="cpu"))


def test_param_and_state_specs_match_jax():
    """Same leaves, shapes, axes, init kinds and dtypes as the JAX spec
    trees (params and the decode state), at full width and reduced."""
    for jcfg, tcfg in ((get_config(ZAMBA), t_get(ZAMBA)),
                       (reduce_config(get_config(ZAMBA)),
                        t_reduce(t_get(ZAMBA)))):
        jm, tm = jax_build(jcfg), build_model(tcfg)
        for jtree, ttree in ((jm.specs, tm.specs),
                             (jm.decode_state_specs(3, 128),
                              tm.decode_state_specs(3, 128))):
            jleaves = jax.tree_util.tree_flatten_with_path(
                jtree, is_leaf=lambda x: isinstance(x, jcommon.PSpec))[0]
            mine = dict(_leaves(ttree))
            assert len(mine) == len(jleaves)
            for path, spec in jleaves:
                got = mine[tuple(p.key for p in path)]
                assert (got.shape, got.axes, got.init, got.scale,
                        got.dtype) == (spec.shape, spec.axes, spec.init,
                                       spec.scale, spec.dtype)


def _ssd_inputs(rng, b, s, h, p, n, init=False):
    x = rng.normal(size=(b, s, h, p)).astype(np.float32)
    dt = rng.uniform(0.01, 0.2, size=(b, s, h)).astype(np.float32)
    a = -rng.uniform(0.5, 2.0, size=(h,)).astype(np.float32)
    bb = rng.normal(size=(b, s, n)).astype(np.float32)
    cc = rng.normal(size=(b, s, n)).astype(np.float32)
    s0 = rng.normal(size=(b, h, p, n)).astype(np.float32) if init else None
    return x, dt, a, bb, cc, s0


@pytest.mark.parametrize("s,chunk,init", [(96, 32, False), (128, 64, True),
                                          (100, 64, False), (37, 16, True)])
def test_ssd_chunked_matches_jax(s, chunk, init):
    """Whole chunks, and ragged lengths: JAX runs one chunk of the whole
    prompt there, the port its full chunks and one remainder chunk."""
    x, dt, a, bb, cc, s0 = _ssd_inputs(np.random.default_rng(s), 2, s, 3,
                                       8, 4, init)
    jy, js = jax.jit(jssm.ssd_chunked, static_argnames="chunk")(
        *map(jnp.asarray, (x, dt, a, bb, cc)), chunk=chunk,
        init_state=None if s0 is None else jnp.asarray(s0))
    ty, ts = ssm.ssd_chunked(*map(_t, (x, dt, a, bb, cc)), chunk=chunk,
                             init_state=None if s0 is None else _t(s0))
    _close(ty, jy)
    _close(ts, js)


def test_ssd_chunked_vs_reference():
    """The port's chunked SSD against its sequential oracle, at
    ``tests/test_model_consistency.py``'s shapes and bar, and at a
    ragged length."""
    for s in (96, 90):
        x, dt, a, bb, cc, _ = _ssd_inputs(np.random.default_rng(0), 2, s, 3,
                                          8, 4)
        args = tuple(map(_t, (x, dt, a, bb, cc)))
        y1, s1 = ssm.ssd_chunked(*args, chunk=32)
        y2, s2 = ssm.ssd_reference(*args)
        _close(y1, y2.numpy())
        _close(s1, s2.numpy())


def test_ssd_step_matches_jax():
    rng = np.random.default_rng(3)
    b, h, p, n = 2, 3, 8, 4
    state = rng.normal(size=(b, h, p, n)).astype(np.float32)
    xt = rng.normal(size=(b, h, p)).astype(np.float32)
    dt = rng.uniform(0.01, 0.2, size=(b, h)).astype(np.float32)
    a = -rng.uniform(0.5, 2.0, size=(h,)).astype(np.float32)
    bt = rng.normal(size=(b, n)).astype(np.float32)
    ct = rng.normal(size=(b, n)).astype(np.float32)
    args = (state, xt, dt, a, bt, ct)
    js, jy = jax.jit(jssm.ssd_step)(*map(jnp.asarray, args))
    ts, ty = ssm.ssd_step(*map(_t, args))
    _close(ts, js)
    _close(ty, jy)


def test_causal_conv_and_conv_step_match_jax():
    """The prompt's causal conv, and its last outputs again from a conv
    state of the K-1 inputs before each token."""
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 9, 5)).astype(np.float32)
    kern = rng.normal(size=(4, 5)).astype(np.float32)
    full = ssm._causal_conv(_t(x), _t(kern))
    _close(full, jssm._causal_conv(jnp.asarray(x), jnp.asarray(kern)))
    state = x[:, 2:5]
    for t in range(5, 9):
        js, jy = jssm._conv_step(jnp.asarray(state), jnp.asarray(x[:, t]),
                                 jnp.asarray(kern))
        ts, ty = ssm._conv_step(_t(state), _t(x[:, t]), _t(kern))
        _close(ty, jy)
        _close(ty, full[:, t].numpy())
        _close(ts, js)
        state = np.asarray(js)


def test_mamba_block_matches_jax(pair):
    jm, jp, tm, tp = pair
    cfg = tm.cfg
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 70, cfg.d_model)).astype(np.float32)
    lp = jax.tree.map(lambda a: a[1], jp["layers"]["mamba"])
    tlp = {k: v[1] for k, v in tp["layers"]["mamba"].items()}
    _close(ssm.mamba_block(tlp, _t(x), cfg),
           jax.jit(lambda p, x: jssm.mamba_block(p, x, jm.cfg))(
               lp, jnp.asarray(x)))


def test_mamba_decode_step_matches_jax(pair):
    jm, jp, tm, tp = pair
    cfg = tm.cfg
    rng = np.random.default_rng(6)
    st = {k: rng.normal(size=p.shape).astype(np.float32)
          for k, p in ssm.mamba_state_pspecs(cfg, 3).items()}
    xt = rng.normal(size=(3, cfg.d_model)).astype(np.float32)
    lp = jax.tree.map(lambda a: a[2], jp["layers"]["mamba"])
    tlp = {k: v[2] for k, v in tp["layers"]["mamba"].items()}
    jy, jst = jax.jit(lambda p, x, s: jssm.mamba_decode_step(
        p, x, s, jm.cfg))(lp, jnp.asarray(xt), jax.tree.map(jnp.asarray, st))
    ty, tst = ssm.mamba_decode_step(tlp, _t(xt),
                                    {k: _t(v) for k, v in st.items()}, cfg)
    _close(ty, jy)
    assert set(tst) == set(jst)
    for k in tst:
        _close(tst[k], jst[k])


def test_prefill_matches_jax(pair):
    """An 80-token prompt: one JAX chunk, a full and a remainder chunk
    in the port.  The logits and every state leaf."""
    jm, jp, tm, tp = pair
    toks = np.random.default_rng(7).integers(0, tm.cfg.vocab_size,
                                             size=(2, 80)).astype(np.int32)
    jl, js = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(toks)})
    tl, ts = tm.prefill(tp, {"tokens": _t(toks)})
    _close(tl, jl)
    jleaves = dict(_leaves(js))
    tleaves = dict(_leaves(ts))
    assert set(tleaves) == set(jleaves)
    for path, leaf in tleaves.items():
        assert tuple(leaf.shape) == jleaves[path].shape, path
        _close(leaf, jleaves[path])
    assert ts["lengths"].tolist() == [80, 80]


def test_decode_matches_jax(pair):
    """Two prompts of different lengths, each prefilled alone and copied
    into row b of one state grown to GROWN slots (on both sides), then
    STEPS teacher-forced decode steps: the logits equal at every step,
    and every state leaf after them."""
    jm, jp, tm, tp = pair
    cfg = tm.cfg
    rng = np.random.default_rng(8)
    lens = (10, 7)
    jstate = jax.tree.map(
        lambda p: np.zeros(p.shape, np.float32 if p.dtype is None
                           else p.dtype),
        jm.decode_state_specs(2, GROWN),
        is_leaf=lambda x: isinstance(x, jcommon.PSpec))
    tstate = jax.tree.map(
        lambda t: t.float() if t.is_floating_point() else t,
        tm.init_decode_state(2, GROWN, device="cpu"))
    prefill = jax.jit(jm.prefill)
    for b, n in enumerate(lens):
        toks = rng.integers(0, cfg.vocab_size, size=(1, n)).astype(np.int32)
        _, js = prefill(jp, {"tokens": jnp.asarray(toks)})
        _, ts = tm.prefill(tp, {"tokens": _t(toks)})
        for path, leaf in _leaves(ts):
            if path == ("lengths",):
                continue
            span = (slice(None), b) + ((slice(0, n),) if path[0] in
                                       ("k", "v") else ())
            _at(jstate, path)[span] = np.asarray(_at(js, path)[:, 0])
            _at(tstate, path)[span] = leaf[:, 0]
        jstate["lengths"][b] = tstate["lengths"][b] = n
    jstate = jax.tree.map(jnp.asarray, jstate)
    step = jax.jit(jm.decode_step)
    for t in rng.integers(0, cfg.vocab_size, size=(STEPS, 2)).astype(
            np.int32):
        jl, jstate = step(jp, jstate, jnp.asarray(t))
        tl, tstate = tm.decode_step(tp, tstate, _t(t))
        _close(tl, jl)
    assert tstate["lengths"].tolist() == [n + STEPS for n in lens]
    for path, leaf in _leaves(tstate):
        _close(leaf, _at(jstate, path))


def test_decode_matches_teacher_forcing():
    """The port alone, seeded bf16 weights: prefill(t[:k]) + decode
    steps == prefill(t[:k+j]) logits, at the bar of
    ``tests/test_model_consistency.py``."""
    m = build_model(t_reduce(t_get(ZAMBA)))
    params = m.init_params(1, device="cpu")
    toks = torch.randint(0, m.cfg.vocab_size, (1, 40),
                         generator=torch.Generator().manual_seed(0),
                         dtype=torch.int32)
    ref, _ = m.prefill(params, {"tokens": toks})
    k = 32
    lg, st = m.prefill(params, {"tokens": toks[:, :k]})
    state = m.init_decode_state(1, 64, device="cpu")
    for key in ("k", "v"):
        state[key][:, :, :k] = st[key]
    for key, t in st["mamba"].items():
        state["mamba"][key].copy_(t)
    state["lengths"] = st["lengths"]
    for t in toks[0, k:]:
        lg, state = m.decode_step(params, state, t[None])
    np.testing.assert_allclose(lg.float().numpy(), ref.float().numpy(),
                               rtol=0.05, atol=0.15)


def test_state_bytes_at_full_width():
    """zamba2-1.2b at 4 rows of 1024: the state holds 284,870,656 bytes
    (every leaf but lengths), the JAX spec's; ``sizing`` counts K = 4
    conv taps where the state holds K-1 = 3, so it is larger by exactly
    n_layers x B x (d_inner + 2 N) x 2 bytes."""
    cfg = t_get(ZAMBA)
    specs = build_model(cfg).decode_state_specs(4, 1024)
    nbytes = sum(math.prod(p.shape) * torch.empty(
        (), dtype=getattr(torch, p.dtype or "bfloat16")).element_size()
        for path, p in _leaves(specs) if path != ("lengths",))
    assert nbytes == 284_870_656
    gap = sizing.decode_state_bytes(cfg, 1024, 4) - nbytes
    assert gap == cfg.n_layers * 4 * (cfg.d_inner + 2 * cfg.ssm_state) * 2
    assert gap == 1_284_096


def test_prefill_shorter_than_conv_state_raises(pair):
    _, _, tm, tp = pair
    with pytest.raises(ValueError, match="at least 3 tokens"):
        tm.prefill(tp, {"tokens": torch.zeros((1, 2), dtype=torch.int32)})
    # K-1 tokens suffice
    tm.prefill(tp, {"tokens": torch.zeros((1, 3), dtype=torch.int32)})
