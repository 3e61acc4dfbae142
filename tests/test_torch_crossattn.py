"""The port's cross-attention families against the JAX package's: the
VLM (reduced llama-3.2-vision: 4 layers, a cross block every 2, 8
patches, G 2) and the encoder-decoder (reduced whisper-tiny: 2 + 2
layers, enc_len 16, G 1).  float32 params from the JAX ``init_params``
tree with every cross gate at 0.7 (the seeded init is zeros, and
``tanh(0) = 0`` would switch the VLM's cross blocks off), crossed
through numpy with ``params_from_numpy``; numpy-made tokens, patches and
frames.  Logits and states within 1e-4, the bar of
``tests/test_torch_model.py``; the port's own decode against teacher
forcing at the bar of ``tests/test_model_consistency.py``; the slot
state's bytes against ``sizing.decode_state_bytes``."""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config import reduce_config  # noqa: E402
from repro.configs import get_config  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.models.model import build_model as jax_build  # noqa: E402
from repro_torch.config import reduce_config as t_reduce  # noqa: E402
from repro_torch.configs import get_config as t_get  # noqa: E402
from repro_torch.core import sizing  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models import common  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.serving import ServingEngine  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
VLM, WHISPER = "llama-3.2-vision-11b", "whisper-tiny"
GATE = 0.7
GROWN = 64          # the decode tests' slot length
STEPS = 6


def _close(t, j):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), **TOL)


def _pair(name):
    """(JAX model, JAX params, port model, port params) on the reduced
    config, float32, cross gates at GATE."""
    jm = jax_build(reduce_config(get_config(name)))
    tree = jax.tree.map(lambda a: np.array(a, np.float32),
                        jm.init_params(jax.random.PRNGKey(0)))
    if "cross" in tree:
        tree["cross"]["gate"][:] = GATE
    tm = build_model(t_reduce(t_get(name)))
    return (jm, jax.tree.map(jnp.asarray, tree), tm,
            params_from_numpy(tree, device="cpu"))


@pytest.fixture(scope="module")
def vlm():
    return _pair(VLM)


@pytest.fixture(scope="module")
def whisper():
    return _pair(WHISPER)


def _memory(rng, cfg, b):
    """The batch's memory input: patches [B,P,D] or frames [B,enc_len,D]."""
    if cfg.n_patches:
        return "patches", rng.normal(size=(b, cfg.n_patches, cfg.d_model))
    return "frames", rng.normal(size=(b, cfg.enc_len, cfg.d_model))


def _batch(tokens, key, mem):
    """The same batch for both sides: (JAX batch, port batch)."""
    toks = np.asarray(tokens, np.int32)
    mem = np.asarray(mem, np.float32)
    return ({"tokens": jnp.asarray(toks), key: jnp.asarray(mem)},
            {"tokens": torch.from_numpy(toks), key: torch.from_numpy(mem)})


@pytest.mark.parametrize("name", [VLM, WHISPER])
def test_param_specs_match_jax_tree(name):
    """Same leaves, shapes, axes and init kinds as the JAX spec tree, at
    full width and reduced."""
    for jcfg, tcfg in ((get_config(name), t_get(name)),
                       (reduce_config(get_config(name)),
                        t_reduce(t_get(name)))):
        jleaves = jax.tree_util.tree_flatten_with_path(
            jax_build(jcfg).specs,
            is_leaf=lambda x: isinstance(x, jcommon.PSpec))[0]
        mine = {}

        def walk(tree, path):
            if isinstance(tree, dict):
                for k, v in tree.items():
                    walk(v, path + (k,))
            else:
                mine[path] = tree
        walk(build_model(tcfg).specs, ())
        assert len(mine) == len(jleaves)
        for path, spec in jleaves:
            got = mine[tuple(p.key for p in path)]
            assert (got.shape, got.axes, got.init, got.scale, got.dtype) == \
                (spec.shape, spec.axes, spec.init, spec.scale, spec.dtype)


@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("masked", [False, True])
def test_full_attention_matches_jax(g, masked):
    rng = np.random.default_rng(10 + g)
    b, sq, sk, hkv, hd = 2, 5, 9, 2, 16
    q = rng.normal(size=(b, sq, hkv * g, hd)).astype(np.float32)
    k = rng.normal(size=(b, sk, hkv, hd)).astype(np.float32)
    v = rng.normal(size=(b, sk, hkv, hd)).astype(np.float32)
    mask = None
    if masked:
        mask = rng.random((b, sk)) < 0.6
        mask[:, 0] = True
    t = torch.from_numpy
    got = attn.full_attention(t(q), t(k), t(v),
                              None if mask is None else t(mask))
    want = jattn.full_attention(q, k, v, None if mask is None
                                else jnp.asarray(mask))
    _close(got, want)
    if masked:
        # a masked key moves nothing
        k2, v2 = k.copy(), v.copy()
        k2[~mask], v2[~mask] = 50.0, 50.0
        _close(attn.full_attention(t(q), t(k2), t(v2), t(mask)), want)


def test_sinusoid_at_matches_jax():
    pos = np.random.default_rng(3).integers(0, 1500, size=(3, 7))
    for dim in (16, 64, 384):
        got = common.sinusoid_at(torch.from_numpy(pos), dim)
        assert got.dtype == torch.float32
        _close(got, jmodel._sinusoid_at(jnp.asarray(pos), dim))
    assert common.sinusoid_at(torch.from_numpy(pos), 16,
                              torch.bfloat16).dtype == torch.bfloat16


def test_vlm_prefill_matches_jax(vlm):
    jm, jp, tm, tp = vlm
    cfg = tm.cfg
    rng = np.random.default_rng(5)
    toks = rng.integers(0, cfg.vocab_size, size=(2, 11))
    key, mem = _memory(rng, cfg, 2)
    jb, tb = _batch(toks, key, mem)
    jl, js = jm.prefill(jp, jb)
    tl, ts = tm.prefill(tp, tb)
    _close(tl, jl)
    assert set(ts) == set(js) == {"k", "v", "xk", "xv", "lengths"}
    for k in ("k", "v", "xk", "xv"):
        assert ts[k].shape == js[k].shape
        _close(ts[k], js[k])
    assert ts["lengths"].tolist() == [11, 11]
    # the cross path is live: other patches move the logits
    _, tb2 = _batch(toks, key, rng.normal(size=mem.shape))
    moved = float((tm.prefill(tp, tb2)[0] - tl).abs().max())
    assert moved > 1e-3, moved


def _grow(state, n):
    """A prefilled state with its self K/V slots padded to ``n``."""
    out = dict(state)
    for k in ("k", "v"):
        x = state[k]
        out[k] = torch.cat([x, x.new_zeros(x.shape[:2] + (n - x.shape[2],)
                                           + x.shape[3:])], dim=2)
    return out


def _decode_against_jax(jm, jp, tm, tp, seed):
    """Two prompts of different lengths, each prefilled alone and copied
    into row b of one state grown to GROWN slots (on both sides), then
    STEPS teacher-forced decode steps; the logits equal at every step."""
    cfg = tm.cfg
    rng = np.random.default_rng(seed)
    lens = (10, 7)
    jstate = {k: np.zeros(p.shape, np.float32 if p.dtype is None
                          else p.dtype)
              for k, p in jm.decode_state_specs(2, GROWN).items()}
    tstate = tm.init_decode_state(2, GROWN, device="cpu")
    tstate = {k: v.float() if v.is_floating_point() else v
              for k, v in tstate.items()}
    for b, n in enumerate(lens):
        toks = rng.integers(0, cfg.vocab_size, size=(1, n))
        key, mem = _memory(rng, cfg, 1)
        jb, tb = _batch(toks, key, mem)
        _, js = jm.prefill(jp, jb)
        _, ts = tm.prefill(tp, tb)
        for k in ("k", "v", "xk", "xv"):
            span = slice(None) if k[0] == "x" else slice(0, n)
            jstate[k][:, b, span] = np.asarray(js[k][:, 0])
            tstate[k][:, b, span] = ts[k][:, 0]
        jstate["lengths"][b] = tstate["lengths"][b] = n
    jstate = {k: jnp.asarray(v) for k, v in jstate.items()}
    step = jax.jit(jm.decode_step)
    teacher = rng.integers(0, cfg.vocab_size, size=(STEPS, 2)).astype(
        np.int32)
    for t in teacher:
        jl, jstate = step(jp, jstate, jnp.asarray(t))
        tl, tstate = tm.decode_step(tp, tstate, torch.from_numpy(t))
        _close(tl, jl)
    assert tstate["lengths"].tolist() == [n + STEPS for n in lens]
    for k in ("k", "v"):
        _close(tstate[k], jstate[k])


def test_vlm_decode_matches_jax(vlm):
    _decode_against_jax(*vlm, seed=6)


def test_encdec_encode_and_prefill_match_jax(whisper):
    jm, jp, tm, tp = whisper
    cfg = tm.cfg
    rng = np.random.default_rng(7)
    toks = rng.integers(0, cfg.vocab_size, size=(2, 9))
    key, mem = _memory(rng, cfg, 2)
    jb, tb = _batch(toks, key, mem)
    _close(tm.encode(tp, tb["frames"]), jm.encode(jp, jb["frames"]))
    jl, js = jm.prefill(jp, jb)
    tl, ts = tm.prefill(tp, tb)
    _close(tl, jl)
    assert set(ts) == set(js)
    for k in ("k", "v", "xk", "xv"):
        assert ts[k].shape == js[k].shape
        _close(ts[k], js[k])
    _, tb2 = _batch(toks, key, rng.normal(size=mem.shape))
    moved = float((tm.prefill(tp, tb2)[0] - tl).abs().max())
    assert moved > 1e-3, moved


def test_encdec_decode_matches_jax(whisper):
    _decode_against_jax(*whisper, seed=8)


@pytest.mark.parametrize("name", [VLM, WHISPER])
def test_decode_matches_teacher_forcing(name):
    """The port alone, seeded bf16 weights: prefill(t[:k]) + decode
    steps == prefill(t[:k+j]) logits, at the bar of
    ``tests/test_model_consistency.py``."""
    m = build_model(t_reduce(t_get(name)))
    cfg = m.cfg
    params = m.init_params(1, device="cpu")
    if "cross" in params:
        params["cross"]["gate"].fill_(GATE)
    g = torch.Generator().manual_seed(0)
    toks = torch.randint(0, cfg.vocab_size, (1, 40), generator=g,
                         dtype=torch.int32)
    key = "patches" if cfg.n_patches else "frames"
    mem = torch.randn((1, cfg.n_patches or cfg.enc_len, cfg.d_model),
                      generator=g).bfloat16()
    ref, _ = m.prefill(params, {"tokens": toks, key: mem})
    k = 32
    lg, state = m.prefill(params, {"tokens": toks[:, :k], key: mem})
    state = _grow(state, 64)
    for t in toks[0, k:]:
        lg, state = m.decode_step(params, state, t[None])
    np.testing.assert_allclose(lg.float().numpy(), ref.float().numpy(),
                               rtol=0.05, atol=0.15)


@pytest.mark.parametrize("name,batch,max_len", [(VLM, 4, 1024),
                                                (WHISPER, 8, 448)])
def test_state_bytes_equal_sizing(name, batch, max_len):
    """At full width, the slot state's bytes (every spec but lengths,
    reckoned from the specs) are ``decode_state_bytes`` exactly."""
    cfg = t_get(name)
    specs = build_model(cfg).decode_state_specs(batch, max_len)
    nbytes = sum(math.prod(p.shape) * torch.empty(
        (), dtype=getattr(torch, p.dtype or "bfloat16")).element_size()
        for k, p in specs.items() if k != "lengths")
    assert nbytes == sizing.decode_state_bytes(cfg, max_len, batch)


def test_cross_attention_families_have_model_entry_points_only():
    """No engine, no paged or chunked entry point, no int8 slots."""
    for name in (VLM, WHISPER):
        cfg = t_reduce(t_get(name))
        m = build_model(cfg)
        assert not m.supports_paged_decode()
        assert not m.supports_chunked_prefill()
        with pytest.raises(ValueError):
            build_model(cfg, kv_dtype="int8")
        with pytest.raises(NotImplementedError):
            ServingEngine(cfg, device="cpu")
    with pytest.raises(NotImplementedError):
        build_model(t_reduce(t_get(VLM))).decode_step_paged(None, {}, None)
