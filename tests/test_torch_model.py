"""The port's ``DecoderModel`` serving entry points against the JAX
package's, on reduced llama3.2-1b with float32 params from the JAX
``init_params`` tree (crossed through numpy with ``params_from_numpy``)
and the same numpy-made pools, tables, lengths and tokens: logits and
chunk KV within 1e-4, the bar of ``tests/test_paged_serving.py``."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config import reduce_config  # noqa: E402
from repro.configs import get_config  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models.model import build_model as jax_build  # noqa: E402
from repro_torch.config import reduce_config as t_reduce  # noqa: E402
from repro_torch.configs import get_config as t_get  # noqa: E402
from repro_torch.models import common  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
PAGE, PAGES, SLOTS = 16, 6, 3


@pytest.fixture(scope="module")
def models():
    jcfg = reduce_config(get_config("llama3.2-1b"))
    jm = jax_build(jcfg)
    jp = jax.tree.map(lambda a: a.astype(jnp.float32),
                      jm.init_params(jax.random.PRNGKey(0)))
    tm = build_model(t_reduce(t_get("llama3.2-1b")))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp))
    return jm, jp, tm, tp


def _pools(rng, cfg, n):
    shape = (cfg.n_layers, n, PAGE, cfg.n_kv_heads, cfg.hd)
    return (rng.normal(size=shape).astype(np.float32),
            rng.normal(size=shape).astype(np.float32))


def _close(t, j):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), **TOL)


def test_param_specs_match_jax_tree(models):
    """Same leaves, shapes and init kinds as the JAX spec tree."""
    jm, jp, tm, tp = models
    jleaves = jax.tree_util.tree_flatten_with_path(
        jm.specs, is_leaf=lambda x: isinstance(x, jcommon.PSpec))[0]
    flat = {}

    def walk(tree, path):
        if isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, path + (k,))
        else:
            flat[path] = tree
    walk(tm.specs, ())
    assert len(flat) == len(jleaves)
    for path, spec in jleaves:
        key = tuple(p.key for p in path)
        mine = flat[key]
        assert (mine.shape, mine.axes, mine.init, mine.scale) == \
            (spec.shape, spec.axes, spec.init, spec.scale)
    # and the materialized port tree has the spec shapes
    got = tm.init_params(0, dtype=torch.float32)
    assert got["layers"]["attn"]["wq"].shape == \
        jp["layers"]["attn"]["wq"].shape


def test_blocks_match_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 64)).astype(np.float32)
    g = rng.normal(size=(64,)).astype(np.float32)
    w1, w2 = (rng.normal(size=(64, 96)).astype(np.float32) * 0.1
              for _ in range(2))
    w3 = rng.normal(size=(96, 64)).astype(np.float32) * 0.1
    pos = rng.integers(0, 300, size=(2, 5)).astype(np.int32)
    t = torch.from_numpy
    _close(common.rms_norm(t(x), t(g)), jcommon.rms_norm(x, g))
    _close(common.swiglu(t(x), t(w1), t(w2), t(w3)),
           jcommon.swiglu(x, w1, w2, w3))
    xr = x.reshape(2, 5, 4, 16)
    _close(common.apply_rope(t(xr), t(pos), 5e5),
           jcommon.apply_rope(xr, pos, 5e5))


def test_decode_step_paged_matches_jax(models):
    jm, jp, tm, tp = models
    cfg = tm.cfg
    rng = np.random.default_rng(1)
    n = SLOTS * PAGES + 1
    kp, vp = _pools(rng, cfg, n)
    tables = np.zeros((SLOTS, PAGES), np.int32)
    tables[0, :4] = [3, 7, 1, 9]
    tables[2, :2] = [12, 5]
    lengths = np.asarray([50, 0, 17], np.int32)   # row 1 inactive
    tokens = np.asarray([11, 0, 200], np.int32)
    jstate = {"k_pages": jnp.asarray(kp), "v_pages": jnp.asarray(vp),
              "block_tables": jnp.asarray(tables),
              "lengths": jnp.asarray(lengths)}
    tstate = {"k_pages": torch.from_numpy(kp.copy()),
              "v_pages": torch.from_numpy(vp.copy()),
              "block_tables": torch.from_numpy(tables),
              "lengths": torch.from_numpy(lengths)}
    jl, jnew = jm.decode_step_paged(jp, jstate, jnp.asarray(tokens),
                                    backend="xla")
    tl, tnew = tm.decode_step_paged(tp, tstate, torch.from_numpy(tokens))
    active = [0, 2]
    _close(tl[active], np.asarray(jl)[active])
    assert torch.equal(tnew["lengths"], torch.from_numpy(lengths + 1))
    # the new token's KV landed in the same pool slots (in place here)
    for key in ("k_pages", "v_pages"):
        _close(tnew[key], jnew[key])
        assert tnew[key] is tstate[key]


def _chunk_state(rng, cfg):
    n = PAGES + 2
    kp, vp = _pools(rng, cfg, n)
    table = np.asarray([[4, 2, 6, 1, 3, 7]], np.int32)
    j = {"k_pages": jnp.asarray(kp), "v_pages": jnp.asarray(vp),
         "block_table": jnp.asarray(table)}
    t = {"k_pages": torch.from_numpy(kp), "v_pages": torch.from_numpy(vp),
         "block_table": torch.from_numpy(table)}
    return j, t


@pytest.mark.parametrize("offset", [0, 21])
def test_prefill_chunk_matches_jax(models, offset):
    jm, jp, tm, tp = models
    rng = np.random.default_rng(2 + offset)
    js, ts = _chunk_state(rng, tm.cfg)
    toks = rng.integers(0, 256, size=(1, 16)).astype(np.int32)
    off = np.asarray([offset], np.int32)
    jout = jm.prefill_chunk(jp, js, jnp.asarray(toks), jnp.asarray(off),
                            backend="xla")
    tout = tm.prefill_chunk(tp, ts, torch.from_numpy(toks),
                            torch.from_numpy(off))
    for key in ("k", "v"):
        assert tout[key].shape == jout[key].shape
        _close(tout[key], jout[key])


def test_prefill_chunk_seg_matches_jax(models):
    jm, jp, tm, tp = models
    rng = np.random.default_rng(4)
    js, ts = _chunk_state(rng, tm.cfg)
    toks = rng.integers(0, 256, size=(1, 16)).astype(np.int32)
    cpos = np.asarray([[5, 6, 7, 8, 9, 10, 40, 41, 42, 43, 44, 45, 46,
                        -1, -1, -1]], np.int32)
    jout = jm.prefill_chunk_seg(jp, js, jnp.asarray(toks),
                                jnp.asarray(cpos), backend="xla")
    tout = tm.prefill_chunk_seg(tp, ts, torch.from_numpy(toks),
                                torch.from_numpy(cpos))
    for key in ("k", "v"):
        _close(tout[key], jout[key])


def test_build_model_rejects_unported_families():
    for name in ("granite-moe-1b-a400m", "rwkv6-1.6b", "zamba2-1.2b"):
        with pytest.raises(NotImplementedError):
            build_model(t_reduce(t_get(name)))
