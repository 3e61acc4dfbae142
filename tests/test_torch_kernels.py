"""The port's paged attention ops (plain PyTorch versions, the CPU path)
against the JAX package's oracles (``repro.kernels.ref``), its ``xla``
fallbacks and its interpret-mode Pallas kernels, on the same numpy
inputs: ragged and zero lengths, garbage past the offset, -1 padding,
unresident pool slots, clamped table entries, and the contiguous
segment == offset identity.  Tolerance 1e-4 in float32, the bar of
``tests/test_xla_backend.py``."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.paged_prefill import _pool_limits  # noqa: E402
from repro_torch.kernels import backend as tb  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)


def _rand(rng, shape):
    return rng.normal(size=shape).astype(np.float32)


def _both(a):
    return jnp.asarray(a), torch.from_numpy(np.array(a))


def _close(t, j, **tol):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **(tol or TOL))


# ---------------------------------------------------------------------------
# backend resolution
# ---------------------------------------------------------------------------
def test_backend_resolution():
    x = torch.zeros(2)
    assert tb.resolve_backend(None, x) == "torch"
    assert tb.resolve_backend("torch", x) == "torch"
    assert tb.resolve_backend(" Torch ", x) == "torch"
    with pytest.raises(ValueError, match="CUDA tensors"):
        tb.resolve_backend("cuda", x)
    with pytest.raises(ValueError, match="unknown"):
        tb.resolve_backend("xla", x)


def test_cuda_backend_on_cpu_tensor_raises():
    rng = np.random.default_rng(0)
    q = torch.from_numpy(_rand(rng, (1, 4, 16)))
    kp = torch.from_numpy(_rand(rng, (3, 8, 2, 16)))
    bt = torch.ones((1, 2), dtype=torch.int32)
    ln = torch.tensor([5], dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        ops.paged_decode(q, kp, kp, bt, ln, backend="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        ops.paged_prefill(q[:, None], kp[:1, :1], kp[:1, :1], kp, kp, bt,
                          ln, backend="cuda")


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("b,hq,hkv,hd,page,pages", [
    (3, 8, 2, 64, 64, 4),       # GQA
    (3, 4, 4, 32, 32, 3),       # MHA
    (2, 8, 1, 128, 64, 2),      # MQA
])
def test_paged_decode_matches_oracle(b, hq, hkv, hd, page, pages):
    rng = np.random.default_rng(1)
    n = b * pages + 2
    q, kp, vp = (_rand(rng, (b, hq, hd)), _rand(rng, (n, page, hkv, hd)),
                 _rand(rng, (n, page, hkv, hd)))
    bt = rng.permutation(n)[:b * pages].reshape(b, pages).astype(np.int32)
    ln = rng.integers(1, pages * page, size=b).astype(np.int32)
    ln[0] = pages * page                       # a full table
    args = [_both(a) for a in (q, kp, vp, bt, ln)]
    out = ops.paged_decode(*[t for _, t in args])
    _close(out, jref.paged_decode_attention_ref(*[j for j, _ in args]))


def test_paged_decode_zero_length_rows_are_zero():
    """A row with length 0 reads no page and returns zeros (the Pallas
    kernel's gating); the others still match the oracle."""
    rng = np.random.default_rng(2)
    b, hq, hkv, hd, page, pages = 3, 4, 2, 32, 16, 3
    n = b * pages + 1
    q, kp, vp = (_rand(rng, (b, hq, hd)), _rand(rng, (n, page, hkv, hd)),
                 _rand(rng, (n, page, hkv, hd)))
    bt = np.zeros((b, pages), np.int32)
    bt[0] = [1, 2, 3]
    bt[2] = [4, 5, 0]
    ln = np.asarray([40, 0, 17], np.int32)
    args = [_both(a) for a in (q, kp, vp, bt, ln)]
    out = ops.paged_decode(*[t for _, t in args])
    assert torch.equal(out[1], torch.zeros_like(out[1]))
    pallas = jops.paged_decode(*[j for j, _ in args], backend="interpret")
    _close(out, pallas)
    oracle = jref.paged_decode_attention_ref(*[j for j, _ in args])
    _close(out[[0, 2]], np.asarray(oracle)[[0, 2]])


def test_paged_decode_clamps_table_entries():
    """Out-of-range and padded table entries clamp into the pool (clip
    semantics of the ``xla`` fallback) and never reach the output."""
    rng = np.random.default_rng(3)
    b, hq, hkv, hd, page, pages = 2, 4, 2, 32, 16, 4
    n = b * pages + 1
    q, kp, vp = (_rand(rng, (b, hq, hd)), _rand(rng, (n, page, hkv, hd)),
                 _rand(rng, (n, page, hkv, hd)))
    ln = np.asarray([17, 5], np.int32)
    bt = np.asarray([[1, 2, 4, 99], [3, 6, 7, -5]], np.int32)
    args = [_both(a) for a in (q, kp, vp, bt, ln)]
    out = ops.paged_decode(*[t for _, t in args])
    _close(out, jops.paged_decode(*[j for j, _ in args], backend="xla"))
    kp2, vp2 = kp.copy(), vp.copy()
    kp2[4:], vp2[4:] = 999.0, 999.0
    out2 = ops.paged_decode(torch.from_numpy(q), torch.from_numpy(kp2),
                            torch.from_numpy(vp2), torch.from_numpy(bt),
                            torch.from_numpy(ln))
    assert torch.allclose(out, out2, **TOL)


def test_paged_decode_bf16_pool_f32_query():
    """The engine's mix: float32 activations over a bf16 pool."""
    rng = np.random.default_rng(4)
    b, hq, hkv, hd, page, pages = 2, 8, 2, 16, 16, 3
    n = b * pages + 1
    q, kp, vp = (_rand(rng, (b, hq, hd)), _rand(rng, (n, page, hkv, hd)),
                 _rand(rng, (n, page, hkv, hd)))
    bt = rng.permutation(n)[:b * pages].reshape(b, pages).astype(np.int32)
    ln = np.asarray([33, 9], np.int32)
    out = ops.paged_decode(torch.from_numpy(q),
                           torch.from_numpy(kp).bfloat16(),
                           torch.from_numpy(vp).bfloat16(),
                           torch.from_numpy(bt), torch.from_numpy(ln))
    assert out.dtype == torch.float32
    jo = jref.paged_decode_attention_ref(
        jnp.asarray(q), jnp.asarray(kp, jnp.bfloat16),
        jnp.asarray(vp, jnp.bfloat16), jnp.asarray(bt), jnp.asarray(ln))
    _close(out, jo)


# ---------------------------------------------------------------------------
# chunked prefill
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("b,c,hq,hkv,hd,page,pages,offs", [
    (2, 16, 4, 2, 32, 8, 5, (19, 0)),     # GQA, unaligned + zero offset
    (1, 32, 8, 8, 64, 32, 3, (64,)),      # MHA, page-aligned offset
    (2, 8, 4, 1, 16, 16, 4, (5, 48)),     # MQA
])
def test_paged_prefill_matches_oracle(b, c, hq, hkv, hd, page, pages, offs):
    rng = np.random.default_rng(5)
    n = b * pages + 2
    arrs = (_rand(rng, (b, c, hq, hd)), _rand(rng, (b, c, hkv, hd)),
            _rand(rng, (b, c, hkv, hd)), _rand(rng, (n, page, hkv, hd)),
            _rand(rng, (n, page, hkv, hd)),
            rng.permutation(n)[:b * pages].reshape(b, pages).astype(np.int32),
            np.asarray(offs, np.int32))
    args = [_both(a) for a in arrs]
    out = ops.paged_prefill(*[t for _, t in args])
    _close(out, jref.paged_prefill_attention_ref(*[j for j, _ in args]))


def test_paged_prefill_ignores_pool_garbage_past_offset():
    rng = np.random.default_rng(6)
    b, c, hq, hkv, hd, page, pages = 1, 8, 4, 2, 32, 8, 4
    n = pages + 1
    q, kc, vc = (_rand(rng, (b, c, hq, hd)), _rand(rng, (b, c, hkv, hd)),
                 _rand(rng, (b, c, hkv, hd)))
    kp, vp = _rand(rng, (n, page, hkv, hd)), _rand(rng, (n, page, hkv, hd))
    bt = np.arange(1, n, dtype=np.int32).reshape(1, pages)
    off = np.asarray([11], np.int32)
    t = [torch.from_numpy(a) for a in (q, kc, vc, kp, vp, bt, off)]
    out = ops.paged_prefill(*t)
    pos = np.arange(n)[:, None] * page + np.arange(page)[None, :] - page
    kp2, vp2 = kp.copy(), vp.copy()
    kp2[pos >= 11], vp2[pos >= 11] = 999.0, 999.0
    t[3], t[4] = torch.from_numpy(kp2), torch.from_numpy(vp2)
    assert torch.allclose(out, ops.paged_prefill(*t), **TOL)
    _close(out, jops.paged_prefill(*[jnp.asarray(a) for a in
                                     (q, kc, vc, kp, vp, bt, off)],
                                   backend="interpret"))


# ---------------------------------------------------------------------------
# segment prefill
# ---------------------------------------------------------------------------
def _cpos(rows, c):
    return np.asarray([list(r) + [-1] * (c - len(r)) for r in rows],
                      np.int32)


SEG_CASES = [
    # GQA: two runs around a resumed island + a ragged padded row
    (2, 8, 4, 2, 32, 8, 5, ([3, 4, 5, 6, 21, 22, 23, 24],
                            [0, 1, 2, 3, 4, 5])),
    # MHA: page-aligned runs around a whole resumed page
    (1, 16, 8, 8, 64, 32, 3, ([8, 9, 10, 11, 12, 13, 14, 15,
                               64, 65, 66, 67, 68, 69, 70, 71],)),
    # MQA: run crossing a page boundary + a far gap
    (2, 8, 4, 1, 16, 16, 4, ([5, 6, 7, 8, 9, 50, 51, 52],
                             [10, 11, 12, 13, 14, 15, 16, 17])),
    # an all-padding row next to a real one
    (2, 8, 4, 2, 16, 8, 3, ([2, 3, 9, 10], [])),
]


@pytest.mark.parametrize("b,c,hq,hkv,hd,page,pages,rows", SEG_CASES)
def test_paged_prefill_seg_matches_oracle(b, c, hq, hkv, hd, page, pages,
                                          rows):
    rng = np.random.default_rng(7)
    n = b * pages + 2
    arrs = (_rand(rng, (b, c, hq, hd)), _rand(rng, (b, c, hkv, hd)),
            _rand(rng, (b, c, hkv, hd)), _rand(rng, (n, page, hkv, hd)),
            _rand(rng, (n, page, hkv, hd)),
            rng.permutation(n)[:b * pages].reshape(b, pages).astype(np.int32),
            _cpos(rows, c))
    args = [_both(a) for a in arrs]
    out = ops.paged_prefill_seg(*[t for _, t in args])
    _close(out, jref.paged_prefill_segments_ref(*[j for j, _ in args]))
    if not all(rows):
        # all-padding rows: the Pallas kernel's gating, in interpret mode
        _close(out, jops.paged_prefill_seg(*[j for j, _ in args],
                                           backend="interpret"))
    _close(ref.pool_limits(args[-1][1]),
           _pool_limits(args[-1][0], c), rtol=0, atol=0)


def test_paged_prefill_seg_ignores_unresident_slots():
    """Pool slots the chunk itself will fill hold garbage (not yet
    written): they never reach the output, and padded queries (-1)
    attend no pool token."""
    rng = np.random.default_rng(8)
    b, c, hq, hkv, hd, page, pages = 1, 8, 4, 2, 16, 8, 4
    n = pages + 1
    q, kc, vc = (_rand(rng, (b, c, hq, hd)), _rand(rng, (b, c, hkv, hd)),
                 _rand(rng, (b, c, hkv, hd)))
    kp, vp = _rand(rng, (n, page, hkv, hd)), _rand(rng, (n, page, hkv, hd))
    bt = np.arange(1, n, dtype=np.int32).reshape(1, pages)
    rows = [2, 3, 4, 20, 21, 22]
    cp = _cpos([rows], c)
    t = [torch.from_numpy(a) for a in (q, kc, vc, kp, vp, bt, cp)]
    out = ops.paged_prefill_seg(*t)
    kp2, vp2 = kp.copy(), vp.copy()
    for p in rows:                     # the chunk's own slots
        kp2[1 + p // page, p % page] = 999.0
        vp2[1 + p // page, p % page] = 999.0
    for p in range(rows[-1] + 1, pages * page):   # past the last query
        kp2[1 + p // page, p % page] = 999.0
        vp2[1 + p // page, p % page] = 999.0
    t[3], t[4] = torch.from_numpy(kp2), torch.from_numpy(vp2)
    out2 = ops.paged_prefill_seg(*t)
    assert torch.allclose(out, out2, **TOL)
    assert torch.isfinite(out2).all()


def test_paged_prefill_seg_contiguous_equals_offset_bitwise():
    """One contiguous run (cpos = offset + arange) reproduces the
    scalar-offset op bit for bit."""
    rng = np.random.default_rng(9)
    b, c, hq, hkv, hd, page, pages = 2, 8, 4, 2, 32, 8, 5
    n = b * pages + 2
    arrs = [_rand(rng, (b, c, hq, hd)), _rand(rng, (b, c, hkv, hd)),
            _rand(rng, (b, c, hkv, hd)), _rand(rng, (n, page, hkv, hd)),
            _rand(rng, (n, page, hkv, hd)),
            rng.permutation(n)[:b * pages].reshape(b, pages).astype(np.int32)]
    t = [torch.from_numpy(a) for a in arrs]
    offs = (19, 0)
    cp = torch.from_numpy(_cpos([[o + i for i in range(c)] for o in offs], c))
    out_seg = ops.paged_prefill_seg(*t, cp)
    out_off = ops.paged_prefill(*t, torch.tensor(offs, dtype=torch.int32))
    assert torch.equal(out_seg, out_off)
    assert torch.equal(ref.pool_limits(cp),
                       torch.tensor(offs, dtype=torch.int32))
