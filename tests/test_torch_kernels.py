"""The port's attention ops (plain PyTorch versions, the CPU path)
against the JAX package's oracles (``repro.kernels.ref``), its ``xla``
fallbacks and its interpret-mode Pallas kernels, on the same numpy
inputs: ragged and zero lengths, garbage past the offset, -1 padding,
unresident pool slots, clamped table entries, the contiguous segment ==
offset identity, causal flash prefill at whole and ragged tile counts,
and int8 paged decode.  Tolerance 1e-4 in float32, the bar of
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
    with pytest.raises(ValueError, match="CUDA"):
        ops.flash_causal(q[:, None], kp[:1, :1], kp[:1, :1], backend="cuda")
    i8 = kp.to(torch.int8)
    sc = kp[..., :1].bfloat16()
    with pytest.raises(ValueError, match="CUDA"):
        ops.paged_decode_int8(q, i8, i8, sc, sc, bt, ln, backend="cuda")


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


# ---------------------------------------------------------------------------
# causal flash prefill (dense sequence)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("b,s,hq,hkv,hd", [
    (1, 128, 4, 2, 64),         # GQA, two 64-row tiles
    (2, 128, 4, 4, 32),         # MHA
    (1, 128, 8, 1, 16),         # MQA
])
def test_flash_causal_matches_pallas_interpret(b, s, hq, hkv, hd):
    """S a multiple of the Pallas kernel's 64-row block: the port's plain
    version equals the interpret-mode kernel and the oracle."""
    rng = np.random.default_rng(11)
    arrs = (_rand(rng, (b, s, hq, hd)), _rand(rng, (b, s, hkv, hd)),
            _rand(rng, (b, s, hkv, hd)))
    args = [_both(a) for a in arrs]
    out = ops.flash_causal(*[t for _, t in args])
    jargs = [j for j, _ in args]
    _close(out, jops.flash_causal(*jargs, block_q=64, block_k=64,
                                  backend="interpret"))
    _close(out, jref.flash_prefill_ref(*jargs))


@pytest.mark.parametrize("s", [96, 160, 1])
def test_flash_causal_ragged_length_matches_oracle(s):
    """Any S, a ragged last tile included (160 = 128 + 32), against the
    oracle (the Pallas kernel leaves a partial tile's rows unwritten, so
    it is no reference there); one query row attends only itself."""
    rng = np.random.default_rng(12)
    arrs = (_rand(rng, (2, s, 4, 64)), _rand(rng, (2, s, 2, 64)),
            _rand(rng, (2, s, 2, 64)))
    args = [_both(a) for a in arrs]
    out = ops.flash_causal(*[t for _, t in args])
    assert out.shape == (2, s, 4, 64)
    _close(out, jref.flash_prefill_ref(*[j for j, _ in args]))


# ---------------------------------------------------------------------------
# int8 paged decode
# ---------------------------------------------------------------------------
def _int8_pool(rng, n, page, hkv, hd):
    """int8 pages and bf16 per-token-head scales from the JAX package's
    own quantizer, as numpy (scales as float32 holding bf16 values)."""
    from repro.models.attention import quantize_kv
    vals, scales = quantize_kv(jnp.asarray(_rand(rng, (n, page, hkv, hd))))
    return np.array(vals), np.array(scales.astype(jnp.float32))


@pytest.mark.parametrize("b,hq,hkv,hd,page,pages", [
    (3, 8, 2, 64, 16, 4),       # GQA
    (2, 4, 4, 32, 32, 3),       # MHA
])
def test_paged_decode_int8_matches_pallas_interpret(b, hq, hkv, hd, page,
                                                    pages):
    """Ragged lengths, a length-0 row (zeros) and a clamped entry past
    the length: the plain version equals the interpret-mode kernel and
    the dequantize-then-attend oracle."""
    rng = np.random.default_rng(13)
    n = b * pages + 2
    q = _rand(rng, (b, hq, hd))
    kq, ks = _int8_pool(rng, n, page, hkv, hd)
    vq, vs = _int8_pool(rng, n, page, hkv, hd)
    bt = rng.permutation(n)[:b * pages].reshape(b, pages).astype(np.int32)
    ln = rng.integers(1, pages * page, size=b).astype(np.int32)
    ln[0] = pages * page - 3
    ln[1] = 0
    bt[-1, -1] = 999
    ln[-1] = min(ln[-1], (pages - 1) * page)
    jargs = [jnp.asarray(q), jnp.asarray(kq), jnp.asarray(vq),
             jnp.asarray(ks, jnp.bfloat16), jnp.asarray(vs, jnp.bfloat16),
             jnp.asarray(bt), jnp.asarray(ln)]
    targs = [torch.from_numpy(a) for a in (q, kq, vq)] + [
        torch.from_numpy(ks).bfloat16(), torch.from_numpy(vs).bfloat16(),
        torch.from_numpy(bt), torch.from_numpy(ln)]
    out = ops.paged_decode_int8(*targs)
    assert torch.equal(out[1], torch.zeros_like(out[1]))
    _close(out, jops.paged_decode_int8(*jargs, backend="interpret"))
    # the oracle has no zero-length gate: hold it to the other rows
    jargs[5] = jnp.clip(jargs[5], 0, n - 1)
    live = [0] + list(range(2, b))
    _close(out[live],
           np.asarray(jref.paged_decode_attention_int8_ref(*jargs))[live])


# ---------------------------------------------------------------------------
# the tensor-core kernels' one extra rounding: P in bf16 before P V
# ---------------------------------------------------------------------------
# On the card, bf16 flash prefill and MLA chunk prefill round the
# probabilities to bf16 in registers and use them as the A operand of the
# value product (float32 scores, softmax, denominator and accumulation).
# These tests hold the plain versions computed that way to the unchanged
# float32 plain versions on bf16 inputs: both agree within 2^-6, the card
# tests' bf16 tolerance, so that tolerance covers the extra rounding.
P_BF16_TOL = 2.0 ** -6


def _softmax_p_bf16(s, mask):
    """Masked softmax weights of ``ref._attend`` and their denominator,
    the weights rounded to bf16 as the value product's operand."""
    s = s.masked_fill(~mask, ref.NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True)) * mask
    return p.bfloat16().float(), p.sum(dim=-1, keepdim=True)


def _flash_p_bf16(q, k, v):
    """``ref.flash_prefill`` with P rounded to bf16 before P V."""
    b, s, hq, hd = q.shape
    hkv = k.shape[2]
    qg = q.reshape(b, s, hkv, hq // hkv, hd).float()
    sc = torch.einsum("bchgd,bthd->bchgt", qg, k.float()) / np.sqrt(hd)
    mask = ref.causal_mask(s, s, 0, q.device)[:, :, None, None, :]
    p, l = _softmax_p_bf16(sc, mask)
    o = torch.einsum("bchgt,bthd->bchgd", p, v.float()) / l.clamp_min(1e-30)
    return o.reshape(b, s, hq, hd).to(q.dtype)


def _mla_chunk_p_bf16(q_lat, q_rope, lat_chunk, pages, tables, offsets,
                      dl, scale):
    """``ref._mla_chunk_attend`` over an offset prior with P rounded to
    bf16 before P V."""
    t = tables.shape[1] * pages.shape[1]
    mask = ref._with_chunk(ref._offset_prior(offsets, q_lat.shape[1], t))
    lat = torch.cat([ref._gather(pages, tables).float(),
                     lat_chunk.float()], dim=1)
    c, kr = lat[..., :dl], lat[..., dl:]
    s = (torch.einsum("bchl,btl->bcht", q_lat.float(), c)
         + torch.einsum("bchr,btr->bcht", q_rope.float(), kr)) * scale
    p, l = _softmax_p_bf16(s, mask[:, :, None, :])
    return (torch.einsum("bcht,btl->bchl", p, c)
            / l.clamp_min(1e-30)).to(q_lat.dtype)


def _bf16(rng, shape):
    return torch.from_numpy(_rand(rng, shape)).bfloat16()


@pytest.mark.parametrize("b,s,hq,hkv,hd", [
    (1, 416, 32, 8, 64), (2, 160, 8, 2, 64), (1, 100, 4, 4, 32),
    (1, 70, 8, 1, 128), (3, 1, 4, 2, 16), (1, 17, 4, 2, 64),
    (1, 65, 4, 2, 128), (1, 129, 4, 1, 64),
])
def test_flash_p_rounded_to_bf16_within_card_tolerance(b, s, hq, hkv, hd):
    rng = np.random.default_rng(s + hd)
    q, k, v = (_bf16(rng, (b, s, h, hd)) for h in (hq, hkv, hkv))
    exact = ref.flash_prefill(q, k, v)
    rounded = _flash_p_bf16(q, k, v)
    assert float((rounded.float() - exact.float()).abs().max()) <= P_BF16_TOL


@pytest.mark.parametrize("hq,dl,dr,page,pages,c,offs", [
    (4, 32, 8, 16, 5, 8, (0, 5, 40)),
    (40, 96, 16, 16, 5, 8, (0, 5, 40)),
    (128, 512, 64, 16, 5, 8, (0, 5, 40)),       # DeepSeek-V3's width
    (128, 512, 64, 64, 3, 16, (45, 120)),       # ragged window, page cross
])
def test_mla_chunk_p_rounded_to_bf16_within_card_tolerance(hq, dl, dr, page,
                                                           pages, c, offs):
    rng = np.random.default_rng(hq + dl)
    b = len(offs)
    n = b * pages + 2
    tables = torch.from_numpy(rng.permutation(n - 1)[:b * pages].reshape(
        b, pages).astype(np.int32) + 1)
    args = (_bf16(rng, (b, c, hq, dl)), _bf16(rng, (b, c, hq, dr)),
            _bf16(rng, (b, c, dl + dr)), _bf16(rng, (n, page, dl + dr)),
            tables, torch.tensor(offs, dtype=torch.int32))
    exact = ref.mla_paged_prefill(*args, d_latent=dl)
    rounded = _mla_chunk_p_bf16(*args, dl, ref.mla_scale(dl, dr))
    assert float((rounded.float() - exact.float()).abs().max()) <= P_BF16_TOL


# ---------------------------------------------------------------------------
# the bf16 decode kernels' split key walks: partials merged in order
# ---------------------------------------------------------------------------
# On the card, bf16 MLA decode splits each row's key walk into splits of
# `decode_split_tokens(P * page)` tokens over blocks, and bf16 GQA decode
# gives each of a block's four warps 16 keys of every 64-key tile; each
# split (warp) keeps its own float32 (m, l, acc) with P rounded to bf16
# for P V, and the partials are merged in split order:
# w_s = 2^(m_s - max m), out = sum w_s acc_s / max(sum w_s l_s, 1e-30),
# with m kept finite (>= NEG_INF) for a split with no valid key.  These
# tests compute the plain versions that way, over every split of the
# window (the kernels skip the empty ones), and hold them to the
# unchanged plain versions and to the JAX package's Pallas kernels.
LOG2E = 1.4426950408889634


def _split_merge(s, mask, split_of, pv, p_bf16):
    """Scores ``s`` [..., T] (scaled), ``mask`` [..., T], ``split_of``
    [T] (each key's split) and ``pv`` (probabilities [..., T] -> their
    product with the values [..., dv]) -> the merged context."""
    x = (s * LOG2E).masked_fill(~mask, ref.NEG_INF)
    parts = []
    for sp in range(int(split_of.max()) + 1):
        own = mask & (split_of == sp)
        xs = x.masked_fill(~own, ref.NEG_INF)
        m = xs.amax(dim=-1, keepdim=True).clamp_min(ref.NEG_INF)
        p = torch.exp2(xs - m) * own
        parts.append((m, p.sum(dim=-1, keepdim=True),
                      pv(p.bfloat16().float() if p_bf16 else p)))
    mx = torch.stack([m for m, _, _ in parts]).amax(dim=0)
    den, acc = 0.0, 0.0
    for m, l, a in parts:                       # in split order
        w = torch.exp2(m - mx)
        den, acc = den + w * l, acc + w * a
    return acc / den.clamp_min(1e-30)


def _mla_split_decode(q_lat, q_rope, pages, tables, lengths, dl, scale,
                      p_bf16=True):
    """``ref.mla_paged_decode`` with the key walk split as the kernel
    splits it."""
    from repro_torch.kernels import mla_paged_decode as mpd
    lat = ref._gather(pages, tables).float()
    t = lat.shape[1]
    c, kr = lat[..., :dl], lat[..., dl:]
    s = (torch.einsum("bhl,btl->bht", q_lat.float(), c)
         + torch.einsum("bhr,btr->bht", q_rope.float(), kr)) * scale
    mask = ref._length_mask(lengths, t)
    split_of = torch.arange(t) // mpd.decode_split_tokens(t)
    return _split_merge(s, mask, split_of,
                        lambda p: torch.einsum("bht,btl->bhl", p, c), p_bf16)


def _gqa_warp_decode(q, k_pages, v_pages, tables, lengths, p_bf16=True):
    """``ref.paged_decode_attention`` with the keys of each 64-key tile
    dealt to four warps, 16 each, as the bandwidth body does."""
    k = ref._gather(k_pages, tables).float()
    v = ref._gather(v_pages, tables).float()
    b, hq, hd = q.shape
    t, hkv = k.shape[1], k.shape[2]
    qg = q.reshape(b, hkv, hq // hkv, hd).float()
    s = torch.einsum("bhgd,bthd->bhgt", qg, k) / np.sqrt(hd)
    mask = ref._length_mask(lengths, t)[:, :, None, :]
    split_of = (torch.arange(t) % 64) // 16
    out = _split_merge(s, mask, split_of,
                       lambda p: torch.einsum("bhgt,bthd->bhgd", p, v),
                       p_bf16)
    return out.reshape(b, hq, hd)


def _tables(rng, b, pages, n):
    t = rng.permutation(n - 1)[:b * pages].reshape(b, pages) + 1
    return torch.from_numpy(t.astype(np.int32))


def _zero_rows_and_finite(out, lengths):
    assert bool(torch.isfinite(out).all())
    for r in np.flatnonzero(np.asarray(lengths) == 0):
        assert torch.equal(out[r], torch.zeros_like(out[r]))


@pytest.mark.parametrize("hq,dl,dr,page,pages,lens", [
    # window 640: splits of 256 (the last one partial), tile edges
    (4, 32, 8, 16, 40, (0, 1, 31, 32, 33, 255, 256, 257, 300, 640)),
    (40, 96, 16, 16, 20, (0, 100, 255, 256, 257, 320)),
    # DeepSeek-V3's width and window: 8 splits of 256
    (128, 512, 64, 64, 32, (0, 1, 256, 513, 700, 2048)),
    # a window of 5120: 10 splits of 512 (at most 16 splits a row)
    (8, 64, 16, 64, 80, (0, 511, 512, 513, 4097, 5120)),
])
def test_mla_decode_split_merge_within_card_tolerance(hq, dl, dr, page,
                                                      pages, lens):
    rng = np.random.default_rng(hq + dl + pages)
    b = len(lens)
    n = b * pages + 2
    tables = _tables(rng, b, pages, n)
    tables[-1, 1] = n + 3                       # clamps to page n - 1
    lengths = torch.tensor(lens, dtype=torch.int32)
    args = (_bf16(rng, (b, hq, dl)), _bf16(rng, (b, hq, dr)),
            _bf16(rng, (n, page, dl + dr)), tables, lengths)
    scale = ref.mla_scale(dl, dr)
    exact = ref.mla_paged_decode(*args, d_latent=dl).float()
    rounded = _mla_split_decode(*args, dl, scale)
    _zero_rows_and_finite(rounded, lens)
    assert float((rounded - exact).abs().max()) <= P_BF16_TOL
    # without the rounding the split walk is the plain version's algebra
    f32 = [a.float() if a.is_floating_point() else a for a in args]
    merged = _mla_split_decode(*f32, dl, scale, p_bf16=False)
    _close(merged, ref.mla_paged_decode(*f32, d_latent=dl))
    if dl == 32:
        # and the Pallas kernel's, on the rows whose table entries are in
        # the pool (the clamp is the ``xla`` fallback's semantics)
        pallas = np.asarray(jops.mla_decode(
            *[jnp.asarray(a.numpy()) for a in f32], d_latent=dl,
            backend="interpret"))[:-1]
        _close(merged[:-1], pallas)
        assert float(np.abs(rounded[:-1].numpy() - pallas).max()) \
            <= P_BF16_TOL


@pytest.mark.parametrize("hq,hkv,hd,page,pages,lens", [
    # llama3.2-1b width: tile and warp edges, a full 512-token table
    (32, 8, 64, 64, 8, (0, 1, 15, 16, 17, 63, 64, 65, 300, 512)),
    (8, 2, 64, 16, 6, (0, 1, 17, 96, 50)),
    (4, 4, 32, 32, 3, (0, 33, 96)),
    (8, 1, 128, 16, 6, (0, 70, 96)),
])
def test_paged_decode_warp_merge_within_card_tolerance(hq, hkv, hd, page,
                                                       pages, lens):
    rng = np.random.default_rng(hq + hd + page)
    b = len(lens)
    n = b * pages + 2
    tables = _tables(rng, b, pages, n)
    tables[-1, 0] = -4                          # clamps to page 0
    lengths = torch.tensor(lens, dtype=torch.int32)
    args = (_bf16(rng, (b, hq, hd)), _bf16(rng, (n, page, hkv, hd)),
            _bf16(rng, (n, page, hkv, hd)), tables, lengths)
    exact = ref.paged_decode_attention(*args).float()
    rounded = _gqa_warp_decode(*args)
    _zero_rows_and_finite(rounded, lens)
    assert float((rounded - exact).abs().max()) <= P_BF16_TOL
    f32 = [a.float() if a.is_floating_point() else a for a in args]
    merged = _gqa_warp_decode(*f32, p_bf16=False)
    _close(merged, ref.paged_decode_attention(*f32))
    if hd == 64 and page == 64:
        # and the Pallas kernel's, on the rows whose table entries are in
        # the pool (the clamp is the ``xla`` fallback's semantics)
        pallas = np.asarray(jops.paged_decode(
            *[jnp.asarray(a.numpy()) for a in f32],
            backend="interpret"))[:-1]
        _close(merged[:-1], pallas)
        assert float(np.abs(rounded[:-1].numpy() - pallas).max()) \
            <= P_BF16_TOL


# On the card, int8 decode with a bf16 query runs the bf16 GQA decode's
# walk on its int8 tiles widened to bf16 (exact for -127..127): the K
# scale multiplies each float32 score, the V scale multiplies P after the
# online-softmax update (l keeps the unscaled sum) and before P is
# rounded to bf16 for P V, and each tile's keys are dealt to four warps,
# 16 each, merged in warp order.
def _gqa_warp_decode_int8(q, k_pages, v_pages, k_scales, v_scales, tables,
                          lengths, p_bf16=True):
    """``ref.paged_decode_attention_int8`` computed as the int8 body
    computes it."""
    k = ref._gather(k_pages, tables).float()
    v = ref._gather(v_pages, tables).float()
    b, hq, hd = q.shape
    t, hkv = k.shape[1], k.shape[2]

    def per_key(scales):                        # [B,T,Hkv,1] -> [B,Hkv,1,T]
        return ref._gather(scales, tables).float()[..., 0].permute(
            0, 2, 1)[:, :, None, :]
    ks, vs = per_key(k_scales), per_key(v_scales)
    qg = q.reshape(b, hkv, hq // hkv, hd).float()
    s = torch.einsum("bhgd,bthd->bhgt", qg, k) * ks / np.sqrt(hd)
    mask = ref._length_mask(lengths, t)[:, :, None, :]
    split_of = (torch.arange(t) % 64) // 16

    def pv(p):
        p = p * vs
        if p_bf16:
            p = p.bfloat16().float()
        return torch.einsum("bhgt,bthd->bhgd", p, v)
    out = _split_merge(s, mask, split_of, pv, p_bf16=False)
    return out.reshape(b, hq, hd)


@pytest.mark.parametrize("hq,hkv,hd,page,pages,lens", [
    # llama3.2-1b attention geometry: tile and warp edges, a full table
    (32, 8, 64, 64, 8, (0, 1, 15, 16, 17, 63, 64, 65, 127, 128, 129, 300,
                        512)),
    (8, 2, 64, 16, 6, (0, 1, 17, 96, 50)),      # GQA
    (8, 2, 32, 32, 4, (0, 31, 64, 128)),
    (4, 4, 32, 32, 3, (0, 33, 96)),             # MHA
    (4, 4, 128, 16, 6, (0, 16, 96)),
    (8, 1, 128, 16, 6, (0, 70, 96)),            # MQA
    (8, 1, 32, 32, 4, (0, 5, 128)),
])
def test_paged_decode_int8_warp_merge_within_card_tolerance(hq, hkv, hd, page,
                                                            pages, lens):
    rng = np.random.default_rng(hq + hd + page + 1)
    b = len(lens)
    n = b * pages + 2
    kq, ks = _int8_pool(rng, n, page, hkv, hd)
    vq, vs = _int8_pool(rng, n, page, hkv, hd)
    tables = _tables(rng, b, pages, n)
    tables[-1, 0] = -4                          # clamps to page 0
    lengths = torch.tensor(lens, dtype=torch.int32)
    pool = (torch.from_numpy(kq), torch.from_numpy(vq),
            torch.from_numpy(ks).bfloat16(), torch.from_numpy(vs).bfloat16())
    q = _bf16(rng, (b, hq, hd))
    exact = ref.paged_decode_attention_int8(q, *pool, tables,
                                            lengths).float()
    rounded = _gqa_warp_decode_int8(q, *pool, tables, lengths)
    _zero_rows_and_finite(rounded, lens)
    assert float((rounded - exact).abs().max()) <= P_BF16_TOL
    # without the rounding the int8 walk is the plain version's algebra,
    # the Pallas kernel's and the JAX oracle's, on the rows whose table
    # entries are in the pool (the clamp is the ``xla`` fallback's
    # semantics; the oracle has no zero-length gate)
    merged = _gqa_warp_decode_int8(q.float(), *pool, tables, lengths,
                                   p_bf16=False)
    _close(merged, ref.paged_decode_attention_int8(q.float(), *pool, tables,
                                                   lengths))
    jargs = [jnp.asarray(q.float().numpy()), jnp.asarray(kq),
             jnp.asarray(vq), jnp.asarray(ks, jnp.bfloat16),
             jnp.asarray(vs, jnp.bfloat16), jnp.asarray(tables.numpy()),
             jnp.asarray(lengths.numpy())]
    pallas = np.asarray(jops.paged_decode_int8(*jargs,
                                               backend="interpret"))[:-1]
    _close(merged[:-1], pallas)
    assert float(np.abs(rounded[:-1].numpy() - pallas).max()) <= P_BF16_TOL
    live = [r for r in range(b - 1) if lens[r] > 0]
    _close(merged[live],
           np.asarray(jref.paged_decode_attention_int8_ref(*jargs))[live])


# ---------------------------------------------------------------------------
# the bf16 GQA chunk prefill's key walk: four warps, merged in order
# ---------------------------------------------------------------------------
# On the card, bf16 chunk and segment prefill walk the pool window in
# 64-key tiles and then the chunk's own keys in 64-key tiles, and deal
# the keys of every tile to four warps, 16 each, as the bf16 GQA decode
# does.  Each warp keeps its own float32 (m, l, acc) with P rounded to
# bf16 for P V, and the four are merged in warp order.  These tests
# compute the plain versions that way and hold them to the unchanged
# plain versions and to the JAX package's oracles.
def _prefill_warp_walk(q, k_chunk, v_chunk, k_pages, v_pages, tables, prior,
                       p_bf16=True):
    """``ref._chunk_attend`` over ``prior`` with the pool window's keys
    and the chunk's keys each cut into 64-key tiles dealt to four warps,
    as the tensor-core body walks them."""
    k = torch.cat([ref._gather(k_pages, tables).float(), k_chunk.float()], 1)
    v = torch.cat([ref._gather(v_pages, tables).float(), v_chunk.float()], 1)
    b, c, hq, hd = q.shape
    hkv, t = k.shape[2], prior.shape[2]
    qg = q.reshape(b, c, hkv, hq // hkv, hd).float()
    s = torch.einsum("bchgd,bthd->bchgt", qg, k) / np.sqrt(hd)
    mask = ref._with_chunk(prior)[:, :, None, None, :]
    split_of = torch.cat([torch.arange(t) % 64 // 16,
                          torch.arange(c) % 64 // 16])
    out = _split_merge(s, mask, split_of,
                       lambda p: torch.einsum("bchgt,bthd->bchgd", p, v),
                       p_bf16)
    return out.reshape(b, c, hq, hd)


# (C, Hq, Hkv, hd, page, pages, offsets, or rows of chunk positions):
# GQA / MHA / MQA at 16- and 64-token pages, offsets at 0 and at page and
# tile edges; gap chunks around resumed islands, a contiguous row and a
# row of padding only; then llama3.2-1b's attention geometry (the model's
# depth is not involved) at the window's middle and last chunks and with
# the serve phase's gap chunk
PREFILL_WALK_CASES = [
    (16, 8, 2, 64, 16, 6, (0, 40, 80)),
    (16, 4, 4, 32, 64, 3, (5, 64, 150)),
    (16, 8, 1, 128, 16, 6, (0, 63, 96)),
    (16, 8, 2, 64, 16, 6, ([3, 4, 5, 6, 40, 41, 42, 43], list(range(16)),
                           [])),
    (16, 8, 1, 16, 64, 3, ([10, 11, 12] + list(range(100, 111)), [90, 91],
                           [])),
    (64, 32, 8, 64, 64, 8, (320, 448)),
    (64, 32, 8, 64, 64, 8, (list(range(64, 96)) + list(range(256, 280)),
                            list(range(448, 512)))),
]


@pytest.mark.parametrize("c,hq,hkv,hd,page,pages,where", PREFILL_WALK_CASES)
def test_prefill_warp_walk_within_card_tolerance(c, hq, hkv, hd, page, pages,
                                                 where):
    seg = isinstance(where[0], list)
    rng = np.random.default_rng(c + hq + hd + page)
    b = len(where)
    n = b * pages + 2
    args = (_bf16(rng, (b, c, hq, hd)), _bf16(rng, (b, c, hkv, hd)),
            _bf16(rng, (b, c, hkv, hd)), _bf16(rng, (n, page, hkv, hd)),
            _bf16(rng, (n, page, hkv, hd)), _tables(rng, b, pages, n))
    t = pages * page
    if seg:
        w = torch.from_numpy(_cpos(where, c))
        plain, oracle = ref.paged_prefill_segments, \
            jref.paged_prefill_segments_ref
        prior = ref._segment_prior(w, t)
    else:
        w = torch.tensor(where, dtype=torch.int32)
        plain, oracle = ref.paged_prefill_attention, \
            jref.paged_prefill_attention_ref
        prior = ref._offset_prior(w, c, t)
    exact = plain(*args, w).float()
    rounded = _prefill_warp_walk(*args, prior)
    assert bool(torch.isfinite(rounded).all())
    assert float((rounded - exact).abs().max()) <= P_BF16_TOL
    # without the rounding the warp walk is the plain version's algebra,
    # and the JAX package's oracle on the same values
    f32 = [a.float() for a in args[:5]] + [args[5]]
    merged = _prefill_warp_walk(*f32, prior, p_bf16=False)
    _close(merged, plain(*f32, w))
    jout = np.asarray(oracle(*[jnp.asarray(a.numpy()) for a in f32],
                             jnp.asarray(w.numpy())))
    _close(merged, jout)
    assert float(np.abs(rounded.numpy() - jout).max()) <= P_BF16_TOL
