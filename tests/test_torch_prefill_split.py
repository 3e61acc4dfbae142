"""The `wgmma` chunk / segment prefill body's split plan
(``repro_torch.kernels.paged_prefill.prefill_split_plan``) and its walk,
on the CPU.

The plan is made on the host from ints alone (B, C, Hq, Hkv, hd, page
and the table window): it must cover every pool key of the window and
every chunk key exactly once, and fill the H100 at the serving shape.
The walk is emulated in PyTorch as the body computes it -- each split's
keys in 64-key tiles with an online softmax in log2 units, P rounded to
bf16 for P V, the splits' partials merged in split order -- and held to
the plain versions (``ref.paged_prefill_attention`` /
``ref.paged_prefill_segments``), to the JAX package's oracles and to
its Pallas kernels in interpret mode, at ``PREFILL_WALK_CASES``' shapes
and bounds: within P_BF16_TOL with P rounded, to float32 (1e-4) without.
"""
import itertools
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import paged_prefill as pp  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from test_torch_kernels import (P_BF16_TOL, PREFILL_WALK_CASES,  # noqa: E402
                                _bf16, _close, _cpos, _tables)

LOG2E = 1.4426950408889634
GS = (1, 3, 4, 8, 16)


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("page", [16, 32, 64])
@pytest.mark.parametrize("window", [64, 192, 512, 2048, 4096])
@pytest.mark.parametrize("c", [1, 17, 63, 64])
def test_plan_covers_every_key_once(page, window, c):
    """Every pool position of the window and every chunk key lies in
    exactly one split, for G 1 / 3 / 4 / 8 / 16, one or eight KV heads
    and one or four rows; a block's rows are whole queries of G heads
    and the query blocks cover the chunk."""
    for g, hkv, b in itertools.product(GS, (1, 8), (1, 4)):
        plan = pp.prefill_split_plan(b, c, g * hkv, hkv, 64, page,
                                     window // page)
        pool, chunk = np.zeros(window, int), np.zeros(c, int)
        for split in range(plan.splits):
            kind, lo, hi = plan.split_keys(split)
            assert lo < hi
            (pool if kind == "pool" else chunk)[lo:hi] += 1
        assert (pool == 1).all() and (chunk == 1).all()
        assert plan.pool_splits * plan.tiles * pp.KEY_TILE >= window
        assert plan.tiles >= pp.MIN_SPLIT_TILES
        assert plan.splits <= pp.MAX_SPLITS
        assert plan.queries * g <= pp.QUERY_ROWS < (plan.queries + 1) * g
        assert (plan.query_blocks - 1) * plan.queries < c \
            <= plan.query_blocks * plan.queries
        assert plan.groups == b * hkv * plan.query_blocks
        assert plan.blocks == plan.groups * plan.splits


def test_plan_fills_the_card_at_the_serve_shape():
    """llama3.2-1b's serve call (one row, C 64, Hq 32 over Hkv 8, hd 64,
    a 512-token window at 64- or 32-token pages): at least 132 blocks,
    each split two 64-key tiles, both in flight in the ring; the blocks
    that walk keys at the kernels phase's offsets."""
    for page in (64, 32):
        plan = pp.prefill_split_plan(1, 64, 32, 8, 64, page, 512 // page)
        assert plan.blocks >= 132
        assert (plan.tiles, plan.pool_splits, plan.chunk_splits) == (2, 4, 1)
        assert plan.partial_bytes == 160 * 64 * 66 * 4

        def live(end):
            return sum(plan.live_splits(end, qb)
                       for qb in range(plan.query_blocks)) * 8
        assert [live(e) for e in (0, 64, 320, 336, 448)] == \
            [32, 64, 128, 128, 160]
    # granite-moe's G = 3: 21 queries a block, 4 blocks for 64 queries
    plan = pp.prefill_split_plan(1, 64, 24, 8, 64, 64, 8)
    assert (plan.queries, plan.query_blocks, plan.blocks) == (21, 4, 160)


def test_plan_takes_ints_only():
    """The plan reads no tensor: a tensor argument is refused, and the
    same ints give the same plan."""
    ints = (1, 64, 32, 8, 64, 64, 8)
    assert pp.prefill_split_plan(*ints) == pp.prefill_split_plan(*ints)
    for i in range(len(ints)):
        bad = list(ints)
        bad[i] = torch.tensor(ints[i])
        with pytest.raises(TypeError, match="ints"):
            pp.prefill_split_plan(*bad)


def test_plan_live_splits_follow_the_row_end():
    """A pool split is live when it starts below the row's end, a chunk
    split when it starts at or below the block's last query."""
    plan = pp.prefill_split_plan(1, 80, 16, 1, 64, 16, 12)
    assert (plan.queries, plan.query_blocks) == (4, 20)
    span = plan.tiles * pp.KEY_TILE
    for end in (0, 1, span, span + 1, 192, 500):
        for qb in (0, 10, 19):
            n_keys = min(80, (qb + 1) * 4)
            want = sum(1 for s in range(plan.splits)
                       if (lambda k: k[1] < (min(end, 192) if k[0] == "pool"
                                             else n_keys))(
                           plan.split_keys(s)))
            assert plan.live_splits(end, qb) == want


# ---------------------------------------------------------------------------
# the walk
# ---------------------------------------------------------------------------
def _wg_walk(q, k_chunk, v_chunk, k_pages, v_pages, tables, prior, plan,
             p_bf16=True):
    """``ref._chunk_attend`` over ``prior`` computed as the `wgmma` body
    computes it: each split's keys in 64-key tiles with an online
    softmax (scores in log2 units, P against the running max, rounded to
    bf16 for P V when ``p_bf16``), the splits' (m, l, acc) merged in
    split order.  A split with no key for a row leaves m = -inf, l = 0,
    acc = 0 there, which the merge weighs 0, as a split that is not
    walked at all; a block with one live split divides by its l as the
    merge does with weight 1."""
    k = torch.cat([ref._gather(k_pages, tables).float(), k_chunk.float()], 1)
    v = torch.cat([ref._gather(v_pages, tables).float(), v_chunk.float()], 1)
    b, c, hq, hd = q.shape
    hkv, t = k.shape[2], prior.shape[2]
    qg = q.reshape(b, c, hkv, hq // hkv, hd).float()
    s = torch.einsum("bchgd,bthd->bchgt", qg, k) / math.sqrt(hd) * LOG2E
    mask = ref._with_chunk(prior)[:, :, None, None, :]
    neg = float("-inf")
    parts = []
    for split in range(plan.splits):
        kind, lo, hi = plan.split_keys(split)
        first = 0 if kind == "pool" else t
        m = torch.full(s.shape[:-1] + (1,), neg)
        l = torch.zeros_like(m)
        acc = torch.zeros(s.shape[:-1] + (hd,))
        for k0 in range(lo, hi, pp.KEY_TILE):
            sel = slice(first + k0, first + min(k0 + pp.KEY_TILE, hi))
            x = s[..., sel].masked_fill(~mask[..., sel], neg)
            mx = torch.maximum(m, x.amax(-1, keepdim=True))
            base = torch.where(mx == neg, torch.zeros_like(mx), mx)
            alpha = torch.exp2(m - base)
            p = torch.exp2(x - base)
            pv = p.bfloat16().float() if p_bf16 else p
            l = l * alpha + p.sum(-1, keepdim=True)
            acc = acc * alpha + torch.einsum("bchgt,bthd->bchgd", pv,
                                             v[:, sel])
            m = mx
        parts.append((m, l, acc))
    mx = torch.stack([m for m, _, _ in parts]).amax(0)
    base = torch.where(mx == neg, torch.zeros_like(mx), mx)
    den, out = 0.0, 0.0
    for m, l, acc in parts:                     # in split order
        w = torch.exp2(m - base)
        den, out = den + w * l, out + w * acc
    return (out / den.clamp_min(1e-30)).reshape(b, c, hq, hd)


def _plans(b, c, hq, hkv, hd, page, pages):
    """The default plan and the one of the shortest splits that a
    cluster holds (at most MAX_SPLITS)."""
    plan = pp.prefill_split_plan(b, c, hq, hkv, hd, page, pages)
    for tiles in range(1, plan.tiles + 1):
        span = tiles * pp.KEY_TILE
        short = plan._replace(tiles=tiles,
                              pool_splits=-(-pages * page // span),
                              chunk_splits=-(-c // span))
        if short.splits <= pp.MAX_SPLITS:
            return {"default": plan, "shortest": short}


@pytest.mark.parametrize("which", ["default", "shortest"])
@pytest.mark.parametrize("c,hq,hkv,hd,page,pages,where", PREFILL_WALK_CASES)
def test_wg_walk_within_card_tolerance(c, hq, hkv, hd, page, pages, where,
                                       which):
    seg = isinstance(where[0], list)
    rng = np.random.default_rng(c + hq + hd + page + 29)
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
        pallas = jops.paged_prefill_seg
        prior = ref._segment_prior(w, t)
    else:
        w = torch.tensor(where, dtype=torch.int32)
        plain, oracle = ref.paged_prefill_attention, \
            jref.paged_prefill_attention_ref
        pallas = jops.paged_prefill
        prior = ref._offset_prior(w, c, t)
    plan = _plans(b, c, hq, hkv, hd, page, pages)[which]
    assert plan.splits <= pp.MAX_SPLITS
    exact = plain(*args, w).float()
    rounded = _wg_walk(*args, prior, plan)
    assert bool(torch.isfinite(rounded).all())
    assert float((rounded - exact).abs().max()) <= P_BF16_TOL
    # without the rounding the split walk is the plain version's algebra,
    # the JAX package's oracle's and (every table entry lies in the
    # pool) its Pallas kernel's in interpret mode, on the same values
    f32 = [a.float() for a in args[:5]] + [args[5]]
    merged = _wg_walk(*f32, prior, plan, p_bf16=False)
    _close(merged, plain(*f32, w))
    jargs = [jnp.asarray(a.numpy()) for a in f32] + [jnp.asarray(w.numpy())]
    jout = np.asarray(oracle(*jargs))
    _close(merged, jout)
    assert float(np.abs(rounded.numpy() - jout).max()) <= P_BF16_TOL
    if c <= 16:
        _close(merged, np.asarray(pallas(*jargs, backend="interpret")))
