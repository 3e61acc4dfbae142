"""The Hopper decode bodies' split plans and walks, on the CPU.

Kernel 1 (GQA paged decode, ``paged_decode_wg``): the plan
``repro_torch.kernels.paged_attention.decode_split_plan`` cuts each (row,
KV head)'s walk over the table window into splits of whole 64-key tiles
from ints alone (B, Hq, Hkv, hd, page and the window); it must cover
every key of the window exactly once within one portable cluster.  The
walk is emulated in PyTorch as the body computes it: each split's tiles
of 64 keys, each tile's keys dealt to four warps of 16, each warp with
its own online softmax in log2 units and P rounded to bf16 for P V; the
warps merged in warp order into the block's partial, the splits'
partials merged in split order, and the log-sum-exp from the merge.

Kernel 8 (int8 paged decode, ``paged_decode_wg<HD, true>``): kernel 1's
walk over int8 pages, each key's K scale on its score and its V scale on
P before the rounding.

Kernel 4 (absorbed-MLA decode, ``mla_decode_wg``): the host's split of
``decode_split_tokens(window)`` tokens, each split walked over 64-token
page tiles with an online softmax in log2 units and P rounded to bf16; a
row of one split normalises itself, a longer row's float32 partials (m
kept finite) are merged in split order by the combine.

Each emulation is held to the plain versions (``ref.paged_decode_attention``,
``ref.paged_decode_lse``, ``ref.mla_paged_decode``) within P_BF16_TOL with
P rounded and to float32 (1e-4) without, and, without the rounding, to
the JAX package's oracles and its Pallas kernels in interpret mode: rows
of length 0, rows ending on a tile or split edge, full tables and
clamped table entries.
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
from repro_torch.kernels import mla_paged_decode as mpd  # noqa: E402
from repro_torch.kernels import paged_attention as pa  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from test_torch_kernels import P_BF16_TOL, _bf16, _close, _tables  # noqa: E402

LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453
NEG = float("-inf")
# float32 log-sum-exps of the same scores summed in another order
LSE_TOL = 1e-4


# ---------------------------------------------------------------------------
# the plans
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("page", [16, 32, 64])
@pytest.mark.parametrize("pages", [1, 3, 8, 16, 33, 64, 512])
def test_gqa_plan_covers_every_key_once(page, pages):
    """Every position of the window lies in exactly one split, for G 1 /
    3 / 4 / 16, one or eight KV heads and one or 64 rows; splits are whole
    64-key tiles, at most MAX_SPLITS (one portable cluster), as many as
    keep the grid within SPLIT_BLOCKS blocks, the fewest tiles a split
    that allow it."""
    window = pages * page
    n_tiles = -(-window // pa.KEY_TILE)
    for g, hkv, b, hd in itertools.product((1, 3, 4, 16), (1, 8), (1, 64),
                                           (64, 128)):
        plan = pa.decode_split_plan(b, g * hkv, hkv, hd, page, pages)
        seen = np.zeros(window, int)
        for split in range(plan.splits):
            lo, hi = plan.split_keys(split)
            assert lo < hi and lo % pa.KEY_TILE == 0
            seen[lo:hi] += 1
        assert (seen == 1).all()
        assert 1 <= plan.splits <= pa.MAX_SPLITS
        assert plan.splits == 1 or plan.blocks <= pa.SPLIT_BLOCKS
        want = min(pa.MAX_SPLITS, max(1, pa.SPLIT_BLOCKS // (b * hkv)))
        assert plan.tiles == 1 or -(-n_tiles // (plan.tiles - 1)) > want
        assert plan.groups == b * hkv and plan.g == g
        assert plan.blocks == plan.groups * plan.splits
        assert plan.partial_bytes == plan.blocks * g * (hd + 2) * 4


def test_gqa_plan_at_the_paths_shapes():
    """The serve shape (64 rows, 32 / 8 heads, a 512-token window: 512
    blocks already fill the card) walks each (row, KV head) in one block;
    granite-moe's 32 rows and zamba2's 4 slots of 1024 tokens at G 1 (128
    blocks) too; whisper-tiny's 8 slots of 448 tokens at 6 / 6 heads in 2
    splits of 4 tiles; the VLM's 4 rows of 1024 tokens at hd 128 in 4
    splits of 4 tiles, 32 x 4 blocks; the dry run's decode (32 rows of
    32768 tokens) in one block a (row, KV head)."""
    plan = pa.decode_split_plan(64, 32, 8, 64, 64, 8)
    assert (plan.tiles, plan.splits, plan.blocks) == (8, 1, 512)
    assert pa.decode_split_plan(64, 32, 8, 64, 32, 16) == plan
    g3 = pa.decode_split_plan(32, 24, 8, 64, 64, 8)
    assert (g3.tiles, g3.splits) == (8, 1)
    zamba = pa.decode_split_plan(4, 32, 32, 64, 64, 16)
    assert (zamba.tiles, zamba.splits, zamba.blocks) == (16, 1, 128)
    whisper = pa.decode_split_plan(8, 6, 6, 64, 64, 7)
    assert (whisper.tiles, whisper.splits, whisper.blocks) == (4, 2, 96)
    vlm = pa.decode_split_plan(4, 32, 8, 128, 64, 16)
    assert (vlm.tiles, vlm.splits, vlm.blocks) == (4, 4, 128)
    dry = pa.decode_split_plan(32, 32, 8, 64, 64, 512)
    assert (dry.tiles, dry.splits) == (512, 1)


def test_gqa_plan_live_splits_follow_the_length():
    """A split is live when it starts below the row's length; split 0
    always is (it writes zeros for a row of length 0)."""
    plan = pa.decode_split_plan(1, 8, 2, 64, 16, 12)     # 192 tokens
    span = plan.tiles * pa.KEY_TILE
    for length in (0, 1, span - 1, span, span + 1, 191, 192, 500):
        want = max(1, sum(plan.split_keys(s)[0] < min(length, 192)
                          for s in range(plan.splits)))
        assert plan.live_splits(length) == want


def test_plans_take_ints_only():
    """Neither plan reads a tensor: a tensor argument is refused, and the
    same ints give the same plan."""
    ints = (64, 32, 8, 64, 64, 8)
    assert pa.decode_split_plan(*ints) == pa.decode_split_plan(*ints)
    for i in range(len(ints)):
        bad = list(ints)
        bad[i] = torch.tensor(ints[i])
        with pytest.raises(TypeError, match="ints"):
            pa.decode_split_plan(*bad)
    assert mpd.decode_split_tokens(2048) == mpd.decode_split_tokens(2048)


@pytest.mark.parametrize("window", [64, 640, 2048, 4096, 5120, 32768])
def test_mla_plan_covers_every_key_once(window):
    """The MLA decode's splits are whole 64-token pages (the `wgmma`
    body's tile), cover the window once, at most MAX_SPLITS of them."""
    split = mpd.decode_split_tokens(window)
    n = mpd.decode_splits(window)
    assert split % 64 == 0 and 1 <= n <= mpd.MAX_SPLITS
    seen = np.zeros(window, int)
    for s in range(n):
        seen[s * split:min((s + 1) * split, window)] += 1
    assert (seen == 1).all()


# ---------------------------------------------------------------------------
# kernel 1's walk
# ---------------------------------------------------------------------------
def _online(x, v, lo, hi, tile, p_bf16, own=None, p_scale=None):
    """Online softmax over keys [lo, hi) of log2-unit scores ``x`` [...,
    T] (masked keys -inf) in tiles of ``tile`` keys, the keys of each
    tile restricted to ``own(k0)`` (a slice of the tile) when given: the
    (m, l, acc) of one warp or one block.  ``v(p, sel)``: p [..., n] times
    the values of keys ``sel`` -> [..., dv].  ``p_scale(sel)`` multiplies
    p after the update of l and before the rounding (the int8 values'
    scales)."""
    m = torch.full(x.shape[:-1] + (1,), NEG)
    l = torch.zeros_like(m)
    acc = 0.0
    for k0 in range(lo, hi, tile):
        sel = own(k0) if own is not None else slice(k0, min(k0 + tile, hi))
        if sel.start >= sel.stop:
            continue                            # a warp past the window
        xs = x[..., sel]
        mx = torch.maximum(m, xs.amax(-1, keepdim=True))
        base = torch.where(mx == NEG, torch.zeros_like(mx), mx)
        alpha = torch.exp2(m - base)
        p = torch.exp2(xs - base)
        l = l * alpha + p.sum(-1, keepdim=True)
        if p_scale is not None:
            p = p * p_scale(sel)
        acc = acc * alpha + v(p.bfloat16().float() if p_bf16 else p, sel)
        m = mx
    return m, l, acc


def _merge(parts):
    """(m, l, acc) parts merged in order: w = 2^(m - max m), den = sum w
    l, acc = sum w acc -> (max m, den, acc)."""
    mx = torch.stack([m for m, _, _ in parts]).amax(0)
    base = torch.where(mx == NEG, torch.zeros_like(mx), mx)
    den, acc = 0.0, 0.0
    for m, l, a in parts:
        w = torch.exp2(m - base)
        den, acc = den + w * l, acc + w * a
    return mx, den, acc


def _gqa_wg_walk(q, k_pages, v_pages, tables, lengths, plan, p_bf16=True,
                 scales=None):
    """``ref.paged_decode_attention`` and ``ref.paged_decode_lse`` as the
    Hopper body computes them under ``plan``: (out [B,Hq,hd], lse [B,Hq]).
    With ``scales`` (int8 pages' K and V scales [N,page,Hkv,1]) the int8
    Hopper body's ``ref.paged_decode_attention_int8``: the int8 values
    widened exactly, each key's K scale on its float32 score before the
    mask, its V scale on P after the online-softmax update (l keeps the
    unscaled sum, so the lse too) and before the rounding."""
    k = ref._gather(k_pages, tables).float()
    v = ref._gather(v_pages, tables).float()
    b, hq, hd = q.shape
    t, hkv = k.shape[1], k.shape[2]
    qg = q.reshape(b, hkv, hq // hkv, hd).float()
    s = torch.einsum("bhgd,bthd->bhgt", qg, k)
    p_scale = None
    if scales is not None:
        # [B, Hkv, 1, T]: one scale a (key, KV head), broadcast over G
        ks, vs = (ref._gather(x, tables).float()[..., 0].transpose(1, 2)
                  [:, :, None] for x in scales)
        s = s * ks
        p_scale = lambda sel: vs[..., sel]  # noqa: E731
    s = s / math.sqrt(hd) * LOG2E
    mask = ref._length_mask(lengths, t)[:, :, None, :]
    x = s.masked_fill(~mask, NEG)

    def pv(p, sel):
        return torch.einsum("bhgt,bthd->bhgd", p, v[:, sel])
    blocks = []
    for split in range(plan.splits):
        lo, hi = plan.split_keys(split)
        warps = [_online(x, pv, lo, hi, pa.KEY_TILE, p_bf16,
                         own=lambda k0, w=w: slice(k0 + 16 * w,
                                                   min(k0 + 16 * w + 16, hi)),
                         p_scale=p_scale)
                 for w in range(4)]
        blocks.append(_merge(warps))           # the block's partial
    mx, den, acc = _merge(blocks)              # the cluster's, split order
    out = (acc / den.clamp_min(1e-30)).reshape(b, hq, hd)
    lse = torch.where(mx == NEG, torch.full_like(mx, -1e30),
                      (mx + torch.log2(den)) * LN2)
    return out, lse.reshape(b, hq)


# (Hq, Hkv, hd, page, pages, lengths): llama3.2-1b's heads over a
# 512-token window at 64-, 32- and 16-token pages (tile, warp and split
# edges, a full table), granite-moe's G 3, the VLM's hd 128, G 1, G 16 and
# a window that is not a whole number of tiles
GQA_WALK_CASES = [
    (32, 8, 64, 64, 8, (0, 1, 15, 16, 17, 63, 64, 65, 300, 511, 512)),
    (32, 8, 64, 32, 16, (0, 31, 64, 129, 512)),
    (8, 2, 64, 16, 12, (0, 1, 64, 65, 128, 191, 192)),
    (24, 8, 64, 64, 8, (0, 5, 320, 512)),
    (8, 2, 128, 64, 16, (0, 127, 128, 129, 700, 1024)),
    (4, 4, 64, 64, 7, (0, 63, 64, 448)),
    (16, 1, 64, 16, 5, (0, 16, 64, 79, 80)),
]


def _gqa_inputs(hq, hkv, hd, page, pages, lens, seed):
    rng = np.random.default_rng(seed)
    b = len(lens)
    n = b * pages + 2
    tables = _tables(rng, b, pages, n)
    tables[-1, 0] = -4                          # clamps to page 0
    return (_bf16(rng, (b, hq, hd)), _bf16(rng, (n, page, hkv, hd)),
            _bf16(rng, (n, page, hkv, hd)), tables,
            torch.tensor(lens, dtype=torch.int32))


def _gqa_plans(b, hq, hkv, hd, page, pages):
    """The default plan and plans of 2 and 4 tiles a split (those of at
    most MAX_SPLITS splits)."""
    plan = pa.decode_split_plan(b, hq, hkv, hd, page, pages)
    n_tiles = -(-pages * page // pa.KEY_TILE)
    out = {"default": plan}
    for tiles in (2, 4):
        other = plan._replace(tiles=tiles, splits=-(-n_tiles // tiles))
        if other.splits <= pa.MAX_SPLITS:
            out[f"tiles_{tiles}"] = other
    return out


@pytest.mark.parametrize("hq,hkv,hd,page,pages,lens", GQA_WALK_CASES)
def test_gqa_wg_walk_within_card_tolerance(hq, hkv, hd, page, pages, lens):
    args = _gqa_inputs(hq, hkv, hd, page, pages, lens, hq + hd + page + 30)
    lengths = args[-1]
    exact = ref.paged_decode_attention(*args).float()
    exact_lse = ref.paged_decode_lse(args[0], args[1], args[3], lengths)
    f32 = [a.float() if a.is_floating_point() else a for a in args]
    plain32 = ref.paged_decode_attention(*f32)
    for name, plan in _gqa_plans(len(lens), hq, hkv, hd, page,
                                 pages).items():
        rounded, lse = _gqa_wg_walk(*args, plan)
        assert bool(torch.isfinite(rounded).all()), name
        for r in np.flatnonzero(np.asarray(lens) == 0):
            assert torch.equal(rounded[r], torch.zeros_like(rounded[r]))
            assert bool((lse[r] == -1e30).all())
        assert float((rounded - exact).abs().max()) <= P_BF16_TOL, name
        live = lengths > 0
        assert float((lse - exact_lse)[live].abs().max()) <= LSE_TOL, name
        # without the rounding the split walk is the plain version's
        # algebra
        merged, lse32 = _gqa_wg_walk(*f32, plan, p_bf16=False)
        _close(merged, plain32)
        _close(lse32[live], ref.paged_decode_lse(f32[0], f32[1], f32[3],
                                                 lengths)[live])


@pytest.mark.parametrize("hq,hkv,hd,page,pages,lens",
                         [GQA_WALK_CASES[i] for i in (0, 2, 5, 6)])
def test_gqa_wg_walk_against_jax(hq, hkv, hd, page, pages, lens):
    """Without the rounding the walk equals the JAX package's oracle on
    the live rows and its Pallas kernel in interpret mode on the rows
    whose table entries lie in the pool (the clamp is the ``xla``
    fallback's semantics; the oracle has no zero-length gate); with it,
    within P_BF16_TOL of the Pallas kernel."""
    args = _gqa_inputs(hq, hkv, hd, page, pages, lens, hq + hd + page + 31)
    f32 = [a.float() if a.is_floating_point() else a for a in args]
    plan = pa.decode_split_plan(len(lens), hq, hkv, hd, page, pages)
    merged, _ = _gqa_wg_walk(*f32, plan, p_bf16=False)
    rounded, _ = _gqa_wg_walk(*args, plan)
    jargs = [jnp.asarray(a.numpy()) for a in f32]
    live = [r for r in range(len(lens) - 1) if lens[r] > 0]
    _close(merged[live],
           np.asarray(jref.paged_decode_attention_ref(*jargs))[live])
    pallas = np.asarray(jops.paged_decode(*jargs, backend="interpret"))
    _close(merged[:-1], pallas[:-1])
    assert float(np.abs(rounded[:-1].numpy() - pallas[:-1]).max()) \
        <= P_BF16_TOL


# ---------------------------------------------------------------------------
# kernel 8's walk: kernel 1's block over int8 pages
# ---------------------------------------------------------------------------
# (Hq, Hkv, hd, page, pages, lengths): the int8_decode path's 4 rows
# (a 512-token window of 64-token slot pages: 4 splits of 2 tiles), rows
# at the 16-key chunk, 64-key tile and split edges at G 4 over 16-token
# pages, G 16 at hd 128 over 32-token pages, G 1 at hd 128
INT8_EDGES = (0, 1, 16, 17, 64, 65, 128, 129, 512)
INT8_WALK_CASES = [
    (32, 8, 64, 64, 8, (392, 264, 456, 108)),
    (32, 8, 64, 64, 8, INT8_EDGES),
    (8, 2, 64, 16, 32, INT8_EDGES),
    (16, 1, 128, 32, 16, (0, 17, 65, 129, 300, 512)),
    (4, 4, 128, 64, 8, (0, 1, 64, 65, 511, 512)),
]


def _int8_inputs(hq, hkv, hd, page, pages, lens, seed):
    """bf16 q, int8 pools with bf16 scales from the port's quantizer, and
    tables with a clamped entry inside the last row's length."""
    from repro_torch.models.attention import quantize_kv
    rng = np.random.default_rng(seed)
    b = len(lens)
    n = b * pages + 2
    tables = _tables(rng, b, pages, n)
    tables[-1, 0] = -4                          # clamps to page 0
    (kq, ks), (vq, vs) = (quantize_kv(torch.from_numpy(
        rng.standard_normal((n, page, hkv, hd)).astype(np.float32)))
        for _ in range(2))
    return (_bf16(rng, (b, hq, hd)), kq, vq, ks, vs, tables,
            torch.tensor(lens, dtype=torch.int32))


def _int8_walk(args, plan, p_bf16=True):
    q, kq, vq, ks, vs, tables, lengths = args
    return _gqa_wg_walk(q, kq, vq, tables, lengths, plan, p_bf16=p_bf16,
                        scales=(ks, vs))


@pytest.mark.parametrize("hq,hkv,hd,page,pages,lens", INT8_WALK_CASES)
def test_int8_wg_walk_within_card_tolerance(hq, hkv, hd, page, pages, lens):
    """The int8 Hopper body's walk (kernel 1's plans, 16-key warps, K
    scale on the scores, V scale on P before the bf16 rounding, warps then
    splits merged in order) against ``ref.paged_decode_attention_int8``
    and ``ref.paged_decode_lse`` within P_BF16_TOL, zeros and -1e30 for a
    row of length 0; without the rounding, the plain version's algebra
    within 1e-4."""
    args = _int8_inputs(hq, hkv, hd, page, pages, lens, hq + hd + page + 40)
    q, kq, vq, ks, vs, tables, lengths = args
    exact = ref.paged_decode_attention_int8(*args).float()
    exact_lse = ref.paged_decode_lse(q, kq, tables, lengths, ks)
    f32 = [a.float() if a.is_floating_point() else a for a in args]
    plain32 = ref.paged_decode_attention_int8(*f32)
    live = lengths > 0
    for name, plan in _gqa_plans(len(lens), hq, hkv, hd, page,
                                 pages).items():
        rounded, lse = _int8_walk(args, plan)
        assert bool(torch.isfinite(rounded).all()), name
        for r in np.flatnonzero(np.asarray(lens) == 0):
            assert torch.equal(rounded[r], torch.zeros_like(rounded[r]))
            assert bool((lse[r] == -1e30).all())
        assert float((rounded - exact).abs().max()) <= P_BF16_TOL, name
        assert float((lse - exact_lse)[live].abs().max()) <= LSE_TOL, name
        merged, lse32 = _int8_walk(f32, plan, p_bf16=False)
        _close(merged, plain32)
        _close(lse32[live], ref.paged_decode_lse(
            f32[0], kq, tables, lengths, f32[3])[live])


def test_int8_wg_walk_plan_at_the_paths_shape():
    """The int8_decode path's 4 rows of 392 / 264 / 456 / 108 tokens over
    a 512-token window: 4 splits of 2 tiles, of which 4, 3, 4 and 1 are
    live; the 64 slots of the kernels phase: one split of 8 tiles."""
    plan = pa.decode_split_plan(4, 32, 8, 64, 64, 8)
    assert (plan.tiles, plan.splits, plan.blocks) == (2, 4, 128)
    assert [plan.live_splits(n) for n in (392, 264, 456, 108)] == \
        [4, 3, 4, 1]
    slots = pa.decode_split_plan(64, 32, 8, 64, 64, 8)
    assert (slots.tiles, slots.splits) == (8, 1)


@pytest.mark.parametrize("hq,hkv,hd,page,pages,lens", [
    (8, 2, 64, 16, 12, (0, 1, 16, 17, 64, 65, 128, 129, 192)),
    (4, 1, 64, 32, 8, (0, 17, 129, 256)),
    (4, 4, 128, 64, 4, (1, 65, 256)),
])
def test_int8_wg_walk_against_jax(hq, hkv, hd, page, pages, lens):
    """Without the rounding the int8 walk equals the JAX package's oracle
    (``paged_decode_attention_int8_ref``) on the live rows and its Pallas
    kernel (``paged_decode_attention_int8``) in interpret mode on the rows
    whose table entries lie in the pool, within 1e-4; with it, within
    P_BF16_TOL of the Pallas kernel."""
    args = _int8_inputs(hq, hkv, hd, page, pages, lens, hq + hd + page + 41)
    f32 = [a.float() if a.is_floating_point() else a for a in args]
    plan = pa.decode_split_plan(len(lens), hq, hkv, hd, page, pages)
    merged, _ = _int8_walk(f32, plan, p_bf16=False)
    rounded, _ = _int8_walk(args, plan)
    jargs = [jnp.asarray(f32[0].numpy()), jnp.asarray(args[1].numpy()),
             jnp.asarray(args[2].numpy()),
             jnp.asarray(f32[3].numpy(), jnp.bfloat16),
             jnp.asarray(f32[4].numpy(), jnp.bfloat16),
             jnp.asarray(args[5].numpy()), jnp.asarray(args[6].numpy())]
    live = [r for r in range(len(lens) - 1) if lens[r] > 0]
    _close(merged[live], np.asarray(
        jref.paged_decode_attention_int8_ref(*jargs))[live])
    pallas = np.asarray(jops.paged_decode_int8(*jargs, backend="interpret"))
    _close(merged[:-1], pallas[:-1])
    assert float(np.abs(rounded[:-1].numpy() - pallas[:-1]).max()) \
        <= P_BF16_TOL


# ---------------------------------------------------------------------------
# kernel 4's walk
# ---------------------------------------------------------------------------
MLA_PAGE = 64


def _mla_wg_walk(q_lat, q_rope, pages, tables, lengths, dl, scale,
                 p_bf16=True):
    """``ref.mla_paged_decode`` as the `wgmma` body and the combine
    compute it: per row, splits of ``decode_split_tokens(window)`` tokens
    walked in 64-token page tiles; a row of one split divides by its own
    l, a longer row's splits (m kept >= NEG_INF) merged in split order."""
    lat = ref._gather(pages, tables).float()
    b, hq, _ = q_lat.shape
    t = lat.shape[1]
    c, kr = lat[..., :dl], lat[..., dl:]
    s = (torch.einsum("bhl,btl->bht", q_lat.float(), c)
         + torch.einsum("bhr,btr->bht", q_rope.float(), kr)) * scale * LOG2E
    x = s.masked_fill(~ref._length_mask(lengths, t), NEG)
    split = mpd.decode_split_tokens(t)
    out = torch.zeros(b, hq, dl)
    for row in range(b):
        end = min(max(int(lengths[row]), 0), t)
        n_split = max(1, -(-end // split))
        xr = x[row:row + 1]

        def pv(p, sel, row=row):
            return torch.einsum("bht,btl->bhl", p, c[row:row + 1, sel])
        parts = []
        for sp in range(n_split):
            lo, hi = sp * split, min((sp + 1) * split, end)
            m, l, acc = _online(xr, pv, lo, hi, MLA_PAGE, p_bf16)
            if not torch.is_tensor(acc):        # an empty row: no tile
                acc = torch.zeros(1, hq, dl)
            parts.append((m, l, acc))
        if n_split == 1:
            m, l, acc = parts[0]
            out[row] = (acc / l.clamp_min(1e-30))[0]
        else:
            parts = [(m.clamp_min(ref.NEG_INF), l, a) for m, l, a in parts]
            _, den, acc = _merge(parts)
            out[row] = (acc / den.clamp_min(1e-30))[0]
    return out


# (Hq, dl, dr, pages of 64 tokens, lengths): DeepSeek-V3's widths over a
# 2048-token window (4 splits of 512: page, split and window edges), a
# 640-token window, and narrower latent widths of the same layout for
# the Pallas kernel in interpret mode
MLA_WALK_CASES = [
    (128, 512, 64, 32, (0, 1, 63, 64, 65, 511, 512, 513, 700, 1024, 2047,
                        2048)),
    (16, 512, 64, 10, (0, 64, 511, 512, 513, 640)),
    (8, 64, 16, 10, (0, 1, 63, 256, 512, 513, 640)),
    (4, 32, 8, 20, (0, 511, 512, 1000, 1280)),
]


def _mla_inputs(hq, dl, dr, pages, lens, seed):
    rng = np.random.default_rng(seed)
    b = len(lens)
    n = b * pages + 2
    tables = _tables(rng, b, pages, n)
    tables[-1, 1] = n + 3                       # clamps to page n - 1
    return (_bf16(rng, (b, hq, dl)), _bf16(rng, (b, hq, dr)),
            _bf16(rng, (n, MLA_PAGE, dl + dr)), tables,
            torch.tensor(lens, dtype=torch.int32))


@pytest.mark.parametrize("hq,dl,dr,pages,lens", MLA_WALK_CASES)
def test_mla_wg_walk_within_card_tolerance(hq, dl, dr, pages, lens):
    args = _mla_inputs(hq, dl, dr, pages, lens, hq + dl + pages)
    scale = 1.0 / math.sqrt(128 + dr) if dl == 512 else ref.mla_scale(dl,
                                                                       dr)
    exact = ref.mla_paged_decode(*args, d_latent=dl, scale=scale).float()
    rounded = _mla_wg_walk(*args, dl, scale)
    assert bool(torch.isfinite(rounded).all())
    for r in np.flatnonzero(np.asarray(lens) == 0):
        assert torch.equal(rounded[r], torch.zeros_like(rounded[r]))
    assert float((rounded - exact).abs().max()) <= P_BF16_TOL
    f32 = [a.float() if a.is_floating_point() else a for a in args]
    merged = _mla_wg_walk(*f32, dl, scale, p_bf16=False)
    _close(merged, ref.mla_paged_decode(*f32, d_latent=dl, scale=scale))
    if dl <= 64:
        # the JAX package's oracle (live rows) and its Pallas kernel in
        # interpret mode (rows whose table entries lie in the pool)
        jargs = [jnp.asarray(a.numpy()) for a in f32]
        live = [r for r in range(len(lens) - 1) if lens[r] > 0]
        _close(merged[live], np.asarray(jref.mla_paged_decode_ref(
            *jargs, d_latent=dl, scale=scale))[live])
        pallas = np.asarray(jops.mla_decode(*jargs, d_latent=dl,
                                            scale=scale,
                                            backend="interpret"))
        _close(merged[:-1], pallas[:-1])
        assert float(np.abs(rounded[:-1].numpy() - pallas[:-1]).max()) \
            <= P_BF16_TOL
