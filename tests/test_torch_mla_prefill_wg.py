"""The absorbed-MLA chunk / segment prefill's Hopper body
(``mla_prefill_wg`` of ``csrc/mla_prefill_wg.cuh``, kernels 5 and 6 at
DeepSeek-V3's widths over 64-token pages) emulated on the CPU.

The walk is emulated in PyTorch as the body computes it: for query i of
row b, the pool's 64-token pages below the walk's end (the offset, or the
query's position cut at the row's pool limit, found as the body's loads
warp finds it), then the chunk's own rows in tiles of 64 up to row i;
each tile under its 64-bit key mask (the rows below the end or at most i,
less in SEGMENT the slots the chunk's positions will fill), the dropped
rows' latent zeroed and their scores replaced by -inf, the online softmax
in log2 units, P rounded to bf16 for P V, and acc / max(l, 1e-30).

The emulation is held to the plain versions (``ref.mla_paged_prefill``,
``ref.mla_paged_prefill_segments``) within P_BF16_TOL with P rounded and
within 1e-4 without, and, without the rounding, to the JAX package's
kernels run in interpret mode, at offsets 0, 37, 63, 64 and 1024, C 8,
64 and 100 (two chunk tiles), two rows with different offsets, segment
positions with two gaps and -1 padding, clamped table entries and rows
that read no pool token.  Non-finite values in every slot no query may
read leave the emulated output as it was, and the segment walk with
contiguous positions equals the offset walk bit for bit.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from test_torch_kernels import (P_BF16_TOL, _bf16, _close, _cpos,  # noqa: E402
                                _tables)

LOG2E = 1.4426950408889634
NEG = float("-inf")
KT = 64          # keys a tile: one pool page, or 64 chunk rows


def _pool_limit(cp):
    """The row's pool limit as the body's loads warp finds it: the last
    valid index, the offset d of the trailing run, and the last index
    before the run (``pool_limit_warp``)."""
    valid = [c for c, p in enumerate(cp) if p >= 0]
    if not valid:
        return 0
    last = valid[-1]
    d = cp[last] - last
    brk = max([c for c in range(last + 1) if cp[c] < 0 or cp[c] - c != d],
              default=-1)
    return d + brk + 1


def _tiles(where_row, i, c, window, seg):
    """Query i's tiles in walk order: (kind, first key, keep mask)."""
    if seg:
        cp = [int(x) for x in where_row]
        end = min(_pool_limit(cp), max(cp[i], 0))
        own = set(cp)
    else:
        end = max(int(where_row), 0)
        own = set()
    end = min(end, window)
    out = []
    for t in range(-(-end // KT)):
        pos = np.arange(t * KT, (t + 1) * KT)
        out.append(("pool", t * KT, (pos < end) & ~np.isin(pos, list(own))))
    for u in range(i // KT + 1):
        rows = np.arange(u * KT, min((u + 1) * KT, c))
        out.append(("chunk", u * KT, rows <= i))
    return out


def _wg_walk(q_lat, q_rope, lat_chunk, pages, tables, where, dl, scale,
             seg, p_bf16=True):
    """ctx [B,C,Hq,dl] as ``mla_prefill_wg`` computes it."""
    b, c, hq, _ = q_lat.shape
    window = tables.shape[1] * pages.shape[1]
    pool = ref._gather(pages, tables).float()       # clamped entries
    out = torch.zeros(b, c, hq, dl)
    for row in range(b):
        for i in range(c):
            q = torch.cat([q_lat[row, i], q_rope[row, i]], -1).float()
            m = torch.full((hq, 1), NEG)
            l = torch.zeros(hq, 1)
            acc = torch.zeros(hq, dl)
            for kind, k0, keep in _tiles(where[row], i, c, window, seg):
                src = pool[row] if kind == "pool" else lat_chunk[row].float()
                keys = src[k0:k0 + len(keep)]
                keep = torch.from_numpy(keep)
                x = (q @ keys.T) * scale * LOG2E
                x = torch.where(keep[None], x, torch.full_like(x, NEG))
                v = torch.where(keep[:, None], keys[:, :dl],
                                torch.zeros_like(keys[:, :dl]))
                mx = torch.maximum(m, x.amax(-1, keepdim=True))
                base = torch.where(mx == NEG, torch.zeros_like(mx), mx)
                alpha = torch.exp2(m - base)
                p = torch.exp2(x - base)
                l = l * alpha + p.sum(-1, keepdim=True)
                acc = acc * alpha + (p.bfloat16().float() if p_bf16
                                     else p) @ v
                m = mx
            out[row, i] = acc / l.clamp_min(1e-30)
    return out


def _inputs(hq, dl, dr, pages, c, b, seed):
    rng = np.random.default_rng(seed)
    n = b * pages + 2
    tables = _tables(rng, b, pages, n)
    tables[-1, 0] = n + 3                       # clamps to page n - 1
    tables[0, -1] = -2                          # clamps to page 0
    return (_bf16(rng, (b, c, hq, dl)), _bf16(rng, (b, c, hq, dr)),
            _bf16(rng, (b, c, dl + dr)), _bf16(rng, (n, KT, dl + dr)),
            tables)


def _scale(dl, dr):
    return 1.0 / math.sqrt(128 + dr) if dl == 512 else ref.mla_scale(dl, dr)


# (Hq, dl, dr, pages of 64 tokens, C, offsets of the rows): DeepSeek-V3's
# widths at C 8 and 64 (offsets on and off a page edge, a row reading no
# pool token), then narrower latent widths of the same layout at C 100
# (two chunk tiles) and offset 1024, and for the Pallas kernel
PREFILL_CASES = [
    (8, 512, 64, 2, 8, (0, 37)),
    (4, 512, 64, 2, 64, (63, 64)),
    (4, 64, 16, 18, 100, (1024, 37)),
    (4, 32, 8, 3, 100, (0, 63)),
]
# (Hq, dl, dr, pages, C, rows of chunk positions): two gaps, -1 padding,
# an all-padding row, a contiguous row, two chunk tiles
SEG_CASES = [
    (8, 512, 64, 3, 16, (list(range(30, 36)) + list(range(100, 106)),
                         [])),
    (4, 64, 16, 4, 100, (list(range(5, 60)) + list(range(130, 175)),
                         list(range(37, 137)))),
    (4, 32, 8, 3, 64, (list(range(2, 10)) + list(range(70, 90)),
                       list(range(120, 150)) + [180])),
]


def _cases():
    for hq, dl, dr, pages, c, offs in PREFILL_CASES:
        yield (False, hq, dl, dr, pages, c,
               torch.tensor(offs, dtype=torch.int32))
    for hq, dl, dr, pages, c, rows in SEG_CASES:
        yield (True, hq, dl, dr, pages, c, torch.from_numpy(_cpos(rows, c)))


CASES = list(_cases())


def _plain(seg, args, where, dl, scale):
    fn = ref.mla_paged_prefill_segments if seg else ref.mla_paged_prefill
    return fn(*args, where, d_latent=dl, scale=scale).float()


@pytest.mark.parametrize("case", range(len(CASES)))
def test_mla_prefill_wg_walk_within_card_tolerance(case):
    seg, hq, dl, dr, pages, c, where = CASES[case]
    args = _inputs(hq, dl, dr, pages, c, len(where), hq + dl + c)
    scale = _scale(dl, dr)
    rounded = _wg_walk(*args, where, dl, scale, seg)
    assert bool(torch.isfinite(rounded).all())
    assert float((rounded - _plain(seg, args, where, dl, scale)).abs()
                 .max()) <= P_BF16_TOL
    f32 = [a.float() if a.is_floating_point() else a for a in args]
    merged = _wg_walk(*f32, where, dl, scale, seg, p_bf16=False)
    _close(merged, _plain(seg, f32, where, dl, scale))
    if dl <= 64:
        # the JAX package's Pallas kernel in interpret mode, on the table
        # entries the body clamps into the pool
        n = f32[3].shape[0]
        jargs = [jnp.asarray(a.numpy()) for a in f32[:4]] + [
            jnp.asarray(f32[4].clamp(0, n - 1).numpy()),
            jnp.asarray(where.numpy())]
        fn = jops.mla_prefill_seg if seg else jops.mla_prefill
        pallas = np.asarray(fn(*jargs, d_latent=dl, scale=scale,
                               backend="interpret"))
        _close(merged, pallas)
        assert float(np.abs(rounded.numpy() - pallas).max()) <= P_BF16_TOL


def test_mla_prefill_wg_pool_limit_matches_plain():
    """The loads warp's pool limit equals ``ref.pool_limits`` on rows
    with gaps, padding in the middle and at the end, and none valid."""
    rows = [[3, 4, 5, 20, 21, 22], [-1, -1], [7, -1, 9, 10, -1], [0],
            [5, 6, 7, 8], [40, 41, 60, 61, 62, -1, -1], [1, 3, 5, 7]]
    cp = torch.from_numpy(_cpos(rows, 8))
    assert [_pool_limit(r) for r in cp.tolist()] == \
        ref.pool_limits(cp).tolist()


def test_mla_prefill_wg_ignores_unread_slots():
    """Non-finite values in every pool slot no query may read (past the
    offset, the segment chunk's own slots, past its last position, pages
    of the table past the walk) leave the walk's output as it was."""
    hq, dl, dr, pages, c = 4, 64, 16, 4, 24
    args = list(_inputs(hq, dl, dr, pages, c, 2, 7))
    args[4] = torch.arange(1, 2 * pages + 1,                 # no shared page
                           dtype=torch.int32).reshape(2, pages)
    scale = _scale(dl, dr)
    offs = torch.tensor([70, 0], dtype=torch.int32)
    cpos = torch.from_numpy(_cpos([list(range(10, 22))
                                   + list(range(150, 162)),
                                   list(range(3, 27))], c))
    for seg, where in ((False, offs), (True, cpos)):
        clean = _wg_walk(*args, where, dl, scale, seg)
        dirty = args[3].clone()
        for row in range(2):
            read = np.zeros(pages * KT, bool)
            for i in range(c):
                for kind, k0, keep in _tiles(where[row], i, c, pages * KT,
                                             seg):
                    if kind == "pool":
                        read[k0:k0 + KT] |= keep
            for pos in np.flatnonzero(~read):
                dirty[int(args[4][row, pos // KT]), pos % KT] = \
                    float("nan") if pos % 2 else float("inf")
        out = _wg_walk(*args[:3], dirty, args[4], where, dl, scale, seg)
        assert bool(torch.isfinite(out).all())
        assert torch.equal(out, clean)


def test_mla_prefill_wg_contiguous_segment_equals_offset_bitwise():
    """With contiguous positions the segment walk keeps the offset walk's
    tiles and masks, so the two agree bit for bit (C 100: two chunk
    tiles)."""
    hq, dl, dr, pages, c = 4, 64, 16, 4, 100
    args = _inputs(hq, dl, dr, pages, c, 2, 9)
    offs = [37, 64]
    cpos = torch.tensor([[o + i for i in range(c)] for o in offs],
                        dtype=torch.int32)
    scale = _scale(dl, dr)
    seg = _wg_walk(*args, cpos, dl, scale, True)
    off = _wg_walk(*args, torch.tensor(offs, dtype=torch.int32), dl, scale,
                   False)
    assert torch.equal(seg, off)
