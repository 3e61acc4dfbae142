"""The port's CUDA kernels (GQA paged decode / prefill / segment
prefill, their absorbed-MLA counterparts, causal flash prefill with its
log-sum-exp, the flash prefill backward and int8 paged decode, both
decodes with their log-sum-exps and a two-slice split merged by them)
against their plain PyTorch versions on the card, and the
bf16 decode kernels' split walks against themselves (bit for bit); the
GQA chunk / segment prefill's `wgmma` body at hd 64 / 128 over 16-, 32-
and 64-token pages (its split plans, inf / NaN in slots no row may
read, bit for bit twice and against the offset call); the GQA
decode's Hopper body and the MLA decode's `wgmma` body (their split
plans, inf / NaN in unread slots, bit for bit twice, the body queries);
the MLA kernels on the dense layout's routes (a whole prompt at offset 0,
latent slots seen as pages); the MoE FFN's routing on the card against
the CPU's; engines on the card against the CPU engine.
Needs a CUDA device and the CUDA toolkit (the kernels build at first
use); elsewhere every test skips.  Run on the card with

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py

Imports no JAX: the machine with the card has none.  Tolerances: float32
in and out, the kernels and the plain versions differ only in summation
order (1e-4, the CPU parity bar); bf16 outputs may differ by one bf16
step, at most 2^-6 for these |o| < 4."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

pytestmark = pytest.mark.gpu

F32_TOL = 1e-4
BF16_TOL = 2.0 ** -6


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    from repro_torch.kernels import ops
    return ops


def _inputs(dtype, b=5, c=16, hq=8, hkv=2, hd=64, page=16, pages=6, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rn(*s):
        return torch.randn(s, generator=g, device="cuda").to(dtype)
    n = b * pages + 2
    tables = (torch.randperm(n - 1, generator=g, device="cuda")[:b * pages]
              + 1).reshape(b, pages).to(torch.int32)
    return dict(q=rn(b, c, hq, hd), kc=rn(b, c, hkv, hd),
                vc=rn(b, c, hkv, hd), kp=rn(n, page, hkv, hd),
                vp=rn(n, page, hkv, hd), tables=tables)


def _err(a, b):
    return float((a.float() - b.float()).abs().max())


@pytest.mark.parametrize("dtype,tol", [(torch.float32, F32_TOL),
                                       (torch.bfloat16, BF16_TOL)])
@pytest.mark.parametrize("hq,hkv,hd", [(8, 2, 64), (4, 4, 32), (8, 1, 128)])
def test_paged_decode_kernel(cuda, dtype, tol, hq, hkv, hd):
    a = _inputs(dtype, hq=hq, hkv=hkv, hd=hd)
    q = a["q"][:, 0].contiguous()
    lengths = torch.tensor([0, 1, 17, 96, 50], dtype=torch.int32,
                           device="cuda")
    args = (q, a["kp"], a["vp"], a["tables"], lengths)
    before = cuda.paged_decode_attention.launches
    out = cuda.paged_decode(*args)
    torch.cuda.synchronize()
    assert _err(out, cuda.paged_decode(*args, backend="torch")) <= tol
    assert bool((out[0] == 0).all())            # length 0 -> zeros
    assert cuda.paged_decode_attention.launches == before + 1


# lengths that start, end and cross the bandwidth body's 64-key tiles
# (16 keys a warp), a row of length 0 and full tables
EDGE_LENGTHS = [0, 1, 15, 16, 17, 63, 64, 65, 127, 128, 129, 300, 511, 512]


@pytest.mark.parametrize("hq,hkv,hd,page", [(32, 8, 64, 64), (32, 8, 64, 16),
                                            (8, 1, 128, 64), (6, 6, 64, 64),
                                            (32, 8, 128, 64)])
def test_paged_decode_kernel_long_rows(cuda, hq, hkv, hd, page):
    """llama3.2-1b width (and MQA at hd 128, whisper-tiny's MHA at G 1,
    llama-3.2-vision's 32 / 8 heads at hd 128), bf16 on the bandwidth
    body: 64 rows over 512-token tables with lengths at the tile edges,
    clamped table entries inside the length, one launch a call, and two
    calls equal bit for bit."""
    b, pages = 64, 512 // page
    g = torch.Generator(device="cuda").manual_seed(11)
    n = b * pages + 2
    kp = torch.randn((n, page, hkv, hd), generator=g,
                     device="cuda").bfloat16()
    vp = torch.randn((n, page, hkv, hd), generator=g,
                     device="cuda").bfloat16()
    tables = (torch.randperm(n - 1, generator=g, device="cuda")[:b * pages]
              + 1).reshape(b, pages).to(torch.int32)
    tables[-2, 0] = n + 40                      # clamps to page n - 1
    tables[-1, 1] = -3                          # clamps to page 0
    lengths = torch.randint(1, 513, (b,), generator=g,
                            device="cuda").to(torch.int32)
    lengths[:len(EDGE_LENGTHS)] = torch.tensor(EDGE_LENGTHS)
    lengths[-2:] = 512
    q = torch.randn((b, hq, hd), generator=g, device="cuda").bfloat16()
    args = (q, kp, vp, tables, lengths)
    before = cuda.paged_decode_attention.launches
    out = cuda.paged_decode(*args)
    torch.cuda.synchronize()
    assert cuda.paged_decode_attention.launches == before + 1
    assert bool(torch.isfinite(out).all())
    assert bool((out[0] == 0).all())            # length 0 -> zeros
    assert _err(out, cuda.paged_decode(*args, backend="torch")) <= BF16_TOL
    assert torch.equal(out, cuda.paged_decode(*args))


# (Hq, Hkv, hd, page, pages, C, offsets) of the chunk prefill cases: the
# tensor-core body's widths (hd 16 / 32 / 64 / 128, G 1 / 4 / 8 / 16) at
# 16- and 64-token pages, offsets at 0 and at tile and page edges, a chunk
# of two key tiles (C 80); G 32 (the CUDA-core body in bf16); then
# llama3.2-1b's geometry at the window's last chunk (offset 448) and at
# its first (offset 0)
PREFILL_CASES = [
    (8, 2, 64, 16, 6, 16, (0, 5, 16, 40, 80)),
    (8, 2, 16, 64, 3, 16, (0, 5, 64, 100, 180)),
    (4, 4, 32, 16, 6, 80, (0, 15, 63, 64, 96)),
    (8, 1, 128, 64, 3, 16, (0, 63, 64, 65, 190)),
    (16, 1, 32, 16, 6, 16, (0, 1, 33, 95)),
    (32, 1, 64, 16, 6, 16, (0, 5, 40)),
    (32, 8, 64, 64, 8, 64, (448,)),
    (32, 8, 64, 64, 8, 64, (0,)),
]


@pytest.mark.parametrize("dtype,tol", [(torch.float32, F32_TOL),
                                       (torch.bfloat16, BF16_TOL)])
@pytest.mark.parametrize("hq,hkv,hd,page,pages,c,offs", PREFILL_CASES)
def test_paged_prefill_kernel(cuda, dtype, tol, hq, hkv, hd, page, pages, c,
                              offs):
    """Against the plain version, with a clamped table entry inside a
    row's window; one launch a call, and two calls equal bit for bit."""
    a = _inputs(dtype, b=len(offs), c=c, hq=hq, hkv=hkv, hd=hd, page=page,
                pages=pages)
    tables = a["tables"].clone()
    tables[-1, 0] = -2                          # clamps to page 0
    offs = torch.tensor(offs, dtype=torch.int32, device="cuda")
    args = (a["q"], a["kc"], a["vc"], a["kp"], a["vp"], tables, offs)
    before = cuda.paged_prefill_attention.launches
    out = cuda.paged_prefill(*args)
    torch.cuda.synchronize()
    assert cuda.paged_prefill_attention.launches == before + 1
    assert bool(torch.isfinite(out).all())
    assert _err(out, cuda.paged_prefill(*args, backend="torch")) <= tol
    assert torch.equal(out, cuda.paged_prefill(*args))


# (Hq, Hkv, hd, page, pages, C, rows of chunk positions) of the segment
# cases: the widths of PREFILL_CASES with two gap chunks around resumed
# islands (one crossing a 64-key tile), a contiguous row, a row of
# padding only and a short row; then llama3.2-1b's geometry with the
# serve phase's gap chunk (block 0's second half, a resumed block, the
# tail), a gap chunk whose pool limit (520) lies past the 512-token
# window, a contiguous last chunk and a row of padding only
SEG_ROWS = ([3, 4, 5, 6, 40, 41, 42, 43], list(range(16)), [],
            [10, 11, 12, 50, 51, 52, 53, 54, 55, 56, 57, 70, 71], [90, 91])
PREFILL_SEG_CASES = [w[:6] + (SEG_ROWS,) for w in PREFILL_CASES[:6]] + [
    (32, 8, 64, 64, 8, 64, (list(range(64, 96)) + list(range(256, 280)),
                            list(range(100, 120)) + list(range(520, 560)),
                            list(range(448, 512)), [])),
]


@pytest.mark.parametrize("dtype,tol", [(torch.float32, F32_TOL),
                                       (torch.bfloat16, BF16_TOL)])
@pytest.mark.parametrize("hq,hkv,hd,page,pages,c,rows", PREFILL_SEG_CASES)
def test_paged_prefill_seg_kernel(cuda, dtype, tol, hq, hkv, hd, page, pages,
                                  c, rows):
    """Against the plain version; stale slots (the chunk's own and those
    past every position) hold 8x larger K/V, which a one-slot mask error
    would read; one launch a call, and two calls equal bit for bit."""
    a = _inputs(dtype, b=len(rows), c=c, hq=hq, hkv=hkv, hd=hd, page=page,
                pages=pages)
    cpos = torch.tensor([r + [-1] * (c - len(r)) for r in rows],
                        dtype=torch.int32, device="cuda")
    window, tab = pages * page, a["tables"].cpu()
    stale = [(int(tab[b, t // page]), t % page) for b, r in enumerate(rows)
             for t in set(r) | set(range(max(r, default=-1) + 1, window))
             if t < window]
    pid, slot = (torch.tensor(x, device="cuda") for x in zip(*stale))
    kp, vp = a["kp"].clone(), a["vp"].clone()
    kp[pid, slot] *= 8
    vp[pid, slot] *= 8
    args = (a["q"], a["kc"], a["vc"], kp, vp, a["tables"], cpos)
    before = cuda.paged_prefill_segments.launches
    out = cuda.paged_prefill_seg(*args)
    torch.cuda.synchronize()
    assert cuda.paged_prefill_segments.launches == before + 1
    assert bool(torch.isfinite(out).all())
    assert _err(out, cuda.paged_prefill_seg(*args, backend="torch")) <= tol
    assert torch.equal(out, cuda.paged_prefill_seg(*args))


@pytest.mark.parametrize("hq,hkv,hd,page,pages", [(8, 2, 64, 16, 6),
                                                  (8, 2, 64, 64, 3),
                                                  (32, 8, 64, 64, 8),
                                                  (32, 8, 64, 32, 16),
                                                  (24, 8, 64, 64, 8),
                                                  (8, 1, 128, 32, 8),
                                                  (16, 1, 128, 16, 12),
                                                  (8, 2, 32, 16, 6)])
def test_seg_kernel_contiguous_equals_offset_bitwise(cuda, hq, hkv, hd, page,
                                                     pages):
    a = _inputs(torch.bfloat16, hq=hq, hkv=hkv, hd=hd, page=page,
                pages=pages)
    offs = [0, 5, 16, 40, 80]
    cpos = torch.tensor([[o + i for i in range(16)] for o in offs],
                        dtype=torch.int32, device="cuda")
    base = (a["q"], a["kc"], a["vc"], a["kp"], a["vp"], a["tables"])
    seg = cuda.paged_prefill_seg(*base, cpos)
    off = cuda.paged_prefill(*base, torch.tensor(offs, dtype=torch.int32,
                                                 device="cuda"))
    assert torch.equal(seg, off)


# (Hq, Hkv, hd, page, pages, C, offsets) of the `wgmma` body
# (``paged_prefill_wg``): hd 64 and 128; pages of 16, 32 and 64 tokens;
# offsets at 0, at tile and page edges and at the window's last chunk; G
# 1 / 3 / 4 / 8 / 16; ragged C (1, 17, 63, 80); windows of 4096 and 2048
# tokens, whose splits are longer than the ring (it wraps)
WG_PREFILL_CASES = [
    (32, 8, 64, 64, 8, 64, (0, 63, 64, 320, 448)),
    (32, 8, 64, 32, 16, 64, (0, 31, 32, 336, 448)),
    (8, 8, 64, 16, 12, 17, (0, 15, 16, 65, 175)),
    (24, 8, 64, 64, 8, 63, (0, 64, 320, 449)),
    (64, 8, 128, 16, 24, 64, (0, 128, 300, 320)),
    (16, 1, 128, 32, 8, 1, (0, 1, 64, 255)),
    (16, 1, 64, 64, 4, 80, (0, 5, 176)),
    (8, 2, 128, 64, 3, 17, (0, 40, 175)),
    (32, 8, 64, 64, 64, 64, (0, 1000, 4032)),
    (64, 8, 128, 32, 64, 64, (0, 2000)),
]


def _gap_rows(offs, c, window):
    """Per offset a segment chunk with a gap: c // 2 positions from
    offset // 2, then the rest up to offset + c (the first row ends in 3
    padding slots)."""
    rows = []
    for k, o in enumerate(offs):
        r = list(range(o // 2, o // 2 + c // 2)) + \
            list(range(o + c // 2, o + c))
        rows.append([x for x in r if x < window][:c - 3 if k == 0 else c])
    return rows


def _wg_case(hq, hkv, hd, page, pages, c, offs, seg, seed=0):
    a = _inputs(torch.bfloat16, b=len(offs), c=c, hq=hq, hkv=hkv, hd=hd,
                page=page, pages=pages, seed=seed)
    if seg:
        rows = _gap_rows(offs, c, pages * page)
        where = torch.tensor([r + [-1] * (c - len(r)) for r in rows],
                             dtype=torch.int32, device="cuda")
    else:
        where = torch.tensor(offs, dtype=torch.int32, device="cuda")
    return a, where


@pytest.mark.parametrize("seg", [False, True])
@pytest.mark.parametrize("hq,hkv,hd,page,pages,c,offs", WG_PREFILL_CASES)
def test_paged_prefill_wg_body(cuda, seg, hq, hkv, hd, page, pages, c, offs):
    """The `wgmma` body against the plain version in both modes, with a
    clamped table entry inside a row's window; one launch a call, and two
    calls equal bit for bit."""
    from repro_torch.kernels import paged_prefill as pp
    assert pp.body(hq, hkv, hd, page, 1, 1) == "wgmma"
    a, where = _wg_case(hq, hkv, hd, page, pages, c, offs, seg)
    tables = a["tables"].clone()
    tables[-1, 0] = -2                          # clamps to page 0
    args = (a["q"], a["kc"], a["vc"], a["kp"], a["vp"], tables, where)
    op, fn = ((cuda.paged_prefill_seg, cuda.paged_prefill_segments) if seg
              else (cuda.paged_prefill, cuda.paged_prefill_attention))
    before = fn.launches
    out = op(*args)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    assert bool(torch.isfinite(out).all())
    assert _err(out, op(*args, backend="torch")) <= BF16_TOL
    assert torch.equal(out, op(*args))


@pytest.mark.parametrize("seg", [False, True])
@pytest.mark.parametrize("hq,hkv,hd,page,pages,c,offs",
                         [WG_PREFILL_CASES[i] for i in (0, 3, 5, 8, 9)])
def test_paged_prefill_wg_split_plans(cuda, seg, hq, hkv, hd, page, pages,
                                      c, offs):
    """Plans of one to four tiles a split and of one more than the
    default (those of at most MAX_SPLITS splits: one cluster) agree with
    the plain version, each twice bit for bit; a plan of more splits is
    refused."""
    from repro_torch.kernels import paged_prefill as pp
    a, where = _wg_case(hq, hkv, hd, page, pages, c, offs, seg, seed=3)
    args = (a["q"], a["kc"], a["vc"], a["kp"], a["vp"], a["tables"], where)
    entry = "paged_prefill_seg" if seg else "paged_prefill"
    plan = pp.prefill_split_plan(len(offs), c, hq, hkv, hd, page, pages)
    op = cuda.paged_prefill_seg if seg else cuda.paged_prefill
    plain = op(*args, backend="torch")
    window = pages * page
    for tiles in (1, 2, 3, 4, plan.tiles + 1):
        span = tiles * pp.KEY_TILE
        other = plan._replace(tiles=tiles, pool_splits=-(-window // span),
                              chunk_splits=-(-c // span))
        if other.splits > pp.MAX_SPLITS:
            with pytest.raises(RuntimeError, match="CUDA error"):
                pp._launch(entry, *args, plan=other)
            continue
        out = pp._launch(entry, *args, plan=other)
        torch.cuda.synchronize()
        assert _err(out, plain) <= BF16_TOL
        assert torch.equal(out, pp._launch(entry, *args, plan=other))


@pytest.mark.parametrize("seg", [False, True])
@pytest.mark.parametrize("hq,hkv,hd,page,pages,c,offs",
                         [WG_PREFILL_CASES[i] for i in (0, 1, 2, 4, 8)])
def test_paged_prefill_wg_ignores_nonfinite_unread_slots(cuda, seg, hq, hkv,
                                                         hd, page, pages, c,
                                                         offs):
    """Slots no row may read (at or past a row's offset or pool limit, a
    segment chunk's own slots) holding inf in K and NaN in V, or NaN in K
    and inf in V, leave the output bit for bit as with clean slots: whole
    pages land in shared memory, and the body zeroes those V rows before
    P V and replaces their scores."""
    from repro_torch.kernels import ref
    a, where = _wg_case(hq, hkv, hd, page, pages, c, offs, seg, seed=5)
    args = (a["q"], a["kc"], a["vc"], a["kp"], a["vp"], a["tables"], where)
    op = cuda.paged_prefill_seg if seg else cuda.paged_prefill
    clean = op(*args)
    window = pages * page
    pos = torch.arange(window, device="cuda")
    if seg:
        limit = ref.pool_limits(where).long()
        own = (pos[None, :, None] == where.long()[:, None, :]).any(-1)
        unread = own | (pos[None] >= limit[:, None])
    else:
        unread = pos[None] >= where.long()[:, None]
    pid = a["tables"].long()[:, pos // page]
    slots = (pid * page + pos % page)[unread]
    assert slots.numel() > 0
    for kbad, vbad in ((float("inf"), float("nan")),
                       (float("nan"), float("inf"))):
        kp, vp = a["kp"].clone(), a["vp"].clone()
        kp.view(-1, *kp.shape[2:])[slots] = kbad
        vp.view(-1, *vp.shape[2:])[slots] = vbad
        out = op(a["q"], a["kc"], a["vc"], kp, vp, a["tables"], where)
        torch.cuda.synchronize()
        assert bool(torch.isfinite(out).all())
        assert torch.equal(out, clean)


def test_gqa_kernels_at_replay_page(cuda):
    """Kernels 1-3 at the trace replay's 32-token pages (each 64-key
    tile gathers two pages) with llama3.2-1b's heads, bf16, over a
    768-token window: ragged decode rows, chunks at offsets on and off
    page edges, and gap chunks around resumed blocks; every slot no row
    may read (past a row's length or offset, a gap chunk's own slots)
    holds 8x larger K/V, as reused pool pages hold stale rows."""
    hq, hkv, hd, page, pages, c = 32, 8, 64, 32, 24, 64
    window = page * pages
    a = _inputs(torch.bfloat16, b=6, c=c, hq=hq, hkv=hkv, hd=hd, page=page,
                pages=pages, seed=32)
    tab = a["tables"].cpu()

    def stale(limits, own=()):
        """Pool K/V with row b's slots at positions >= limits[b] (and
        its ``own`` positions) scaled by 8."""
        idx = [(int(tab[b, t // page]), t % page)
               for b, lim in enumerate(limits)
               for t in set(range(lim, window)) | set(own[b] if own else ())]
        pid, slot = (torch.tensor(x, device="cuda") for x in zip(*idx))
        kp, vp = a["kp"].clone(), a["vp"].clone()
        kp[pid, slot] *= 8
        vp[pid, slot] *= 8
        return kp, vp

    lengths = [0, 1, 31, 33, 417, window]
    kp, vp = stale(lengths)
    dec = (a["q"][:, 0].contiguous(), kp, vp, a["tables"],
           torch.tensor(lengths, dtype=torch.int32, device="cuda"))
    offs = [0, 31, 32, 96, 415, window - c]
    kp, vp = stale(offs)
    pre = (a["q"], a["kc"], a["vc"], kp, vp, a["tables"],
           torch.tensor(offs, dtype=torch.int32, device="cuda"))
    rows = [list(range(16, 32)) + list(range(96, 128)),
            list(range(31, 34)) + list(range(200, 240)),
            list(range(window - c, window)), [], [5],
            list(range(320, 352)) + list(range(384, 400))]
    kp, vp = stale([max(r, default=-1) + 1 for r in rows], own=rows)
    seg = (a["q"], a["kc"], a["vc"], kp, vp, a["tables"],
           torch.tensor([r + [-1] * (c - len(r)) for r in rows],
                        dtype=torch.int32, device="cuda"))
    for op, args in ((cuda.paged_decode, dec), (cuda.paged_prefill, pre),
                     (cuda.paged_prefill_seg, seg)):
        out = op(*args)
        torch.cuda.synchronize()
        assert bool(torch.isfinite(out).all())
        assert _err(out, op(*args, backend="torch")) <= BF16_TOL
    assert bool((cuda.paged_decode(*dec)[0] == 0).all())   # length 0


def test_kernel_wrappers_reject_bad_inputs(cuda):
    a = _inputs(torch.bfloat16)
    q = a["q"][:, 0]                            # not contiguous
    lengths = torch.ones(5, dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="contiguous"):
        cuda.paged_decode(q, a["kp"], a["vp"], a["tables"], lengths)
    with pytest.raises(ValueError, match="int32"):
        cuda.paged_decode(q.contiguous(), a["kp"], a["vp"],
                          a["tables"].long(), lengths)
    with pytest.raises(ValueError, match="dtypes"):
        cuda.paged_decode(q.contiguous().half(), a["kp"], a["vp"],
                          a["tables"], lengths)


# Kernels 1 and 8 with their log-sum-exp output: (q dtype, Hq, Hkv, hd,
# page): the bf16 tensor-core bodies at hd 64 (G 4) and hd 128 (G 8), at
# G 1, and the float32-query CUDA-core body
LSE_CASES = [(torch.bfloat16, 32, 8, 64, 16),
             (torch.bfloat16, 8, 1, 128, 64),
             (torch.bfloat16, 6, 6, 64, 64), (torch.float32, 8, 2, 64, 16)]
LSE_PAGES = 8
# ragged rows over 8-page tables, in pages: a length-0 row, rows that end
# in the first half, on the halves' border, just past it, and full
LSE_LENGTHS = lambda page: [0, 1, 17, 4 * page, 4 * page + 1,  # noqa: E731
                            8 * page - 5, 8 * page]
# float32 log-sum-exps of the same float32 scores summed in another order
LSE_ATOL = 1e-3


def _halves(tables, lengths, page):
    """Each row's block table cut into two halves of pages, each with
    the row's keys that fall in it (a split decode's two slices)."""
    p1 = tables.shape[1] // 2
    cut = p1 * page
    return ((tables[:, :p1].contiguous(), lengths.clamp(max=cut)),
            (tables[:, p1:].contiguous(), (lengths - cut).clamp(min=0)))


def _check_lse(run, plain, lse_ref, tables, lengths, page, tol):
    """``run(tables, lengths, with_lse=...)``'s output and log-sum-exp
    against the plain versions'; a row with no key writes -1e30 (finite,
    never NaN); and the two halves of every row's table, each launched
    with its log-sum-exp and merged by ``merge_slices``, equal the
    whole-row launch."""
    from repro_torch.kernels.abstract import merge_slices
    out, lse = run(tables, lengths, with_lse=True)
    torch.cuda.synchronize()
    assert lse.dtype == torch.float32 and lse.shape == out.shape[:2]
    assert _err(out, plain) <= tol
    assert bool(torch.isfinite(lse).all())
    assert _err(lse, lse_ref) <= LSE_ATOL
    assert bool((lse[lengths == 0] == -1e30).all())
    assert torch.equal(out, run(tables, lengths))
    parts = [run(t, n, with_lse=True) for t, n in _halves(tables, lengths,
                                                          page)]
    merged = merge_slices(torch.stack([o.float() for o, _ in parts]),
                          torch.stack([x for _, x in parts]))
    assert bool(torch.isfinite(merged).all())
    assert _err(merged, out) <= tol


@pytest.mark.parametrize("dtype,hq,hkv,hd,page", LSE_CASES)
def test_paged_decode_lse_output(cuda, dtype, hq, hkv, hd, page):
    from repro_torch.kernels import ref
    a = _inputs(dtype, b=7, hq=hq, hkv=hkv, hd=hd, page=page,
                pages=LSE_PAGES)
    q = a["q"][:, 0].contiguous()
    lengths = torch.tensor(LSE_LENGTHS(page), dtype=torch.int32,
                           device="cuda")
    before = cuda.paged_decode_attention.launches

    def run(tables, n, **kw):
        return cuda.paged_decode(q, a["kp"], a["vp"], tables, n, **kw)
    _check_lse(run, run(a["tables"], lengths, backend="torch"),
               ref.paged_decode_lse(q, a["kp"], a["tables"], lengths),
               a["tables"], lengths, page,
               F32_TOL if dtype == torch.float32 else BF16_TOL)
    assert cuda.paged_decode_attention.launches == before + 4


@pytest.mark.parametrize("dtype,hq,hkv,hd,page", LSE_CASES)
def test_paged_decode_int8_lse_output(cuda, dtype, hq, hkv, hd, page):
    from repro_torch.kernels import ref
    q, kq, vq, ks, vs, tables = _int8_inputs(7, hq, hkv, hd, page,
                                             LSE_PAGES)
    q = q.to(dtype)
    lengths = torch.tensor(LSE_LENGTHS(page), dtype=torch.int32,
                           device="cuda")
    before = cuda.paged_decode_attention_int8.launches

    def run(t, n, **kw):
        return cuda.paged_decode_int8(q, kq, vq, ks, vs, t, n, **kw)
    _check_lse(run, run(tables, lengths, backend="torch"),
               ref.paged_decode_lse(q, kq, tables, lengths, ks),
               tables, lengths, page,
               F32_TOL if dtype == torch.float32 else BF16_TOL)
    assert cuda.paged_decode_attention_int8.launches == before + 4


def test_engine_on_card_matches_cpu_engine(cuda):
    """Greedy tokens of the engine on the card (CUDA kernels) equal the
    same engine's on the CPU (plain versions), float32 weights."""
    from repro_torch.config import reduce_config
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model
    from repro_torch.serving import EngineConfig, SamplingParams, \
        ServingEngine
    cfg = reduce_config(get_config("llama3.2-1b"))
    params = build_model(cfg).init_params(0, device="cpu",
                                          dtype=torch.float32)
    rng = np.random.default_rng(7)
    prompts = [[int(t) for t in rng.integers(0, 250, size=48)]
               for _ in range(4)]
    outs = {}
    for dev in ("cpu", "cuda"):
        p = _to(params, dev)
        eng = ServingEngine(cfg, EngineConfig(max_len=128,
                                              kv_budget_bytes=5e5),
                            params=p, device=dev)
        reqs = [eng.submit(t, params=SamplingParams(max_new_tokens=5))
                for t in prompts]
        eng.run()
        eng.shutdown()
        outs[dev] = [r.generated for r in reqs]
    assert outs["cuda"] == outs["cpu"]


# (B, S, Hq, Hkv, hd): llama3.2-1b's width at the serve phase's padded
# prompt lengths (416 ends in a ragged 32-row tile), GQA / MHA / MQA at
# small widths, a single token, and hd 256 (the 32-row tiles); then the
# tensor-core tiles' edges at hd 64 and 128: a partial 16-row fragment
# (17, 63), one row past a 64-key tile (65, 129); then the cross-attention
# families' self layers: llama-3.2-vision (32 / 8 heads, hd 128) and
# whisper-tiny (6 / 6, hd 64, G 1) from one token to their smoke prompts
FLASH_SHAPES = [(1, 416, 32, 8, 64), (1, 384, 32, 8, 64),
                (2, 160, 8, 2, 64), (1, 100, 4, 4, 32), (1, 70, 8, 1, 128),
                (3, 1, 4, 2, 16), (1, 40, 2, 1, 256),
                (1, 17, 4, 2, 64), (1, 17, 4, 2, 128), (2, 63, 4, 1, 64),
                (2, 63, 4, 1, 128), (1, 65, 8, 2, 64), (1, 65, 8, 2, 128),
                (1, 129, 4, 4, 64), (1, 129, 4, 4, 128),
                (1, 1, 32, 8, 128), (1, 4, 32, 8, 128), (1, 100, 32, 8, 128),
                (1, 512, 32, 8, 128), (1, 1, 6, 6, 64), (1, 4, 6, 6, 64),
                (2, 77, 6, 6, 64), (1, 128, 6, 6, 64)]


@pytest.mark.parametrize("dtype,tol", [(torch.float32, F32_TOL),
                                       (torch.bfloat16, BF16_TOL)])
@pytest.mark.parametrize("b,s,hq,hkv,hd", FLASH_SHAPES)
def test_flash_prefill_kernel(cuda, dtype, tol, b, s, hq, hkv, hd):
    g = torch.Generator(device="cuda").manual_seed(s)

    def rn(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(dtype)
    args = (rn(b, s, hq, hd), rn(b, s, hkv, hd), rn(b, s, hkv, hd))
    before = cuda.flash_prefill.launches
    out = cuda.flash_causal(*args)
    torch.cuda.synchronize()
    assert cuda.flash_prefill.launches == before + 1
    assert bool(torch.isfinite(out).all())
    assert _err(out, cuda.flash_causal(*args, backend="torch")) <= tol


@pytest.mark.parametrize("dtype,tol", [(torch.float32, F32_TOL),
                                       (torch.bfloat16, BF16_TOL)])
@pytest.mark.parametrize("b,s,hq,hkv,hd", [(1, 416, 32, 8, 64),
                                           (2, 65, 8, 2, 128),
                                           (1, 40, 2, 1, 256),
                                           (2, 77, 6, 6, 64)])
def test_flash_prefill_lse_output(cuda, dtype, tol, b, s, hq, hkv, hd):
    """The forward kernel's optional log-sum-exp [B,Hq,S] (both bodies)
    against the plain version's, and the output unchanged by asking
    for it."""
    from repro_torch.kernels.flash_prefill import flash_prefill
    g = torch.Generator(device="cuda").manual_seed(s)

    def rn(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(dtype)
    args = (rn(b, s, hq, hd), rn(b, s, hkv, hd), rn(b, s, hkv, hd))
    out, lse = flash_prefill(*args, with_lse=True)
    torch.cuda.synchronize()
    plain_out, plain_lse = flash_prefill(*args, backend="torch",
                                         with_lse=True)
    assert lse.shape == (b, hq, s) and lse.dtype == torch.float32
    assert torch.equal(out, flash_prefill(*args))
    assert _err(out, plain_out) <= tol
    # float32 scores in both; the sums differ only in order
    assert _err(lse, plain_lse) <= F32_TOL * float(plain_lse.abs().max())


# (B, S, Hq, Hkv, hd, dtype): the chip_smoke kernels phase's backward
# shapes (llama3.2-1b's training batch of one micro-step at S 1024 and
# the ragged 1000, llama-3.2-vision's 32 / 8 at hd 128, whisper-tiny's
# 6 / 6, G 1, a float32 case), then small ones at the tile edges: one
# token, a partial 64-row tile, MQA; then the tensor-core body's edges at
# hd 128 (S 63, 64, 65; G 1) and a split dK/dV walk whose chunks end
# mid-head (S 320 at G 4: chunks of 2 of the 20 tiles).  By
# ``bwd_kv_chunk`` the bf16 shapes at B 4, S 1 and S 100 keep one dK/dV
# block a key tile; the other bf16 shapes split the walk
BWD_SHAPES = [(4, 1024, 32, 8, 64, torch.bfloat16),
              (4, 1000, 32, 8, 64, torch.bfloat16),
              (1, 512, 32, 8, 128, torch.bfloat16),
              (2, 448, 6, 6, 64, torch.bfloat16),
              (1, 512, 32, 8, 64, torch.float32),
              (1, 1, 4, 2, 64, torch.bfloat16), (2, 50, 8, 2, 64, torch.float32),
              (1, 65, 4, 1, 128, torch.float32), (3, 129, 8, 1, 64,
                                                  torch.bfloat16),
              (1, 63, 8, 2, 128, torch.bfloat16),
              (1, 64, 8, 2, 128, torch.bfloat16),
              (1, 65, 8, 2, 128, torch.bfloat16),
              (2, 100, 4, 4, 128, torch.bfloat16),
              (1, 320, 8, 2, 64, torch.bfloat16),
              # the reduced configurations' hd 16 (the train demo's
              # micro-step, a split walk, float32)
              (4, 64, 4, 2, 16, torch.bfloat16),
              (1, 300, 4, 2, 16, torch.bfloat16),
              (2, 70, 4, 2, 16, torch.float32)]
# Backward kernel vs plain version: both recompute the softmax and sum in
# float32 (another order); a bf16 gradient can then round to a
# neighbouring bf16 value, so the gap is held to two bf16 steps of the
# tensor's largest magnitude (2^-6 of it); float32 to 1e-4 of it.  The
# magnitude counts as at least 1: with one token dQ and dK are zero in
# exact arithmetic and both versions return rounding noise.
BWD_RTOL = {torch.bfloat16: 2.0 ** -6, torch.float32: 1e-4}


def bwd_inputs(b, s, hq, hkv, hd, dtype, seed, dv=None):
    """q, k [.., hd], v [.., dv] (hd when None), o and lse from the
    forward kernel, and dO."""
    from repro_torch.kernels.flash_prefill import flash_prefill
    g = torch.Generator(device="cuda").manual_seed(seed)
    dv = hd if dv is None else dv

    def rn(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(dtype)
    q, k, v = rn(b, s, hq, hd), rn(b, s, hkv, hd), rn(b, s, hkv, dv)
    o, lse = flash_prefill(q, k, v, with_lse=True)
    return q, k, v, o, rn(b, s, hq, dv), lse


@pytest.mark.parametrize("b,s,hq,hkv,hd,dtype", BWD_SHAPES)
def test_flash_prefill_bwd_kernel(cuda, b, s, hq, hkv, hd, dtype):
    """dq, dk, dv of the backward kernel against the plain version on the
    forward kernel's own o and lse; one launch a call, and two calls equal
    bit for bit (no atomics); bf16 runs the tensor-core body, float32 the
    CUDA-core body."""
    from repro_torch.kernels.flash_prefill import bwd_body, flash_prefill_bwd
    from repro_torch.kernels.paged_attention import DTYPE_CODES
    assert (bwd_body(hd, hd, DTYPE_CODES[dtype]) != "cuda_core") == \
        (dtype == torch.bfloat16)
    q, k, v, o, do, lse = bwd_inputs(b, s, hq, hkv, hd, dtype, seed=s)
    before = flash_prefill_bwd.launches
    grads = flash_prefill_bwd(q, k, v, o, do, lse)
    torch.cuda.synchronize()
    assert flash_prefill_bwd.launches == before + 1
    plain = flash_prefill_bwd(q, k, v, o, do, backend="torch")
    for got, want, t in zip(grads, plain, (q, k, v)):
        assert got.shape == t.shape and got.dtype == dtype
        assert bool(torch.isfinite(got).all())
        assert _err(got, want) <= BWD_RTOL[dtype] * max(
            1.0, float(want.float().abs().max()))
    again = flash_prefill_bwd(q, k, v, o, do, lse)
    assert all(torch.equal(a, c) for a, c in zip(grads, again))


def test_flash_causal_gradient_on_card_matches_cpu(cuda):
    """float32 FlashCausal on the card (forward kernel with lse, backward
    kernel) against the same function on the CPU (plain forward and
    backward), through a loss that reaches every output."""
    from repro_torch.kernels.flash_prefill import flash_prefill_bwd
    rs = np.random.RandomState(3)
    b, s, hq, hkv, hd = 2, 70, 8, 2, 64
    host = [torch.from_numpy(rs.standard_normal(shape).astype(np.float32))
            for shape in ((b, s, hq, hd), (b, s, hkv, hd), (b, s, hkv, hd),
                          (b, s, hq, hd))]
    grads = {}
    for dev in ("cpu", "cuda"):
        q, k, v = (t.detach().to(dev).requires_grad_(True)
                   for t in host[:3])
        before = flash_prefill_bwd.launches
        out = cuda.flash_causal(q, k, v)
        assert out.grad_fn is not None
        (out * host[3].to(dev)).sum().backward()
        assert flash_prefill_bwd.launches == before + (dev == "cuda")
        grads[dev] = [t.grad.cpu() for t in (q, k, v)]
    for a, c in zip(grads["cuda"], grads["cpu"]):
        assert _err(a, c) <= F32_TOL * float(c.abs().max())


def test_flash_prefill_bwd_rejects_bad_inputs(cuda):
    """Other head widths and a missing lse are refused with an error,
    never routed to the plain version."""
    from repro_torch.kernels.flash_prefill import flash_prefill_bwd
    q, k, v, o, do, lse = bwd_inputs(1, 20, 4, 2, 32, torch.bfloat16, 0)
    with pytest.raises(ValueError, match="hd"):
        flash_prefill_bwd(q, k, v, o, do, lse)
    q, k, v, o, do, lse = bwd_inputs(1, 20, 4, 2, 64, torch.bfloat16, 0)
    with pytest.raises(ValueError, match="lse"):
        flash_prefill_bwd(q, k, v, o, do)
    with pytest.raises(ValueError, match="dtype"):
        flash_prefill_bwd(q, k, v, o.float(), do, lse)
    # a (dk, dv) pair the kernels do not take, for both wrappers
    from repro_torch.kernels.flash_prefill import flash_prefill
    q, k, v, o, do, lse = bwd_inputs(1, 20, 4, 4, 128, torch.bfloat16, 0)
    v96, do96 = v[..., :96].contiguous(), do[..., :96].contiguous()
    with pytest.raises(ValueError, match="192, 128"):
        flash_prefill(q, k, v96)
    with pytest.raises(ValueError, match="192, 128"):
        flash_prefill_bwd(q, k, v96, do96, do96, lse)


# MLA's training widths, Q/K 192 over V 128 (DeepSeek-V3's non-absorbed
# form): (B, S, Hq, Hkv, dtype) of the chip_smoke micro-step (2 x 1024,
# 128 / 128 heads), S 63 / 64 / 65 at the tiles' edges, a split dK/dV walk
# (1 x 256 at 8 heads: chunks of 2 of the 4 query tiles), a GQA case and
# float32 on the CUDA-core bodies
MLA_FLASH_SHAPES = [(2, 1024, 128, 128, torch.bfloat16),
                    (1, 63, 128, 128, torch.bfloat16),
                    (1, 64, 128, 128, torch.bfloat16),
                    (1, 65, 128, 128, torch.bfloat16),
                    (1, 256, 8, 8, torch.bfloat16),
                    (2, 100, 8, 2, torch.bfloat16),
                    (1, 256, 16, 16, torch.float32),
                    (1, 65, 8, 8, torch.float32)]
MLA_DK, MLA_DV = 192, 128


@pytest.mark.parametrize("b,s,hq,hkv,dtype", MLA_FLASH_SHAPES)
def test_flash_prefill_kernel_mla_widths(cuda, b, s, hq, hkv, dtype):
    """The forward kernel at Q/K 192 over V 128 against the plain
    version (output and lse), one launch, the body by type, and a second
    call equal bit for bit."""
    from repro_torch.kernels.flash_prefill import body, flash_prefill
    from repro_torch.kernels.paged_attention import DTYPE_CODES
    assert body(MLA_DK, MLA_DV, DTYPE_CODES[dtype]) == \
        ("wgmma" if dtype == torch.bfloat16 else "cuda_core")
    g = torch.Generator(device="cuda").manual_seed(s)

    def rn(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(dtype)
    args = (rn(b, s, hq, MLA_DK), rn(b, s, hkv, MLA_DK), rn(b, s, hkv, MLA_DV))
    before = flash_prefill.launches
    out, lse = flash_prefill(*args, with_lse=True)
    torch.cuda.synchronize()
    assert flash_prefill.launches == before + 1
    plain_out, plain_lse = flash_prefill(*args, backend="torch",
                                         with_lse=True)
    assert out.shape == (b, s, hq, MLA_DV) and out.dtype == dtype
    assert bool(torch.isfinite(out).all())
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    assert _err(out, plain_out) <= tol
    assert _err(lse, plain_lse) <= F32_TOL * float(plain_lse.abs().max())
    assert torch.equal(out, flash_prefill(*args))


@pytest.mark.parametrize("b,s,hq,hkv,dtype", MLA_FLASH_SHAPES)
def test_flash_prefill_bwd_kernel_mla_widths(cuda, b, s, hq, hkv, dtype):
    """dq, dk, dv of the backward at Q/K 192 over V 128 against the
    plain version on the forward kernel's own o and lse, each within
    BWD_RTOL of its largest magnitude; one launch a call, two calls
    equal bit for bit; bf16 on the `wgmma` body (dK and dV split over
    its two consumers), float32 on the CUDA cores."""
    from repro_torch.kernels.flash_prefill import bwd_body, flash_prefill_bwd
    from repro_torch.kernels.paged_attention import DTYPE_CODES
    assert bwd_body(MLA_DK, MLA_DV, DTYPE_CODES[dtype]) == \
        ("wgmma" if dtype == torch.bfloat16 else "cuda_core")
    q, k, v, o, do, lse = bwd_inputs(b, s, hq, hkv, MLA_DK, dtype, seed=s,
                                     dv=MLA_DV)
    before = flash_prefill_bwd.launches
    grads = flash_prefill_bwd(q, k, v, o, do, lse)
    torch.cuda.synchronize()
    assert flash_prefill_bwd.launches == before + 1
    plain = flash_prefill_bwd(q, k, v, o, do, backend="torch")
    for got, want, t in zip(grads, plain, (q, k, v)):
        assert got.shape == t.shape and got.dtype == dtype
        assert bool(torch.isfinite(got).all())
        assert _err(got, want) <= BWD_RTOL[dtype] * max(
            1.0, float(want.float().abs().max()))
    again = flash_prefill_bwd(q, k, v, o, do, lse)
    assert all(torch.equal(a, c) for a, c in zip(grads, again))


def test_flash_causal_mla_gradient_on_card_matches_cpu(cuda):
    """float32 FlashCausal at Q/K 192 over V 128 on the card against the
    same function on the CPU, through a loss that reaches every output."""
    rs = np.random.RandomState(4)
    b, s, h = 1, 70, 4
    host = [torch.from_numpy(rs.standard_normal(shape).astype(np.float32))
            for shape in ((b, s, h, MLA_DK), (b, s, h, MLA_DK),
                          (b, s, h, MLA_DV), (b, s, h, MLA_DV))]
    grads = {}
    for dev in ("cpu", "cuda"):
        q, k, v = (t.detach().to(dev).requires_grad_(True)
                   for t in host[:3])
        (cuda.flash_causal(q, k, v) * host[3].to(dev)).sum().backward()
        grads[dev] = [t.grad.cpu() for t in (q, k, v)]
    for a, c in zip(grads["cuda"], grads["cpu"]):
        assert _err(a, c) <= F32_TOL * float(c.abs().max())


# The warp-specialised bodies (``flash_prefill_wg``; ``bwd_dkdv_wg``,
# ``bwd_dkdv_pair_wg``, ``bwd_dq_wg``): bf16 at every width pair they
# take, S at their 128-row tiles' edges (1, 127 / 128 / 129, a ragged
# 100 and 1000), G = Hq / Hkv of 1, 4 and 16 (glm4's) at 16 query heads
WG_PAIRS = [(64, 64), (128, 128), (192, 128)]
WG_S = [1, 100, 127, 128, 129, 1000]
WG_G = [1, 4, 16]


def _wg_inputs(b, s, g, dk, dv, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def rn(*shape):
        return torch.randn(shape, generator=gen,
                           device="cuda").to(torch.bfloat16)
    hq = 16
    return rn(b, s, hq, dk), rn(b, s, hq // g, dk), rn(b, s, hq // g, dv)


@pytest.mark.parametrize("with_lse", [False, True])
@pytest.mark.parametrize("g", WG_G)
@pytest.mark.parametrize("s", WG_S)
@pytest.mark.parametrize("dk,dv", WG_PAIRS)
def test_flash_prefill_wg_body(cuda, dk, dv, s, g, with_lse):
    """The forward's `wgmma` body against the plain version: the output
    within one bf16 step (BF16_TOL), the lse within F32_TOL of its
    largest magnitude, one launch, and the body the C entry names."""
    from repro_torch.kernels.flash_prefill import body, flash_prefill
    assert body(dk, dv, 1) == "wgmma"
    q, k, v = _wg_inputs(2, s, g, dk, dv, seed=s + g)
    before = flash_prefill.launches
    got = flash_prefill(q, k, v, with_lse=with_lse)
    torch.cuda.synchronize()
    assert flash_prefill.launches == before + 1
    out = got[0] if with_lse else got
    assert out.shape == (2, s, 16, dv) and bool(torch.isfinite(out).all())
    assert _err(out, flash_prefill(q, k, v, backend="torch")) <= BF16_TOL
    if with_lse:
        from repro_torch.kernels import ref
        plain = ref.flash_prefill_lse(q, k)
        assert _err(got[1], plain) <= F32_TOL * float(plain.abs().max())


@pytest.mark.parametrize("g", WG_G)
@pytest.mark.parametrize("s", WG_S)
@pytest.mark.parametrize("dk,dv", WG_PAIRS)
def test_flash_prefill_bwd_wg_body(cuda, dk, dv, s, g):
    """The backward's `wgmma` body (dK/dV whole or split into partials by
    ``bwd_kv_chunk``, dQ) against the plain version on the forward
    kernel's o and lse, each gradient within BWD_RTOL of its largest
    magnitude; run twice, equal bit for bit."""
    from repro_torch.kernels.flash_prefill import bwd_body, flash_prefill_bwd
    assert bwd_body(dk, dv, 1) == "wgmma"
    q, k, v, o, do, lse = bwd_inputs(2, s, 16, 16 // g, dk, torch.bfloat16,
                                     seed=s + g, dv=dv)
    grads = flash_prefill_bwd(q, k, v, o, do, lse)
    torch.cuda.synchronize()
    plain = flash_prefill_bwd(q, k, v, o, do, backend="torch")
    for got, want, t in zip(grads, plain, (q, k, v)):
        assert got.shape == t.shape and bool(torch.isfinite(got).all())
        assert _err(got, want) <= BWD_RTOL[torch.bfloat16] * max(
            1.0, float(want.float().abs().max()))
    again = flash_prefill_bwd(q, k, v, o, do, lse)
    assert all(torch.equal(a, c) for a, c in zip(grads, again))


def test_flash_wg_bodies_take_unaligned_views(cuda):
    """TMA reads from 16-byte aligned bases: a contiguous view at an odd
    offset is copied by the wrappers, and the result is unchanged."""
    from repro_torch.kernels.flash_prefill import (flash_prefill,
                                                   flash_prefill_bwd)
    q, k, v = _wg_inputs(1, 70, 4, 64, 64, seed=1)
    flat = torch.cat([q.new_zeros(1), q.flatten()])[1:]
    q1 = flat.view(q.shape)
    assert q1.data_ptr() % 16 != 0 and q1.is_contiguous()
    out, lse = flash_prefill(q1, k, v, with_lse=True)
    assert torch.equal(out, flash_prefill(q, k, v))
    do = torch.randn_like(out)
    assert all(torch.equal(a, b) for a, b in zip(
        flash_prefill_bwd(q1, k, v, out, do, lse),
        flash_prefill_bwd(q, k, v, out, do, lse)))


def test_bwd_kv_tile_matches_c_entry(cuda):
    """The wrapper's split plan reads the dK/dV kernel's key tile from
    ``bwd_kv_tile``; the C entry must name the same."""
    import ctypes

    from repro_torch.kernels import build
    from repro_torch.kernels.flash_prefill import BWD_WIDTHS, bwd_kv_tile
    fn = build.entry("flash_prefill_bwd", "flash_prefill_bwd_kv_tile",
                     [ctypes.c_int] * 3)
    for dk, dv in BWD_WIDTHS:
        for code in (0, 1):
            assert fn(dk, dv, code) == bwd_kv_tile(dk, dv, code)


def _int8_inputs(b, hq, hkv, hd, page, pages, seed=0):
    from repro_torch.models.attention import quantize_kv
    g = torch.Generator(device="cuda").manual_seed(seed)
    n = b * pages + 2
    kq, ks = quantize_kv(torch.randn((n, page, hkv, hd), generator=g,
                                     device="cuda"))
    vq, vs = quantize_kv(torch.randn((n, page, hkv, hd), generator=g,
                                     device="cuda"))
    tables = (torch.randperm(n - 1, generator=g, device="cuda")[:b * pages]
              + 1).reshape(b, pages).to(torch.int32)
    q = torch.randn((b, hq, hd), generator=g, device="cuda")
    return q, kq, vq, ks, vs, tables


# (Hq, Hkv, hd, page, pages): 6-page tables (the `mma.sync` int8 body),
# then the Hopper body's gate (hd 64 / 128, windows of 512 - 4096 tokens):
# llama3.2-1b's heads over 64-token pages, G 4 over 16-token pages, G 16
# at hd 128 over 32-token pages, the VLM's heads over a 4096-token window
INT8_KERNEL_CASES = [(32, 8, 64, 64, 6), (8, 2, 64, 16, 6), (4, 4, 32, 32, 6),
                     (8, 1, 128, 16, 6), (32, 8, 64, 64, 8),
                     (8, 2, 64, 16, 32), (16, 1, 128, 32, 16),
                     (32, 8, 128, 64, 64)]


@pytest.mark.parametrize("dtype,tol", [(torch.float32, F32_TOL),
                                       (torch.bfloat16, BF16_TOL)])
@pytest.mark.parametrize("hq,hkv,hd,page,pages", INT8_KERNEL_CASES)
def test_paged_decode_int8_kernel(cuda, dtype, tol, hq, hkv, hd, page, pages):
    """bf16 q on the int8 Hopper body under its gate (``int8_body`` names
    it), else on the int8 `mma.sync` body, float32 q on the CUDA-core
    body: against the plain version, one launch a call, finite, and two
    calls equal bit for bit."""
    from repro_torch.kernels import paged_attention as pa
    q, kq, vq, ks, vs, tables = _int8_inputs(5, hq, hkv, hd, page, pages)
    lengths = torch.tensor([0, 1, 17, pages * page, 50], dtype=torch.int32,
                           device="cuda")
    tables[1, 3] = 999                          # clamped, past the length
    args = (q.to(dtype), kq, vq, ks, vs, tables, lengths)
    want = "cuda_core" if dtype == torch.float32 else (
        "hopper" if pages * page >= 512 else "tensor_core")
    assert pa.int8_body(hq, hkv, hd, page, pages,
                        pa.DTYPE_CODES[dtype]) == want
    before = cuda.paged_decode_attention_int8.launches
    out = cuda.paged_decode_int8(*args)
    torch.cuda.synchronize()
    assert cuda.paged_decode_attention_int8.launches == before + 1
    assert bool(torch.isfinite(out).all())
    assert _err(out, cuda.paged_decode_int8(*args, backend="torch")) <= tol
    assert bool((out[0] == 0).all())            # length 0 -> zeros
    assert torch.equal(out, cuda.paged_decode_int8(*args))


def _int8_long_rows(hq, hkv, hd, page, seed):
    """64 rows over 512-token int8 tables at llama3.2-1b width, clamped
    table entries inside the length, lengths at the tile edges."""
    b, pages = 64, 512 // page
    q, kq, vq, ks, vs, tables = _int8_inputs(b, hq, hkv, hd, page, pages,
                                             seed=seed)
    n = kq.shape[0]
    tables[-2, 0] = n + 40                      # clamps to page n - 1
    tables[-1, 1] = -3                          # clamps to page 0
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    lengths = torch.randint(1, 513, (b,), generator=g,
                            device="cuda").to(torch.int32)
    lengths[:len(EDGE_LENGTHS)] = torch.tensor(EDGE_LENGTHS)
    lengths[-2:] = 512
    return q.bfloat16(), kq, vq, ks, vs, tables, lengths


@pytest.mark.parametrize("full", [True, False])
@pytest.mark.parametrize("page", [64, 16, 32])
def test_paged_decode_int8_kernel_long_rows(cuda, page, full):
    """The int8 Hopper body at llama3.2-1b width (64 rows over 512-token
    tables: one split a row): every row full, or ragged lengths at its
    chunk, tile and warp edges."""
    q, kq, vq, ks, vs, tables, lengths = _int8_long_rows(32, 8, 64, page,
                                                         seed=12)
    if full:
        lengths.fill_(512)
    args = (q, kq, vq, ks, vs, tables, lengths)
    before = cuda.paged_decode_attention_int8.launches
    out = cuda.paged_decode_int8(*args)
    torch.cuda.synchronize()
    assert cuda.paged_decode_attention_int8.launches == before + 1
    assert bool(torch.isfinite(out).all())
    if not full:
        assert bool((out[0] == 0).all())        # length 0 -> zeros
    assert _err(out, cuda.paged_decode_int8(*args, backend="torch")) \
        <= BF16_TOL
    assert torch.equal(out, cuda.paged_decode_int8(*args))


def _int8_path_rows(seed):
    """The int8_decode path's shape: 4 rows of 392 / 264 / 456 / 108
    tokens over 512-token tables of 64-token pages (4 splits of 2 tiles,
    4 / 3 / 4 / 1 of them live), a clamped entry inside row 0's length."""
    q, kq, vq, ks, vs, tables = _int8_inputs(4, 32, 8, 64, 64, 8, seed=seed)
    tables[0, 2] = -1                           # clamps to page 0
    lengths = torch.tensor([392, 264, 456, 108], dtype=torch.int32,
                           device="cuda")
    return q.bfloat16(), kq, vq, ks, vs, tables, lengths


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_paged_decode_int8_ignores_stale_slots(cuda, dtype):
    """Slots at or past each row's length that hold int8 +-127 and inf /
    NaN scales (K 127 / V -127 with an inf K and a NaN V scale, then the
    signs and the scales swapped) leave the output and the log-sum-exp bit
    for bit as with clean slots and finite: a scale past the length is
    never loaded (bf16: the Hopper body at llama3.2-1b width and at the
    int8_decode path's split shape; float32: the CUDA-core body)."""
    for inputs in (_int8_long_rows(32, 8, 64, 16, seed=13),
                   _int8_path_rows(seed=14)):
        q, kq, vq, ks, vs, tables, lengths = inputs
        args = (q.to(dtype), kq, vq, ks, vs, tables, lengths)
        clean = cuda.paged_decode_int8(*args, with_lse=True)
        page = kq.shape[1]
        pos = torch.arange(tables.shape[1] * page, device="cuda")
        pid = tables.long().clamp(0, kq.shape[0] - 1)[:, pos // page]
        stale = pos[None, :] >= lengths.long()[:, None]
        slots = (pid * page + pos % page)[stale]
        # slots past one row's length that another row reads stay clean
        live = (pid * page + pos % page)[~stale]
        slots = slots[~torch.isin(slots, live)]
        assert slots.numel() > 0
        for bads in ((127, -127, float("inf"), float("nan")),
                     (-127, 127, float("nan"), float("inf"))):
            dirty = []
            for t, bad in zip((kq, vq, ks, vs), bads):
                t = t.clone()
                t.view(-1, *t.shape[2:])[slots] = bad
                dirty.append(t)
            out, lse = cuda.paged_decode_int8(args[0], *dirty, tables,
                                              lengths, with_lse=True)
            torch.cuda.synchronize()
            assert bool(torch.isfinite(out).all())
            assert torch.equal(out, clean[0]) and torch.equal(lse, clean[1])


def test_paged_decode_int8_wg_query_outside_f16(cuda):
    """The int8 Hopper body scores in f16 only where every query value of
    a (row, KV head) is exact in f16: rows 0 and 1 of the path's shape
    hold one value past f16's range (2^17) and one below its normal range
    (2^-20), so their blocks score in bf16, rows 2 and 3 in f16; each
    against the plain version, finite, twice bit for bit."""
    from repro_torch.kernels import paged_attention as pa
    q, kq, vq, ks, vs, tables, lengths = _int8_path_rows(seed=23)
    q[0, 5, 7] = 2.0 ** 17
    q[1, 30, 60] = 2.0 ** -20
    args = (q, kq, vq, ks, vs, tables, lengths)
    assert pa.int8_body(32, 8, 64, 64, 8, 1) == "hopper"
    out = cuda.paged_decode_int8(*args)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(out).all())
    assert _err(out, cuda.paged_decode_int8(*args, backend="torch")) \
        <= BF16_TOL
    assert torch.equal(out, cuda.paged_decode_int8(*args))


# (Hq, Hkv, hd, page, pages, B): the int8 Hopper body's split plans:
# llama3.2-1b's heads over 64- and 16-token pages, G 16 at hd 128
# over 32-token pages (each over a 512-token window), and a 4096-token
# window (splits of up to 64 tiles: the ring reused)
INT8_WG_CASES = [(32, 8, 64, 64, 8, 4), (32, 8, 64, 16, 32, 5),
                 (16, 1, 128, 32, 16, 6), (32, 8, 64, 64, 64, 3)]


@pytest.mark.parametrize("hq,hkv,hd,page,pages,b", INT8_WG_CASES)
def test_paged_decode_int8_wg_plans(cuda, hq, hkv, hd, page, pages, b):
    """The int8 Hopper body at lengths on the chunk, tile and split edges
    (and the path's 4 rows): plans of 1, 2, 4 and 8 tiles a split agree
    with the plain version, each twice bit for bit, with the default
    launch's log-sum-exp against ``ref.paged_decode_lse``; a plan of too
    many splits or one that does not cover the window is refused."""
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import ref
    if b == 4:
        args = _int8_path_rows(seed=21)
    else:
        q, kq, vq, ks, vs, tables = _int8_inputs(b, hq, hkv, hd, page, pages,
                                                 seed=22)
        window = pages * page
        span = pa.decode_split_plan(b, hq, hkv, hd, page, pages).tiles * 64
        edges = [min(e, window) for e in (0, 1, 16, 17, 63, 64, 65, span,
                                          span + 1, window)]
        lengths = torch.tensor((edges * 2)[:b], dtype=torch.int32,
                               device="cuda")
        lengths[-1] = window
        tables[-1, 0] = -3                      # clamps to page 0
        args = (q.bfloat16(), kq, vq, ks, vs, tables, lengths)
    assert pa.int8_body(hq, hkv, hd, page, pages, 1) == "hopper"
    plain = cuda.paged_decode_int8(*args, backend="torch")
    out, lse = cuda.paged_decode_int8(*args, with_lse=True)
    torch.cuda.synchronize()
    assert _err(out, plain) <= BF16_TOL
    q, kq, _, ks, _, tables, lengths = args
    assert _err(lse, ref.paged_decode_lse(q, kq, tables, lengths, ks)) \
        <= LSE_ATOL
    plan = pa.decode_split_plan(b, hq, hkv, hd, page, pages)
    n_tiles = -(-pages * page // 64)
    for tiles in (1, 2, 4, 8):
        other = plan._replace(tiles=tiles, splits=-(-n_tiles // tiles))
        if other.splits > pa.MAX_SPLITS:
            with pytest.raises(RuntimeError, match="CUDA error"):
                pa._launch_int8(*args, None, plan=other)
            continue
        got = pa._launch_int8(*args, None, plan=other)
        torch.cuda.synchronize()
        assert _err(got, plain) <= BF16_TOL, tiles
        assert torch.equal(got, pa._launch_int8(*args, None, plan=other))
    short = plan._replace(splits=plan.splits - 1)
    if short.splits >= 1:
        with pytest.raises(RuntimeError, match="CUDA error"):
            pa._launch_int8(*args, None, plan=short)


def test_dense_decode_on_slot_pages_matches_plain(cuda):
    """llama3.2-1b width: 64 slots of 512 tokens seen as 64-token pages
    through ``attention.decode_attention``, bf16 and int8."""
    from repro_torch.models import attention as attn
    g = torch.Generator(device="cuda").manual_seed(3)
    b, s, hq, hkv, hd = 64, 512, 32, 8, 64
    k = torch.randn((b, s, hkv, hd), generator=g, device="cuda")
    v = torch.randn((b, s, hkv, hd), generator=g, device="cuda")
    q = torch.randn((b, 1, hq, hd), generator=g,
                    device="cuda").to(torch.bfloat16)
    lengths = torch.randint(1, s + 1, (b,), generator=g,
                            device="cuda").to(torch.int32)
    lengths[::7] = 0
    (kq, ks), (vq, vs) = attn.quantize_kv(k), attn.quantize_kv(v)
    for caches in ((k.bfloat16(), v.bfloat16()), (kq, vq, ks, vs)):
        kc, vc, *scales = caches
        out = attn.decode_attention(q, kc, vc, lengths, *scales)
        plain = attn.decode_attention(q, kc, vc, lengths, *scales,
                                      backend="torch")
        assert _err(out, plain) <= BF16_TOL


def _mla_inputs(dtype, b=3, c=8, hq=8, dl=32, dr=8, page=16, pages=5,
                seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rn(*s):
        return torch.randn(s, generator=g, device="cuda").to(dtype)
    n = b * pages + 2
    tables = (torch.randperm(n - 1, generator=g, device="cuda")[:b * pages]
              + 1).reshape(b, pages).to(torch.int32)
    return dict(ql=rn(b, c, hq, dl), qr=rn(b, c, hq, dr),
                lc=rn(b, c, dl + dr), lp=rn(n, page, dl + dr), tables=tables)


# (Hq, dl, dr): the reduced test width, a head count that is not a
# multiple of the kernels' 32-head tile, and DeepSeek-V3's full width
MLA_WIDTHS = [(4, 32, 8), (40, 96, 16), (128, 512, 64)]


@pytest.mark.parametrize("dtype,tol", [(torch.float32, F32_TOL),
                                       (torch.bfloat16, BF16_TOL)])
@pytest.mark.parametrize("hq,dl,dr", MLA_WIDTHS)
@pytest.mark.parametrize("scale", [None, 0.07])
def test_mla_decode_kernel(cuda, dtype, tol, hq, dl, dr, scale):
    a = _mla_inputs(dtype, hq=hq, dl=dl, dr=dr)
    lengths = torch.tensor([0, 17, 80], dtype=torch.int32, device="cuda")
    tables = a["tables"].clone()
    tables[1, 3] = 999                          # clamped, past the length
    args = (a["ql"][:, 0].contiguous(), a["qr"][:, 0].contiguous(), a["lp"],
            tables, lengths)
    before = cuda.mla_paged_decode.launches
    out = cuda.mla_decode(*args, d_latent=dl, scale=scale)
    torch.cuda.synchronize()
    plain = cuda.mla_decode(*args, d_latent=dl, scale=scale, backend="torch")
    assert _err(out, plain) <= tol
    assert bool((out[0] == 0).all())            # length 0 -> zeros
    assert cuda.mla_paged_decode.launches == before + 1


# lengths at the MLA decode's tile (32 keys; the `wgmma` body's page, 64)
# and split (256 tokens until the `wgmma` body's 512; 1024 and 2048 are
# edges of both) edges, a row of length 0 and one in the middle of a split
SPLIT_LENGTHS = [0, 1, 31, 32, 33, 255, 256, 257, 700, 1023, 1024, 2047,
                 2048]


@pytest.mark.parametrize("b,full", [(56, False), (8, True)])
def test_mla_decode_kernel_split_walk(cuda, b, full):
    """DeepSeek-V3 width, bf16, 2048-token tables: the split key walk and
    its combine against the plain version, at lengths crossing the split
    and tile edges (56 rows) and on 8 full rows, with clamped table
    entries inside the length; one launch a call, zeros for length 0, and
    two calls equal bit for bit."""
    from repro_torch.kernels import mla_paged_decode as mpd
    hq, dl, dr, page, pages = 128, 512, 64, 64, 32
    assert mpd.decode_split_tokens(pages * page) == 512
    g = torch.Generator(device="cuda").manual_seed(12)
    n = b * pages + 2
    lp = torch.randn((n, page, dl + dr), generator=g,
                     device="cuda").bfloat16()
    tables = (torch.randperm(n - 1, generator=g, device="cuda")[:b * pages]
              + 1).reshape(b, pages).to(torch.int32)
    tables[-2, 5] = n + 7                       # clamps to page n - 1
    tables[-1, 0] = -1                          # clamps to page 0
    if full:
        lengths = torch.full((b,), pages * page, dtype=torch.int32,
                             device="cuda")
    else:
        lengths = torch.randint(1, pages * page + 1, (b,), generator=g,
                                device="cuda").to(torch.int32)
        lengths[:len(SPLIT_LENGTHS)] = torch.tensor(SPLIT_LENGTHS)
        lengths[-2:] = pages * page
    args = (torch.randn((b, hq, dl), generator=g, device="cuda").bfloat16(),
            torch.randn((b, hq, dr), generator=g, device="cuda").bfloat16(),
            lp, tables, lengths)
    scale = 1.0 / (128 + dr) ** 0.5            # the engine's scale
    before = cuda.mla_paged_decode.launches
    out = cuda.mla_decode(*args, d_latent=dl, scale=scale)
    torch.cuda.synchronize()
    assert cuda.mla_paged_decode.launches == before + 1
    assert bool(torch.isfinite(out).all())
    plain = cuda.mla_decode(*args, d_latent=dl, scale=scale, backend="torch")
    assert _err(out, plain) <= BF16_TOL
    if not full:
        assert bool((out[0] == 0).all())        # length 0 -> zeros
    assert torch.equal(out, cuda.mla_decode(*args, d_latent=dl, scale=scale))


# (Hq, dl, dr, page, pages, C, offsets) of the prefill cases: each width
# of MLA_WIDTHS at 16-token pages, then DeepSeek-V3's width at 64-token
# pages with pool windows that are not a multiple of the 32-key tile
# (45, 120) and a chunk that crosses a page boundary (120 .. 135)
MLA_PREFILL_CASES = [w + (16, 5, 8, (0, 5, 40)) for w in MLA_WIDTHS] + [
    (128, 512, 64, 64, 3, 16, (0, 45, 120))]


@pytest.mark.parametrize("dtype,tol", [(torch.float32, F32_TOL),
                                       (torch.bfloat16, BF16_TOL)])
@pytest.mark.parametrize("hq,dl,dr,page,pages,c,offs", MLA_PREFILL_CASES)
def test_mla_prefill_kernel(cuda, dtype, tol, hq, dl, dr, page, pages, c,
                            offs):
    a = _mla_inputs(dtype, c=c, hq=hq, dl=dl, dr=dr, page=page, pages=pages)
    offs = torch.tensor(offs, dtype=torch.int32, device="cuda")
    args = (a["ql"], a["qr"], a["lc"], a["lp"], a["tables"], offs)
    out = cuda.mla_prefill(*args, d_latent=dl)
    plain = cuda.mla_prefill(*args, d_latent=dl, backend="torch")
    assert _err(out, plain) <= tol


# (Hq, dl, dr, page, pages, C, rows of chunk positions) of the segment
# cases: each width at 16-token pages, then DeepSeek-V3's width at
# 64-token pages: a gap chunk with a ragged pool window, a contiguous
# chunk across the page boundary at 128, and a row of padding only
MLA_SEG_CASES = [w + (16, 5, 8, ([3, 4, 5, 20, 21, 22, 23],
                                  list(range(30, 38)), []))
                 for w in MLA_WIDTHS] + [
    (128, 512, 64, 64, 3, 16, (list(range(45, 53)) + list(range(100, 107)),
                               list(range(120, 136)), []))]


@pytest.mark.parametrize("dtype,tol", [(torch.float32, F32_TOL),
                                       (torch.bfloat16, BF16_TOL)])
@pytest.mark.parametrize("hq,dl,dr,page,pages,c,rows", MLA_SEG_CASES)
def test_mla_prefill_seg_kernel(cuda, dtype, tol, hq, dl, dr, page, pages,
                                c, rows):
    a = _mla_inputs(dtype, c=c, hq=hq, dl=dl, dr=dr, page=page, pages=pages)
    cpos = torch.tensor([r + [-1] * (c - len(r)) for r in rows],
                        dtype=torch.int32, device="cuda")
    args = (a["ql"], a["qr"], a["lc"], a["lp"], a["tables"], cpos)
    out = cuda.mla_prefill_seg(*args, d_latent=dl)
    plain = cuda.mla_prefill_seg(*args, d_latent=dl, backend="torch")
    assert _err(out, plain) <= tol


@pytest.mark.parametrize("hq,dl,dr", [(128, 512, 64), (40, 96, 16),
                                      (4, 32, 8)])
@pytest.mark.parametrize("c", [8, 64, 100])
def test_mla_seg_kernel_contiguous_equals_offset_bitwise(cuda, hq, dl, dr,
                                                         c):
    """C 64 and 100 walk one and two chunk tiles of the `wgmma` body at
    DeepSeek-V3's widths (the `mma.sync` body at the others)."""
    a = _mla_inputs(torch.bfloat16, c=c, hq=hq, dl=dl, dr=dr, page=64,
                    pages=3)
    offs = [0, 37, 120]
    cpos = torch.tensor([[o + i for i in range(c)] for o in offs],
                        dtype=torch.int32, device="cuda")
    base = (a["ql"], a["qr"], a["lc"], a["lp"], a["tables"])
    seg = cuda.mla_prefill_seg(*base, cpos, d_latent=dl)
    off = cuda.mla_prefill(*base, torch.tensor(offs, dtype=torch.int32,
                                               device="cuda"), d_latent=dl)
    assert torch.equal(seg, off)


# (B, C, offsets, rows of chunk positions) of the MLA chunk prefill's
# `wgmma` body at DeepSeek-V3's widths over 64-token pages: C 8 / 64 / 100
# (two chunk tiles) / 1100 (the monolithic prefill's 18 chunk tiles, at
# offset 0), offsets on and off a page edge, segment rows with two gaps,
# -1 padding and padding only
MLA_WG_CASES = [
    (2, 8, (0, 37), ([30, 31, 32, 100, 101, 102], [])),
    (1, 64, (1024,), (list(range(480, 512)) + list(range(1536, 1568)),)),
    (2, 100, (63, 64), (list(range(5, 60)) + list(range(130, 175)),
                        list(range(37, 117)))),
    (1, 1100, (0,), (list(range(0, 500)) + list(range(1200, 1800)),)),
]


def _mla_wg_inputs(b, c, seed, pages=32):
    """DeepSeek-V3 widths, bf16, a 2048-token window of 64-token pages
    (one clamped entry a row, inside the walk)."""
    hq, dl, dr = 128, 512, 64
    a = _mla_inputs(torch.bfloat16, b=b, c=c, hq=hq, dl=dl, dr=dr, page=64,
                    pages=pages, seed=seed)
    n = a["lp"].shape[0]
    a["tables"][0, 2] = n + 9                   # clamps to page n - 1
    a["tables"][-1, 0] = -3                     # clamps to page 0
    return a, dl, 1.0 / (128 + dr) ** 0.5


@pytest.mark.parametrize("b,c,offs,rows", MLA_WG_CASES)
def test_mla_prefill_wg_kernel(cuda, b, c, offs, rows):
    """Both entries on the `wgmma` body against their plain versions, one
    launch a call, finite outputs, equal bit for bit twice."""
    from repro_torch.kernels import paged_prefill as pp
    assert pp.mla_body(512, 64, c, 64, 1, 1) == "wgmma"
    a, dl, scale = _mla_wg_inputs(b, c, seed=c)
    base = (a["ql"], a["qr"], a["lc"], a["lp"], a["tables"])
    offs = torch.tensor(offs, dtype=torch.int32, device="cuda")
    cpos = torch.tensor([r + [-1] * (c - len(r)) for r in rows],
                        dtype=torch.int32, device="cuda")
    for fn, where, count in ((cuda.mla_prefill, offs,
                              cuda.mla_paged_prefill),
                             (cuda.mla_prefill_seg, cpos,
                              cuda.mla_paged_prefill_segments)):
        before = count.launches
        out = fn(*base, where, d_latent=dl, scale=scale)
        torch.cuda.synchronize()
        assert count.launches == before + 1
        assert bool(torch.isfinite(out).all())
        plain = fn(*base, where, d_latent=dl, scale=scale, backend="torch")
        assert _err(out, plain) <= BF16_TOL
        assert torch.equal(out, fn(*base, where, d_latent=dl, scale=scale))


@pytest.mark.parametrize("longest_first", [0, 1])
def test_mla_prefill_wg_launch_orders_agree(cuda, longest_first):
    """Either launch order of the `wgmma` body's grid gives the default's
    output bit for bit (C 1100 at offset 0, and the segment entry)."""
    from repro_torch.kernels import paged_prefill as pp
    a, dl, scale = _mla_wg_inputs(1, 1100, seed=5)
    args = [a["ql"], a["qr"], a["lc"], a["lp"], a["tables"]]
    offs = torch.zeros((1,), dtype=torch.int32, device="cuda")
    cpos = torch.arange(300, 1400, dtype=torch.int32, device="cuda")[None]
    for entry, fn, where in (("mla_paged_prefill", cuda.mla_prefill, offs),
                             ("mla_paged_prefill_seg", cuda.mla_prefill_seg,
                              cpos)):
        want = fn(*args, where, d_latent=dl, scale=scale)
        got = pp._launch_mla(entry, *args, where, dl, scale,
                             longest_first=longest_first)
        assert torch.equal(got, want)


def test_mla_prefill_wg_ignores_unread_slots(cuda):
    """inf / NaN in every pool slot no query may read (past the offset,
    a segment chunk's own slots and the slots past its last position,
    table pages past the walk) and in the memory past the chunk latent's
    last row: both entries' outputs equal the clean pool's bit for bit
    and are finite."""
    b, c = 2, 100
    a, dl, scale = _mla_wg_inputs(b, c, seed=21, pages=8)
    window = a["tables"].shape[1] * 64
    offs = torch.tensor([70, 0], dtype=torch.int32, device="cuda")
    rows = [list(range(10, 60)) + list(range(300, 350)),
            list(range(3, 103))]
    cpos = torch.tensor(rows, dtype=torch.int32, device="cuda")
    pos = torch.arange(window, device="cuda")
    tables = torch.arange(1, b * 8 + 1, dtype=torch.int32,
                          device="cuda").reshape(b, 8)   # no shared page
    # the chunk latent inside a longer buffer whose tail is NaN
    buf = torch.full((b * c + 64, dl + 64), float("nan"), device="cuda",
                     dtype=torch.bfloat16)
    buf[:b * c] = a["lc"].reshape(b * c, -1)
    lc = buf[:b * c].view(b, c, -1)
    for fn, where in ((cuda.mla_prefill, offs),
                      (cuda.mla_prefill_seg, cpos)):
        if where is offs:
            unread = pos[None] >= offs.long()[:, None]
        else:
            cp = cpos.long()
            own = (pos[None, :, None] == cp[:, None, :]).any(-1)
            unread = own | (pos[None] >= cp.max(-1).values[:, None])
        dirty = a["lp"].clone()
        for row in range(b):
            slots = torch.nonzero(unread[row]).flatten()
            vals = torch.where(slots % 2 == 1, float("nan"), float("inf"))
            dirty[tables[row, slots // 64].long(), slots % 64] = \
                vals.to(dirty.dtype)[:, None]
        base = (a["ql"], a["qr"], lc)
        clean = fn(*base, a["lp"], tables, where, d_latent=dl, scale=scale)
        out = fn(*base, dirty, tables, where, d_latent=dl, scale=scale)
        assert bool(torch.isfinite(out).all())
        assert torch.equal(out, clean)
        plain = fn(*base, a["lp"], tables, where, d_latent=dl, scale=scale,
                   backend="torch")
        assert _err(out, plain) <= BF16_TOL


def test_tensor_core_dispatch(cuda):
    """The C entries choose a body by type and width (and the GQA chunk
    prefill by page size too): bf16 flash prefill
    at hd 16-128 and (192, 128) and its backward at hd 16, 64, 128 and
    (192, 128) (the `wgmma` bodies at 64, 128 and (192, 128), `mma.sync`
    below), bf16 MLA chunk prefill and MLA decode at every width
    above and bf16 GQA decode and GQA chunk / segment prefill at hd
    16-128 with up to 16 query heads a KV head run on the tensor cores,
    and so does the int8 GQA decode with a bf16 query at those widths;
    float32 (the float32 engine tests), a float32 query over a bf16 or
    int8 pool, flash hd 256 and the GQA kernels at other widths keep the
    CUDA-core bodies."""
    import ctypes

    from repro_torch.kernels import build
    flash = build.entry("flash_prefill", "flash_prefill_tensor_core",
                        [ctypes.c_int] * 3)
    # 2: the `wgmma` body, 1: the `mma.sync` body, 0: the CUDA cores
    assert [flash(hd, hd, 1) for hd in (16, 32, 64, 128, 256)] == \
        [1, 1, 2, 2, 0]
    assert flash(192, 128, 1) == 2 and flash(192, 128, 0) == 0
    assert [flash(hd, hd, 0) for hd in (16, 32, 64, 128, 256)] == [0] * 5
    bwd = build.entry("flash_prefill_bwd", "flash_prefill_bwd_tensor_core",
                      [ctypes.c_int] * 3)
    assert [bwd(hd, hd, 1) for hd in (16, 32, 64, 128, 256)] == \
        [1, 0, 2, 2, 0]
    assert bwd(192, 128, 1) == 2 and bwd(192, 128, 0) == 0
    assert [bwd(hd, hd, 0) for hd in (32, 64, 128, 256)] == [0] * 4
    # the MLA chunk prefill's body: `wgmma` at dl 512, dr 64 over 64-token
    # pages, `mma.sync` at the other widths and pages
    mla = build.entry("mla_paged_prefill", "mla_paged_prefill_tensor_core",
                      [ctypes.c_int] * 6)
    for _, dl, dr in MLA_WIDTHS:
        for n_cp in (0, 8, 64, 1100):
            for page in (16, 32, 64):
                want = 2 if (dl, dr, page) == (512, 64, 64) else 1
                assert mla(dl, dr, n_cp, page, 1, 1) == want
                assert mla(dl, dr, n_cp, page, 0, 1) == 0
                assert mla(dl, dr, n_cp, page, 0, 0) == 0
    from repro_torch.kernels import paged_prefill as pp
    assert pp.mla_body(512, 64, 64, 64, 1, 1) == "wgmma"
    assert pp.mla_body(512, 64, 0, 1, 1, 1) == "tensor_core"
    mla_dec = build.entry("mla_paged_decode", "mla_paged_decode_tensor_core",
                          [ctypes.c_int] * 4)
    for _, dl, dr in MLA_WIDTHS:
        assert mla_dec(dl, dr, 1, 1) == 1
        assert mla_dec(dl, dr, 0, 1) == 0
        assert mla_dec(dl, dr, 0, 0) == 0
    assert mla_dec(640, 64, 1, 1) == 0          # past 512 latent columns
    gqa = build.entry("paged_decode", "paged_decode_tensor_core",
                      [ctypes.c_int] * 5)
    for hq, hkv, hd in [(32, 8, 64), (8, 2, 64), (4, 4, 32), (8, 1, 128),
                        (16, 1, 16), (32, 8, 128), (6, 6, 64)]:
        assert gqa(hq, hkv, hd, 1, 1) == 1
        assert gqa(hq, hkv, hd, 0, 1) == 0
        assert gqa(hq, hkv, hd, 0, 0) == 0
    assert gqa(32, 1, 64, 1, 1) == 0            # 32 query heads a KV head
    assert gqa(8, 2, 256, 1, 1) == 0            # hd 256
    # the GQA chunk prefill's body: `wgmma` at hd 64 / 128 over pages of
    # 16 / 32 / 64 tokens, `mma.sync` at hd 16 / 32 and at other pages
    from repro_torch.kernels import paged_prefill as pp
    for hq, hkv, hd in [(32, 8, 64), (8, 2, 16), (4, 4, 32), (8, 1, 128),
                        (16, 1, 32)]:
        assert pp.body(hq, hkv, hd, 64, 1, 1) != "cuda_core"
        assert pp.body(hq, hkv, hd, 64, 0, 1) == "cuda_core"
        assert pp.body(hq, hkv, hd, 64, 0, 0) == "cuda_core"
    assert pp.body(32, 1, 64, 64, 1, 1) == "cuda_core"   # 32 heads a KV head
    assert pp.body(8, 2, 256, 64, 1, 1) == "cuda_core"   # hd 256
    for hq, hkv in [(32, 8), (24, 8), (8, 8), (16, 1), (64, 8)]:
        for page in (16, 32, 64):
            assert [pp.body(hq, hkv, hd, page, 1, 1)
                    for hd in (16, 32, 64, 128)] == \
                ["tensor_core", "tensor_core", "wgmma", "wgmma"]
            assert pp.body(hq, hkv, 64, page, 0, 1) == "cuda_core"
            assert pp.body(hq, hkv, 128, page, 0, 0) == "cuda_core"
        for page in (8, 128):
            assert pp.body(hq, hkv, 64, page, 1, 1) == "tensor_core"
    int8 = build.entry("paged_decode", "paged_decode_int8_tensor_core",
                       [ctypes.c_int] * 4)
    for hq, hkv, hd in [(32, 8, 64), (8, 2, 64), (4, 4, 32), (8, 1, 128),
                        (16, 1, 16)]:
        assert int8(hq, hkv, hd, 1) == 1
        assert int8(hq, hkv, hd, 0) == 0
    assert int8(32, 1, 64, 1) == 0              # 32 query heads a KV head
    assert int8(8, 2, 256, 1) == 0              # hd 256
    # the int8 decode's body: 2 the Hopper body (bf16 q at hd 64 / 128,
    # pages of 16 / 32 / 64, windows of 512 - 4096 tokens), 1 the int8
    # `mma.sync` body, 0 the CUDA cores (a float32 query)
    int8_body = build.entry("paged_decode", "paged_decode_int8_body",
                            [ctypes.c_int] * 6)
    for hq, hkv in [(32, 8), (24, 8), (32, 32), (6, 6), (16, 1)]:
        for page in (16, 32, 64):
            p = 512 // page
            assert [int8_body(hq, hkv, hd, page, p, 1)
                    for hd in (16, 32, 64, 128)] == [1, 1, 2, 2]
            assert int8_body(hq, hkv, 64, page, p, 0) == 0
            assert int8_body(hq, hkv, 64, page, 4096 // page, 1) == 2
            assert int8_body(hq, hkv, 64, page, 448 // page, 1) == 1
            assert int8_body(hq, hkv, 64, page, 8192 // page, 1) == 1
        for page in (8, 128):
            assert int8_body(hq, hkv, 64, page, 4096 // page, 1) == 1
    assert int8_body(32, 1, 64, 64, 8, 1) == 0  # 32 query heads a KV head
    from repro_torch.kernels import paged_attention as pa
    assert pa.int8_body(32, 8, 64, 64, 8, 1) == "hopper"
    assert pa.int8_body(32, 8, 64, 64, 7, 1) == "tensor_core"
    assert pa.int8_body(32, 8, 64, 64, 8, 0) == "cuda_core"


def test_mla_kernel_wrappers_reject_bad_inputs(cuda):
    a = _mla_inputs(torch.bfloat16)
    lengths = torch.ones(3, dtype=torch.int32, device="cuda")
    ql, qr = a["ql"][:, 0].contiguous(), a["qr"][:, 0].contiguous()
    with pytest.raises(ValueError, match="contiguous"):
        cuda.mla_decode(a["ql"][:, 0], qr, a["lp"], a["tables"], lengths,
                        d_latent=32)
    with pytest.raises(ValueError, match="widths"):
        cuda.mla_decode(ql, qr, a["lp"], a["tables"], lengths, d_latent=16)
    with pytest.raises(ValueError, match="int32"):
        cuda.mla_decode(ql, qr, a["lp"], a["tables"].long(), lengths,
                        d_latent=32)
    wide = _mla_inputs(torch.bfloat16, dl=640, dr=8)
    with pytest.raises(ValueError, match="d_latent"):
        cuda.mla_decode(wide["ql"][:, 0].contiguous(),
                        wide["qr"][:, 0].contiguous(), wide["lp"],
                        wide["tables"], lengths, d_latent=640)


def test_mla_engine_on_card_matches_cpu_engine(cuda):
    """Reduced DeepSeek-V3: greedy tokens of the engine on the card (CUDA
    MLA kernels) equal the CPU engine's (plain versions), float32."""
    import dataclasses

    from repro_torch.config import reduce_config
    from repro_torch.configs.paper_models import DEEPSEEK_V3
    from repro_torch.models.model import build_model
    from repro_torch.serving import EngineConfig, SamplingParams, \
        ServingEngine
    cfg = dataclasses.replace(reduce_config(DEEPSEEK_V3), kv_block_tokens=32)
    params = build_model(cfg).init_params(0, device="cpu",
                                          dtype=torch.float32)
    rng = np.random.default_rng(8)
    prefix = [int(t) for t in rng.integers(0, 250, size=32)]
    prompts = [prefix + [int(t) for t in rng.integers(0, 250, size=n)]
               for n in (9, 17, 30)]
    outs = {}
    for dev in ("cpu", "cuda"):
        eng = ServingEngine(cfg, EngineConfig(max_len=128, page_tokens=16,
                                              kv_budget_bytes=4e6),
                            params=_to(params, dev), device=dev)
        reqs = [eng.submit(prompts[0], params=SamplingParams(
            max_new_tokens=5))]
        eng.run()
        reqs += [eng.submit(t, params=SamplingParams(max_new_tokens=5))
                 for t in prompts[1:]]
        eng.run()
        assert eng.stats()["cow_share_hits"] > 0
        eng.shutdown()
        outs[dev] = [r.generated for r in reqs]
    assert outs["cuda"] == outs["cpu"]


@pytest.mark.parametrize("flags", [dict(paged=False),
                                   dict(chunked_prefill=False),
                                   dict(fused_step=False)])
def test_ab_engine_on_card_matches_cpu_engine(cuda, flags):
    """The dense, monolithic and unfused paths on the card (flash prefill
    and the paged decode kernels) generate the CPU engine's greedy
    tokens, float32 weights."""
    import dataclasses

    from repro_torch.config import reduce_config
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model
    from repro_torch.serving import EngineConfig, SamplingParams, \
        ServingEngine
    cfg = dataclasses.replace(reduce_config(get_config("llama3.2-1b")),
                              kv_block_tokens=16)
    params = build_model(cfg).init_params(0, device="cpu",
                                          dtype=torch.float32)
    rng = np.random.default_rng(9)
    prefix = [int(t) for t in rng.integers(0, 250, size=32)]
    prompts = [prefix + [int(t) for t in rng.integers(0, 250, size=n)]
               for n in (21, 13, 40)]
    outs = {}
    for dev in ("cpu", "cuda"):
        eng = ServingEngine(cfg, EngineConfig(max_len=128, page_tokens=16,
                                              kv_budget_bytes=4e6, **flags),
                            params=_to(params, dev), device=dev)
        reqs = [eng.submit(prompts[0], params=SamplingParams(
            max_new_tokens=5))]
        eng.run()
        reqs += [eng.submit(t, params=SamplingParams(max_new_tokens=5))
                 for t in prompts[1:]]
        eng.run()
        eng.shutdown()
        outs[dev] = [r.generated for r in reqs]
    assert outs["cuda"] == outs["cpu"]


@pytest.mark.parametrize("arch,flags", [
    ("granite-moe-3b-a800m", {}),
    ("granite-moe-3b-a800m", dict(paged=False)),
    ("deepseek-v3", dict(paged=False)),
    ("deepseek-v3", dict(chunked_prefill=False, fused_step=False))])
def test_moe_and_mla_dense_engine_on_card_matches_cpu_engine(cuda, arch,
                                                             flags):
    """Reduced granite-moe (MoE routing on the card) and reduced
    DeepSeek-V3 on the dense slots and monolithic prefill (the MLA
    kernels over slot pages and at offset 0) generate the CPU engine's
    greedy tokens, float32 weights."""
    import dataclasses

    from repro_torch.config import reduce_config
    from repro_torch.configs import get_config
    from repro_torch.configs.paper_models import DEEPSEEK_V3
    from repro_torch.models.model import build_model
    from repro_torch.serving import EngineConfig, SamplingParams, \
        ServingEngine
    base = DEEPSEEK_V3 if arch == "deepseek-v3" else get_config(arch)
    cfg = dataclasses.replace(reduce_config(base), kv_block_tokens=16)
    params = build_model(cfg).init_params(0, device="cpu",
                                          dtype=torch.float32)
    rng = np.random.default_rng(10)
    prefix = [int(t) for t in rng.integers(0, 250, size=32)]
    prompts = [prefix + [int(t) for t in rng.integers(0, 250, size=n)]
               for n in (21, 13, 40)]
    outs = {}
    for dev in ("cpu", "cuda"):
        eng = ServingEngine(cfg, EngineConfig(max_len=128, page_tokens=16,
                                              kv_budget_bytes=4e6, **flags),
                            params=_to(params, dev), device=dev)
        reqs = [eng.submit(prompts[0], params=SamplingParams(
            max_new_tokens=5))]
        eng.run()
        reqs += [eng.submit(t, params=SamplingParams(max_new_tokens=5))
                 for t in prompts[1:]]
        eng.run()
        eng.shutdown()
        outs[dev] = [r.generated for r in reqs]
    assert outs["cuda"] == outs["cpu"]


def test_mla_prefill_kernel_at_offset_0_whole_prompt(cuda):
    """DeepSeek-V3 width, bf16: a whole ragged prompt of 416 tokens as
    the chunk at offset 0 over a pool of one empty 64-token page (the
    monolithic prefill's call, ``attention.mla_attention_prefill``: the
    `wgmma` body) against the plain version; one launch."""
    hq, dl, dr, s = 128, 512, 64, 416
    g = torch.Generator(device="cuda").manual_seed(13)

    def rn(*shape):
        return torch.randn(shape, generator=g, device="cuda").bfloat16()
    args = (rn(1, s, hq, dl), rn(1, s, hq, dr), rn(1, s, dl + dr),
            torch.zeros((1, 64, dl + dr), dtype=torch.bfloat16,
                        device="cuda"),
            torch.zeros((1, 1), dtype=torch.int32, device="cuda"),
            torch.zeros((1,), dtype=torch.int32, device="cuda"))
    scale = 1.0 / (128 + dr) ** 0.5
    before = cuda.mla_paged_prefill.launches
    out = cuda.mla_prefill(*args, d_latent=dl, scale=scale)
    torch.cuda.synchronize()
    assert cuda.mla_paged_prefill.launches == before + 1
    assert bool(torch.isfinite(out).all())
    plain = cuda.mla_prefill(*args, d_latent=dl, scale=scale,
                             backend="torch")
    assert _err(out, plain) <= BF16_TOL


def test_mla_decode_kernel_over_latent_slot_pages(cuda):
    """DeepSeek-V3 width, bf16: 8 latent slots of 2048 tokens seen as
    64-token pages (``attention.slot_pages``), ragged lengths, every
    slot past a row's length 8x larger (what a one-token mask error
    would read): the kernel equals the plain version."""
    from repro_torch.models import attention as attn
    b, s, hq, dl, dr = 8, 2048, 128, 512, 64
    g = torch.Generator(device="cuda").manual_seed(14)
    cache = torch.randn((b, s, dl + dr), generator=g, device="cuda")
    lengths = torch.tensor([1, 31, 257, 700, 1024, 1500, 2047, 2048],
                           dtype=torch.int32, device="cuda")
    stale = torch.arange(s, device="cuda")[None] >= lengths.long()[:, None]
    cache[stale] *= 8.0
    cache = cache.bfloat16()
    (pages,), tables = attn.slot_pages(cache)
    assert pages.shape == (b * s // 64, 64, dl + dr)
    args = (torch.randn((b, hq, dl), generator=g, device="cuda").bfloat16(),
            torch.randn((b, hq, dr), generator=g, device="cuda").bfloat16(),
            pages, tables, lengths)
    scale = 1.0 / (128 + dr) ** 0.5
    before = cuda.mla_paged_decode.launches
    out = cuda.mla_decode(*args, d_latent=dl, scale=scale)
    torch.cuda.synchronize()
    assert cuda.mla_paged_decode.launches == before + 1
    plain = cuda.mla_decode(*args, d_latent=dl, scale=scale, backend="torch")
    assert _err(out, plain) <= BF16_TOL


def test_moe_ffn_on_card_matches_cpu(cuda):
    """Reduced granite-moe width, float32: a router biased so that
    capacity drops assignments; the routing on the card (top-k experts,
    positions, kept set) equals the CPU's exactly and the outputs agree
    within 1e-4."""
    from repro_torch.config import reduce_config
    from repro_torch.configs import get_config
    from repro_torch.models import moe
    cfg = reduce_config(get_config("granite-moe-3b-a800m"))
    d, e, f = cfg.d_model, cfg.layout_n_experts, cfg.moe_ff
    g = torch.Generator().manual_seed(15)
    p = {"router": torch.randn((d, e), generator=g) * 0.3,
         "w_gate": torch.randn((e, d, f), generator=g) * 0.1,
         "w_up": torch.randn((e, d, f), generator=g) * 0.1,
         "w_down": torch.randn((e, f, d), generator=g) * 0.1}
    u = torch.full((d,), d ** -0.5)
    p["router"] += torch.outer(u, torch.tensor([4.0, 3.0, 0.0, 0.0]))
    x = torch.randn((4, 16, d), generator=g) * 0.2 + u
    pc = {k: v.cuda() for k, v in p.items()}
    routes = [moe.route(pp, xx.reshape(1, -1, d), cfg)[2:]
              for pp, xx in ((p, x), (pc, x.cuda()))]
    for cpu, card in zip(*routes):
        assert torch.equal(cpu, card.cpu())
    assert not bool(routes[0][2].all())           # some assignment dropped
    out, aux = moe.moe_ffn(pc, x.cuda(), cfg)
    ref, ref_aux = moe.moe_ffn(p, x, cfg)
    assert _err(out.cpu(), ref) <= F32_TOL
    assert abs(float(aux) - float(ref_aux)) <= F32_TOL


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


@pytest.mark.parametrize("arch", ["llama-3.2-vision-11b", "whisper-tiny"])
def test_cross_attention_model_on_card_matches_cpu(cuda, arch):
    """Reduced VLM and encoder-decoder, float32 weights with the cross
    gates at 0.7: a prefill of two rows and three greedy decode steps on
    the card (kernels 7 and 1) equal the CPU's (plain versions) within
    1e-4, with both kernels launched."""
    from repro_torch.config import reduce_config
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model
    m = build_model(reduce_config(get_config(arch)))
    cfg = m.cfg
    params = m.init_params(3, device="cpu", dtype=torch.float32)
    if "cross" in params:
        params["cross"]["gate"].fill_(0.7)
    g = torch.Generator().manual_seed(4)
    key = "patches" if cfg.n_patches else "frames"
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 21), generator=g,
                                     dtype=torch.int32),
             key: torch.randn((2, cfg.n_patches or cfg.enc_len, cfg.d_model),
                              generator=g)}
    flash = cuda.flash_prefill.launches
    dec = cuda.paged_decode_attention.launches
    logits = {}
    for dev in ("cpu", "cuda"):
        p, b = _to(params, dev), _to(batch, dev)
        lg, st = m.prefill(p, b)
        state = m.init_decode_state(2, 64, device=dev)
        state = {k: v.float() if v.is_floating_point() else v
                 for k, v in state.items()}
        for k in ("k", "v"):
            state[k][:, :, :21] = st[k]
        state["xk"], state["xv"] = st["xk"], st["xv"]
        state["lengths"] = st["lengths"]
        out = [lg]
        for _ in range(3):
            lg, state = m.decode_step(p, state, lg.argmax(-1).to(torch.int32))
            out.append(lg)
        logits[dev] = torch.stack(out)
    torch.cuda.synchronize()
    assert _err(logits["cuda"].cpu(), logits["cpu"]) <= F32_TOL
    assert cuda.flash_prefill.launches > flash
    assert cuda.paged_decode_attention.launches > dec


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "rwkv6-1.6b"])
def test_recurrent_model_on_card_matches_cpu(cuda, arch):
    """Reduced hybrid and RWKV6, float32 weights: a 70-token prefill of
    two rows (a full SSD chunk and a remainder; WKV chunks and a
    remainder) and three greedy decode steps on the card equal the CPU's
    within 1e-4, every state leaf too; the hybrid's shared attention
    launches kernels 7 and 1."""
    from repro_torch.config import reduce_config
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model
    m = build_model(reduce_config(get_config(arch)))
    cfg = m.cfg
    params = m.init_params(3, device="cpu", dtype=torch.float32)
    toks = torch.randint(0, cfg.vocab_size, (2, 70),
                         generator=torch.Generator().manual_seed(4),
                         dtype=torch.int32)
    flash = cuda.flash_prefill.launches
    dec = cuda.paged_decode_attention.launches
    out = {}
    for dev in ("cpu", "cuda"):
        p = _to(params, dev)
        lg, st = m.prefill(p, {"tokens": toks.to(dev)})
        if "k" in st:           # the hybrid's K/V slots, grown to 128
            for key in ("k", "v"):
                st[key] = torch.cat([st[key], st[key].new_zeros(
                    st[key].shape[:2] + (58,) + st[key].shape[3:])], dim=2)
        st = {k: (_to(v, dev) if isinstance(v, dict)
                  else v.float() if v.is_floating_point() else v)
              for k, v in st.items()}
        if "mamba" in st:
            st["mamba"] = {k: v.float() for k, v in st["mamba"].items()}
        logits = [lg]
        for _ in range(3):
            lg, st = m.decode_step(p, st, lg.argmax(-1).to(torch.int32))
            logits.append(lg)
        out[dev] = (torch.stack(logits), st)
    torch.cuda.synchronize()
    assert _err(out["cuda"][0].cpu(), out["cpu"][0]) <= F32_TOL
    for k, v in out["cpu"][1].items():
        for kk, leaf in (v.items() if isinstance(v, dict) else [(k, v)]):
            card = out["cuda"][1][k]
            card = card[kk] if isinstance(v, dict) else card
            assert _err(card.cpu().float(), leaf.float()) <= F32_TOL, kk
    if arch.startswith("zamba2"):
        assert cuda.flash_prefill.launches > flash
        assert cuda.paged_decode_attention.launches > dec


# ---------------------------------------------------------------------------
# the Hopper bodies of the GQA paged decode (`paged_decode_wg`: TMA page
# loads, a split walk merged in a cluster) and of the absorbed-MLA decode
# (`mla_decode_wg`: `wgmma` over 64-token latent pages)
# ---------------------------------------------------------------------------
# (Hq, Hkv, hd, page, pages, B): llama3.2-1b's heads at 64-, 32- and
# 16-token pages over a 512-token window, granite-moe's G 3, the VLM's 32 /
# 8 heads at hd 128, zamba2's G 1 at 32 KV heads, G 1 at 6 / 6 heads, MQA
# at G 16, a window that is not a whole number of tiles (37 pages of 16)
# and a 4096-token window (the body's longest: splits of 32 tiles and
# more, the ring reused)
WG_DECODE_CASES = [
    (32, 8, 64, 64, 8, 20), (32, 8, 64, 32, 16, 20), (32, 8, 64, 16, 32, 20),
    (24, 8, 64, 64, 8, 20), (32, 8, 128, 64, 16, 20), (32, 32, 64, 64, 16, 6),
    (6, 6, 64, 64, 8, 8), (16, 1, 128, 16, 32, 12), (8, 2, 64, 16, 37, 8),
    (32, 8, 64, 64, 64, 6),
]


def _wg_decode_case(hq, hkv, hd, page, pages, b, seed=0):
    """bf16 q, pools and tables for ``b`` rows, lengths at the edges of
    64-key tiles and of the default plan's splits: 0, 1, 63, 64, 65, one
    split, one split + 1, the full window, then ragged; a clamped table
    entry inside the last row's length."""
    from repro_torch.kernels import paged_attention as pa
    g = torch.Generator(device="cuda").manual_seed(seed)
    n = b * pages + 2
    kp, vp = (torch.randn((n, page, hkv, hd), generator=g,
                          device="cuda").bfloat16() for _ in range(2))
    tables = (torch.randperm(n - 1, generator=g, device="cuda")[:b * pages]
              + 1).reshape(b, pages).to(torch.int32)
    tables[-1, 0] = -3                          # clamps to page 0
    window = pages * page
    span = pa.decode_split_plan(b, hq, hkv, hd, page, pages).tiles * 64
    edges = [min(e, window) for e in (0, 1, 63, 64, 65, span, span + 1)]
    lengths = torch.randint(1, window + 1, (b,), generator=g,
                            device="cuda").to(torch.int32)
    lengths[:min(len(edges), b - 1)] = torch.tensor(edges[:b - 1])
    lengths[-1] = window
    q = torch.randn((b, hq, hd), generator=g, device="cuda").bfloat16()
    return q, kp, vp, tables, lengths


@pytest.mark.parametrize("hq,hkv,hd,page,pages,b", WG_DECODE_CASES)
def test_paged_decode_wg_body(cuda, hq, hkv, hd, page, pages, b):
    """The Hopper body (``body`` names it) against the plain version,
    with and without its log-sum-exp (against ``ref.paged_decode_lse``),
    zeros and -1e30 for a row of length 0; one launch a call, and two
    calls equal bit for bit."""
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import ref
    assert pa.body(hq, hkv, hd, page, pages, 1, 1) == "hopper"
    args = _wg_decode_case(hq, hkv, hd, page, pages, b)
    before = cuda.paged_decode_attention.launches
    out = cuda.paged_decode(*args)
    torch.cuda.synchronize()
    assert cuda.paged_decode_attention.launches == before + 1
    assert bool(torch.isfinite(out).all())
    assert bool((out[0] == 0).all())            # length 0 -> zeros
    assert _err(out, cuda.paged_decode(*args, backend="torch")) <= BF16_TOL
    assert torch.equal(out, cuda.paged_decode(*args))
    out2, lse = cuda.paged_decode(*args, with_lse=True)
    assert torch.equal(out2, out)
    assert bool(torch.isfinite(lse).all())
    assert bool((lse[0] == -1e30).all())    # length 0
    q, kp, _, tables, lengths = args
    assert _err(lse, ref.paged_decode_lse(q, kp, tables, lengths)) \
        <= LSE_ATOL


@pytest.mark.parametrize("hq,hkv,hd,page,pages,b",
                         [WG_DECODE_CASES[i] for i in (0, 2, 4, 8, 9)])
def test_paged_decode_wg_split_plans(cuda, hq, hkv, hd, page, pages, b):
    """Plans of 1, 2, 3, 4 and 8 tiles a split (those of at most
    MAX_SPLITS splits: one cluster) agree with the plain version, each
    twice bit for bit; a plan of more splits, or one that does not cover
    the window, is refused."""
    from repro_torch.kernels import paged_attention as pa
    args = _wg_decode_case(hq, hkv, hd, page, pages, b, seed=3)
    plan = pa.decode_split_plan(b, hq, hkv, hd, page, pages)
    plain = cuda.paged_decode(*args, backend="torch")
    n_tiles = -(-pages * page // 64)
    for tiles in (1, 2, 3, 4, 8):
        other = plan._replace(tiles=tiles, splits=-(-n_tiles // tiles))
        if other.splits > pa.MAX_SPLITS:
            with pytest.raises(RuntimeError, match="CUDA error"):
                pa._launch_decode(*args, None, plan=other)
            continue
        out = pa._launch_decode(*args, None, plan=other)
        torch.cuda.synchronize()
        assert _err(out, plain) <= BF16_TOL
        assert torch.equal(out, pa._launch_decode(*args, None, plan=other))
    short = plan._replace(splits=plan.splits - 1)
    if short.splits >= 1 and short.splits * short.tiles * 64 < pages * page:
        with pytest.raises(RuntimeError, match="CUDA error"):
            pa._launch_decode(*args, None, plan=short)


@pytest.mark.parametrize("hq,hkv,hd,page,pages,b",
                         [WG_DECODE_CASES[i] for i in (0, 1, 2, 4, 8, 9)])
def test_paged_decode_wg_ignores_nonfinite_unread_slots(cuda, hq, hkv, hd,
                                                        page, pages, b):
    """Slots at or past a row's length holding inf in K and NaN in V, or
    NaN in K and inf in V, leave the output and the log-sum-exp bit for
    bit as with clean slots: whole pages land in shared memory, and the
    body zeroes those V rows before P V and replaces their scores."""
    q, kp, vp, tables, lengths = _wg_decode_case(hq, hkv, hd, page, pages,
                                                 b, seed=5)
    clean = cuda.paged_decode(q, kp, vp, tables, lengths, with_lse=True)
    pos = torch.arange(pages * page, device="cuda")
    unread = pos[None] >= lengths.long()[:, None]
    pid = tables.long().clamp(0, kp.shape[0] - 1)[:, pos // page]
    slots = (pid * page + pos % page)[unread]
    # a slot a row does not read may be one another row reads (the
    # clamped entry): keep those clean
    read = (pid * page + pos % page)[~unread]
    slots = slots[~torch.isin(slots, read)]
    assert slots.numel() > 0
    for kbad, vbad in ((float("inf"), float("nan")),
                       (float("nan"), float("inf"))):
        k2, v2 = kp.clone(), vp.clone()
        k2.view(-1, *k2.shape[2:])[slots] = kbad
        v2.view(-1, *v2.shape[2:])[slots] = vbad
        out, lse = cuda.paged_decode(q, k2, v2, tables, lengths,
                                     with_lse=True)
        torch.cuda.synchronize()
        assert bool(torch.isfinite(out).all())
        assert torch.equal(out, clean[0]) and torch.equal(lse, clean[1])


# (B, full rows, 2048-token tables of 64-token pages): the mla_kernels
# phase's 56 ragged rows and 8 full rows, and one row
WG_MLA_CASES = [(56, False), (8, True), (1, True)]


def _wg_mla_case(b, full, seed=0, pages=32):
    g = torch.Generator(device="cuda").manual_seed(seed)
    hq, dl, dr, page = 128, 512, 64, 64
    n = b * pages + 2
    lp = torch.randn((n, page, dl + dr), generator=g,
                     device="cuda").bfloat16()
    tables = (torch.randperm(n - 1, generator=g, device="cuda")[:b * pages]
              + 1).reshape(b, pages).to(torch.int32)
    tables[-1, 0] = -1                          # clamps to page 0
    if full:
        lengths = torch.full((b,), pages * page, dtype=torch.int32,
                             device="cuda")
    else:
        lengths = torch.randint(1, pages * page + 1, (b,), generator=g,
                                device="cuda").to(torch.int32)
        lengths[:len(SPLIT_LENGTHS)] = torch.tensor(SPLIT_LENGTHS)
        lengths[-1] = pages * page
    return (torch.randn((b, hq, dl), generator=g, device="cuda").bfloat16(),
            torch.randn((b, hq, dr), generator=g, device="cuda").bfloat16(),
            lp, tables, lengths)


@pytest.mark.parametrize("b,full", WG_MLA_CASES)
def test_mla_decode_wg_body(cuda, b, full):
    """DeepSeek-V3 width over 64-token pages runs the `wgmma` body
    (``body`` names it): against the plain version at lengths on the page
    (64), split and window edges and on full rows, one launch a call,
    zeros for length 0, two calls equal bit for bit."""
    from repro_torch.kernels import mla_paged_decode as mpd
    assert mpd.body(512, 64, 64, 1, 1) == "wgmma"
    args = _wg_mla_case(b, full)
    scale = 1.0 / (128 + 64) ** 0.5            # the engine's scale
    before = cuda.mla_paged_decode.launches
    out = cuda.mla_decode(*args, d_latent=512, scale=scale)
    torch.cuda.synchronize()
    assert cuda.mla_paged_decode.launches == before + 1
    assert bool(torch.isfinite(out).all())
    plain = cuda.mla_decode(*args, d_latent=512, scale=scale,
                            backend="torch")
    assert _err(out, plain) <= BF16_TOL
    if not full:
        assert bool((out[0] == 0).all())        # length 0 -> zeros
    assert torch.equal(out, cuda.mla_decode(*args, d_latent=512,
                                            scale=scale))


def test_mla_decode_wg_ignores_nonfinite_unread_slots(cuda):
    """Latent slots at or past a row's length holding inf, then NaN,
    leave the `wgmma` body's output bit for bit as with clean slots (the
    body zeroes their latent columns and replaces their scores)."""
    q_lat, q_rope, lp, tables, lengths = _wg_mla_case(56, False, seed=5)
    page = lp.shape[1]
    clean = cuda.mla_decode(q_lat, q_rope, lp, tables, lengths,
                            d_latent=512)
    pos = torch.arange(tables.shape[1] * page, device="cuda")
    unread = pos[None] >= lengths.long()[:, None]
    pid = tables.long().clamp(0, lp.shape[0] - 1)[:, pos // page]
    slots = (pid * page + pos % page)
    slots = slots[unread][~torch.isin(slots[unread], slots[~unread])]
    assert slots.numel() > 0
    for bad in (float("inf"), float("nan")):
        l2 = lp.clone()
        l2.view(-1, lp.shape[-1])[slots] = bad
        out = cuda.mla_decode(q_lat, q_rope, l2, tables, lengths,
                              d_latent=512)
        torch.cuda.synchronize()
        assert bool(torch.isfinite(out).all())
        assert torch.equal(out, clean)


def test_decode_body_queries(cuda):
    """The decodes' ``body`` queries name the bodies their C entries
    dispatch to: the GQA decode's Hopper body at bf16 hd 64 / 128, G <=
    16, pages of 16 / 32 / 64 and table windows of 512 to 4096 tokens,
    `mma.sync` at hd 16 / 32, other pages and other windows, the CUDA
    cores for float32; the MLA decode's `wgmma` body at dl 512, dr 64
    over 64-token pages only."""
    from repro_torch.kernels import mla_paged_decode as mpd
    from repro_torch.kernels import paged_attention as pa
    for hq, hkv in [(32, 8), (24, 8), (32, 32), (6, 6), (16, 1)]:
        for page in (16, 32, 64):
            p = 512 // page
            assert [pa.body(hq, hkv, hd, page, p, 1, 1)
                    for hd in (16, 32, 64, 128)] == \
                ["tensor_core", "tensor_core", "hopper", "hopper"]
            assert pa.body(hq, hkv, 64, page, p, 0, 1) == "cuda_core"
            assert pa.body(hq, hkv, 64, page, p, 0, 0) == "cuda_core"
            # the window rule: 448 and 8192 tokens keep `mma.sync`
            assert pa.body(hq, hkv, 64, page, 4096 // page, 1, 1) == "hopper"
            assert pa.body(hq, hkv, 64, page, 448 // page, 1, 1) == \
                "tensor_core"
            assert pa.body(hq, hkv, 64, page, 8192 // page, 1, 1) == \
                "tensor_core"
        for page in (8, 128):
            assert pa.body(hq, hkv, 64, page, 4096 // page, 1, 1) == \
                "tensor_core"
    assert pa.body(32, 1, 64, 64, 8, 1, 1) == "cuda_core"   # G 32
    assert mpd.body(512, 64, 64, 1, 1) == "wgmma"
    for dl, dr, page in [(512, 64, 16), (512, 64, 32), (96, 16, 64),
                         (32, 8, 64), (512, 32, 64)]:
        assert mpd.body(dl, dr, page, 1, 1) == "tensor_core"
    assert mpd.body(512, 64, 64, 0, 1) == "cuda_core"
