"""The port's CUDA kernels (GQA paged decode / prefill / segment
prefill, their absorbed-MLA counterparts, causal flash prefill and int8
paged decode) against their plain PyTorch versions on the card, and the
bf16 decode kernels' split walks against themselves (bit for bit).
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
                                            (8, 1, 128, 64)])
def test_paged_decode_kernel_long_rows(cuda, hq, hkv, hd, page):
    """llama3.2-1b width (and MQA at hd 128), bf16 on the bandwidth
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
                                                  (32, 8, 64, 64, 8)])
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
# (17, 63), one row past a 64-key tile (65, 129)
FLASH_SHAPES = [(1, 416, 32, 8, 64), (1, 384, 32, 8, 64),
                (2, 160, 8, 2, 64), (1, 100, 4, 4, 32), (1, 70, 8, 1, 128),
                (3, 1, 4, 2, 16), (1, 40, 2, 1, 256),
                (1, 17, 4, 2, 64), (1, 17, 4, 2, 128), (2, 63, 4, 1, 64),
                (2, 63, 4, 1, 128), (1, 65, 8, 2, 64), (1, 65, 8, 2, 128),
                (1, 129, 4, 4, 64), (1, 129, 4, 4, 128)]


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


@pytest.mark.parametrize("dtype,tol", [(torch.float32, F32_TOL),
                                       (torch.bfloat16, BF16_TOL)])
@pytest.mark.parametrize("hq,hkv,hd,page", [(32, 8, 64, 64), (8, 2, 64, 16),
                                            (4, 4, 32, 32), (8, 1, 128, 16)])
def test_paged_decode_int8_kernel(cuda, dtype, tol, hq, hkv, hd, page):
    """bf16 q on the int8 tensor-core body, float32 q on the CUDA-core
    body: against the plain version, one launch a call, finite, and two
    calls equal bit for bit."""
    q, kq, vq, ks, vs, tables = _int8_inputs(5, hq, hkv, hd, page, 6)
    lengths = torch.tensor([0, 1, 17, 6 * page, 50], dtype=torch.int32,
                           device="cuda")
    tables[1, 3] = 999                          # clamped, past the length
    args = (q.to(dtype), kq, vq, ks, vs, tables, lengths)
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
@pytest.mark.parametrize("page", [64, 16])
def test_paged_decode_int8_kernel_long_rows(cuda, page, full):
    """The int8 body at llama3.2-1b width: every row full, or ragged
    lengths at its tile and warp edges."""
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


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_paged_decode_int8_ignores_stale_slots(cuda, dtype):
    """Slots at or past each row's length that hold int8 +-127 and inf /
    NaN scales leave the output bit for bit as with clean slots: a key
    past the length is never loaded (bf16: the tensor-core body; float32:
    the CUDA-core body)."""
    q, kq, vq, ks, vs, tables, lengths = _int8_long_rows(32, 8, 64, 16,
                                                         seed=13)
    args = (q.to(dtype), kq, vq, ks, vs, tables, lengths)
    clean = cuda.paged_decode_int8(*args)
    page = kq.shape[1]
    pos = torch.arange(tables.shape[1] * page, device="cuda")
    pid = tables.long().clamp(0, kq.shape[0] - 1)[:, pos // page]
    stale = pos[None, :] >= lengths.long()[:, None]
    slots = (pid * page + pos % page)[stale]
    # slots past one row's length that another row reads stay clean
    live = (pid * page + pos % page)[~stale]
    slots = slots[~torch.isin(slots, live)]
    assert slots.numel() > 0
    dirty = []
    for t, bad in ((kq, 127), (vq, -127), (ks, float("inf")),
                   (vs, float("nan"))):
        t = t.clone()
        t.view(-1, *t.shape[2:])[slots] = bad
        dirty.append(t)
    out = cuda.paged_decode_int8(args[0], *dirty, tables, lengths)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(out).all())
    assert torch.equal(out, clean)


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


# lengths at the MLA decode's split (256 tokens) and tile (32) edges, a
# row of length 0 and one in the middle of a split
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
    assert mpd.decode_split_tokens(pages * page) == 256
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
def test_mla_seg_kernel_contiguous_equals_offset_bitwise(cuda, hq, dl, dr):
    a = _mla_inputs(torch.bfloat16, hq=hq, dl=dl, dr=dr, page=64, pages=3)
    offs = [0, 37, 120]
    cpos = torch.tensor([[o + i for i in range(8)] for o in offs],
                        dtype=torch.int32, device="cuda")
    base = (a["ql"], a["qr"], a["lc"], a["lp"], a["tables"])
    seg = cuda.mla_prefill_seg(*base, cpos, d_latent=dl)
    off = cuda.mla_prefill(*base, torch.tensor(offs, dtype=torch.int32,
                                               device="cuda"), d_latent=dl)
    assert torch.equal(seg, off)


def test_tensor_core_dispatch(cuda):
    """The C entries choose a body by type and width: bf16 flash prefill
    at hd 16-128, bf16 MLA chunk prefill and MLA decode at every width
    above and bf16 GQA decode and GQA chunk / segment prefill at hd
    16-128 with up to 16 query heads a KV head run on the tensor cores,
    and so does the int8 GQA decode with a bf16 query at those widths;
    float32 (the float32 engine tests), a float32 query over a bf16 or
    int8 pool, flash hd 256 and the GQA kernels at other widths keep the
    CUDA-core bodies."""
    import ctypes

    from repro_torch.kernels import build
    flash = build.entry("flash_prefill", "flash_prefill_tensor_core",
                        [ctypes.c_int] * 2)
    assert [flash(hd, 1) for hd in (16, 32, 64, 128, 256)] == [1] * 4 + [0]
    assert [flash(hd, 0) for hd in (16, 32, 64, 128, 256)] == [0] * 5
    mla = build.entry("mla_paged_prefill", "mla_paged_prefill_tensor_core",
                      [ctypes.c_int] * 5)
    for _, dl, dr in MLA_WIDTHS:
        for n_cp in (0, 8, 64):
            assert mla(dl, dr, n_cp, 1, 1) == 1
            assert mla(dl, dr, n_cp, 0, 1) == 0
            assert mla(dl, dr, n_cp, 0, 0) == 0
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
                        (16, 1, 16)]:
        assert gqa(hq, hkv, hd, 1, 1) == 1
        assert gqa(hq, hkv, hd, 0, 1) == 0
        assert gqa(hq, hkv, hd, 0, 0) == 0
    assert gqa(32, 1, 64, 1, 1) == 0            # 32 query heads a KV head
    assert gqa(8, 2, 256, 1, 1) == 0            # hd 256
    pre = build.entry("paged_prefill", "paged_prefill_tensor_core",
                      [ctypes.c_int] * 5)
    for hq, hkv, hd in [(32, 8, 64), (8, 2, 16), (4, 4, 32), (8, 1, 128),
                        (16, 1, 32)]:
        assert pre(hq, hkv, hd, 1, 1) == 1
        assert pre(hq, hkv, hd, 0, 1) == 0
        assert pre(hq, hkv, hd, 0, 0) == 0
    assert pre(32, 1, 64, 1, 1) == 0            # 32 query heads a KV head
    assert pre(8, 2, 256, 1, 1) == 0            # hd 256
    int8 = build.entry("paged_decode", "paged_decode_int8_tensor_core",
                       [ctypes.c_int] * 4)
    for hq, hkv, hd in [(32, 8, 64), (8, 2, 64), (4, 4, 32), (8, 1, 128),
                        (16, 1, 16)]:
        assert int8(hq, hkv, hd, 1) == 1
        assert int8(hq, hkv, hd, 0) == 0
    assert int8(32, 1, 64, 1) == 0              # 32 query heads a KV head
    assert int8(8, 2, 256, 1) == 0              # hd 256


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


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return tree.to(dev)
