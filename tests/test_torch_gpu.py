"""The port's CUDA kernels against their plain PyTorch versions on the
card.  Needs a CUDA device and the CUDA toolkit (the kernels build at
first use); elsewhere every test skips.  Run on the card with

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


@pytest.mark.parametrize("dtype,tol", [(torch.float32, F32_TOL),
                                       (torch.bfloat16, BF16_TOL)])
def test_paged_prefill_kernel(cuda, dtype, tol):
    a = _inputs(dtype)
    offs = torch.tensor([0, 5, 16, 40, 80], dtype=torch.int32,
                        device="cuda")
    args = (a["q"], a["kc"], a["vc"], a["kp"], a["vp"], a["tables"], offs)
    out = cuda.paged_prefill(*args)
    assert _err(out, cuda.paged_prefill(*args, backend="torch")) <= tol


@pytest.mark.parametrize("dtype,tol", [(torch.float32, F32_TOL),
                                       (torch.bfloat16, BF16_TOL)])
def test_paged_prefill_seg_kernel(cuda, dtype, tol):
    a = _inputs(dtype)
    rows = [[3, 4, 5, 6, 40, 41, 42, 43],
            list(range(16)),
            [],
            [10, 11, 12, 50, 51, 52, 53, 54, 55, 56, 57],
            [90, 91]]
    cpos = torch.tensor([r + [-1] * (16 - len(r)) for r in rows],
                        dtype=torch.int32, device="cuda")
    args = (a["q"], a["kc"], a["vc"], a["kp"], a["vp"], a["tables"], cpos)
    out = cuda.paged_prefill_seg(*args)
    assert _err(out, cuda.paged_prefill_seg(*args, backend="torch")) <= tol


def test_seg_kernel_contiguous_equals_offset_bitwise(cuda):
    a = _inputs(torch.bfloat16)
    offs = [0, 5, 16, 40, 80]
    cpos = torch.tensor([[o + i for i in range(16)] for o in offs],
                        dtype=torch.int32, device="cuda")
    base = (a["q"], a["kc"], a["vc"], a["kp"], a["vp"], a["tables"])
    seg = cuda.paged_prefill_seg(*base, cpos)
    off = cuda.paged_prefill(*base, torch.tensor(offs, dtype=torch.int32,
                                                 device="cuda"))
    assert torch.equal(seg, off)


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
    params = build_model(cfg).init_params(0, dtype=torch.float32)
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


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return tree.to(dev)
