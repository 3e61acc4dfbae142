"""The frozen yardstick: the cost formulas and peaks against numbers
worked by hand at one decode, one chunk-prefill and one MLA shape, and
against the program's own formulas (``repro_torch/kernels/cost.py``)
that they were copied from; the Poisson arithmetic against
``repro_torch/traces/loadgen.py``."""
from __future__ import annotations

import numpy as np
import pytest

import pbtiny  # noqa: F401
from pb import cost
from pb.poisson import PoissonArrivals

torch = pytest.importorskip("torch")


def test_peaks():
    assert cost.PEAK_FLOPS_BF16 == 989e12
    assert cost.HBM_BW == 3.35e12
    # bytes-bound: 3.35 GB in one millisecond
    assert cost.bound_s(3.35e9, 1.0) == pytest.approx(1e-3)
    assert cost.bound_s(1.0, 989e9) == pytest.approx(1e-3)


def test_decode_by_hand():
    # 4 rows, 24 query heads over 8 KV heads at hd 64, bf16; 64-entry
    # tables; 1000 attended tokens in all
    c = cost.CallShape(q=(4, 24, 64), q_el=2, kv_heads=8, row=64,
                       pool_el=2, table_entries=4 * 64, ints=4)
    nbytes, flops = cost.decode_cost(c, 1000)
    q = 4 * 24 * 64
    assert nbytes == 2 * q * 2 + 2 * 1000 * 8 * 64 * 2 + 256 * 4 + 16
    assert nbytes == 24576 + 2048000 + 1024 + 16 == 2073616
    assert flops == 4 * 1000 * 24 * 64 == 6144000


def test_chunk_prefill_by_hand():
    # one 64-token chunk at offset 128: 128 pool tokens, pairs
    # 64 * 128 + 64 * 65 / 2
    c = cost.CallShape(q=(1, 64, 24, 64), q_el=2, kv_heads=8, row=64,
                       pool_el=2, table_entries=64, ints=1,
                       chunk_el=64 * 8 * 64)
    pairs = 64 * 128 + 64 * 65 // 2
    nbytes, flops = cost.prefill_cost(c, 128, pairs)
    assert pairs == 10272
    assert nbytes == (2 * 64 * 24 * 64 * 2 + 2 * 64 * 8 * 64 * 2
                      + 2 * 128 * 8 * 64 * 2 + 64 * 4 + 4 * 64) == 786944
    assert flops == 4 * 10272 * 24 * 64 == 63111168


def test_mla_by_hand():
    # DeepSeek-V3's absorbed decode: 2 rows, 128 heads, dl 512, dr 64,
    # 3000 latent tokens read, 3000 pairs
    c = cost.CallShape(q=(2, 128, 512), q_el=2, kv_heads=0, row=512,
                       pool_el=2, table_entries=2 * 256, ints=2, rope=64)
    nbytes, flops = cost.mla_cost(c, 3000, 3000)
    q_lat = 2 * 128 * 512
    q_rope = 2 * 128 * 64
    assert nbytes == (2 * q_lat + q_rope) * 2 + 3000 * 576 * 2 + 514 * 4
    assert nbytes == 557056 + 3456000 + 2056 == 4015112
    assert flops == 3000 * 128 * (2 * 576 + 2 * 512) == 835584000


def _program_cost():
    return pytest.importorskip("repro_torch.kernels.cost")


def test_same_as_the_program_decode_and_prefill():
    pc = _program_cost()
    m = torch.device("meta")
    a = {"q": torch.empty(4, 24, 64, dtype=torch.bfloat16, device=m),
         "k_pages": torch.empty(100, 64, 8, 64, dtype=torch.bfloat16,
                                device=m),
         "block_tables": torch.empty(4, 64, dtype=torch.int32, device=m)}
    c = cost.CallShape((4, 24, 64), 2, 8, 64, 2, 256, 4)
    assert pc.decode_cost(a, tokens=1000) == cost.decode_cost(c, 1000)
    a = {"q": torch.empty(1, 64, 24, 64, dtype=torch.bfloat16, device=m),
         "k_chunk": torch.empty(1, 64, 8, 64, dtype=torch.bfloat16,
                                device=m),
         "k_pages": a["k_pages"],
         "block_tables": torch.empty(1, 64, dtype=torch.int32, device=m)}
    c = cost.CallShape((1, 64, 24, 64), 2, 8, 64, 2, 64, 1,
                       chunk_el=64 * 8 * 64)
    assert pc.prefill_cost(a, 128, 10272) == cost.prefill_cost(c, 128, 10272)


def test_same_as_the_program_mla():
    pc = _program_cost()
    m = torch.device("meta")
    a = {"q_lat": torch.empty(2, 128, 512, dtype=torch.bfloat16, device=m),
         "q_rope": torch.empty(2, 128, 64, dtype=torch.bfloat16, device=m),
         "latent_pages": torch.empty(10, 64, 576, dtype=torch.bfloat16,
                                     device=m),
         "block_tables": torch.empty(2, 256, dtype=torch.int32, device=m),
         "lengths": torch.empty(2, dtype=torch.int32, device=m)}
    c = cost.CallShape((2, 128, 512), 2, 0, 512, 2, 512, 2, rope=64)
    assert pc.mla_cost(a, 3000, 3000) == cost.mla_cost(c, 3000, 3000)


def test_poisson_same_as_the_program():
    lg = pytest.importorskip("repro_torch.traces.loadgen")
    ours = PoissonArrivals(3.0, seed=17).arrival_times(duration_s=50.0)
    theirs = lg.PoissonLoadGen(3.0, seed=17).arrival_times(duration_s=50.0)
    assert np.allclose(ours, theirs)
    ours = PoissonArrivals(3.0, seed=17).arrival_times(n=40)
    theirs = lg.PoissonLoadGen(3.0, seed=17).arrival_times(n=40)
    assert np.allclose(ours, theirs)
