"""Tiny versions of the benchmark's configurations and a cell over them,
for the CPU tests: the same model types and layer equations at widths a
test run can hold."""
from __future__ import annotations

import json
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(BENCH), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

GAIN = 8.0
STEP_S = 0.02      # the virtual clock's cost of one engine step
ALL_END_TO_END = ("output_tok_per_s", "peak_mem_gb", "setup_s")


def config(kind: str) -> dict:
    if kind == "mla":
        c = json.load(open(BENCH / "configs" / "deepseek-v3-mla8.json"))
        c.update(hidden_size=128, num_attention_heads=4,
                 num_key_value_heads=4, qk_nope_head_dim=16, v_head_dim=16,
                 qk_rope_head_dim=8, kv_lora_rank=32, intermediate_size=256,
                 vocab_size=512, num_hidden_layers=2, first_k_dense_replace=2)
        c["serve"] = dict(c["serve"], max_len=1536, slots=4)
        return c
    c = json.load(open(BENCH / "configs" / "granite-moe-3b-a800m.json"))
    c.update(hidden_size=128, num_attention_heads=4, num_key_value_heads=2,
             head_dim=32, intermediate_size=64, vocab_size=512,
             num_hidden_layers=2, num_local_experts=4, num_experts_per_tok=2)
    c["serve"] = dict(c["serve"], max_len=1024, slots=4)
    return c


MIX = {"generator": "reask", "structure_seed": 1,
       "context": {"dist": "uniform", "min": 520, "max": 700},
       "turns": [2, 3],
       "user": {"dist": "uniform", "min": 8, "max": 30},
       "answer": {"dist": "uniform", "min": 6, "max": 12},
       "gap_s": {"dist": "uniform", "min": 0.2, "max": 0.6}}


# short prompts and answers: requests finish within a second or two of
# a slow CPU
FAST = dict(MIX, context={"dist": "uniform", "min": 100, "max": 200},
            turns=[1, 2], answer={"dist": "uniform", "min": 4, "max": 8})


def cell(kind: str = "mla", limit: float = 0.05, per_layer=(), mix=FAST):
    from pb import spec
    return spec.Cell(
        name="tiny",
        bench={"config": "tiny-" + kind, "traffic": "tiny", "chips": 1},
        cell={"sessions_per_s": 3.0,
              "check": {"gap_limit": limit, "min_tokens": 60,
                        "max_requests": 6}},
        config=config(kind), mix=dict(mix),
        end_to_end=[{"name": n, "unit": "u"} for n in ALL_END_TO_END],
        per_layer=[{"name": n, "unit": "u"} for n in per_layer])


def params(kind: str, seed: int, gain: float = GAIN, dtype=None):
    """The benchmark's weights for the tiny configuration, every layer
    matrix times ``gain`` (the norms kept): at init scale a model this
    narrow is nearly its embedding, and its layers must matter for a
    fault in them to show."""
    import torch

    from pb import spec
    from pb.weights import make_params
    from repro_torch.models.model import build_model
    cfg = spec.model_config(config(kind), "tiny-" + kind)
    p = make_params(build_model(cfg).param_specs(), seed, "cpu",
                    dtype=dtype or torch.bfloat16)
    for name, leaf in _walk(p["layers"]):
        if not name.startswith("ln"):
            leaf.mul_(gain)
    return p


def _walk(tree, name=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _walk(v, k)
    else:
        yield name, tree


def run(kind: str = "mla", seconds: float = 3.0, seed: int = 2**31 + 5,
        trace: bool = False, limit: float = 0.05, per_layer=(), mix=FAST,
        control: bool = False):
    import time

    import torch

    import run as harness
    # a tiny model gains nothing from many threads; several test workers
    # share the machine's cores
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return harness.run_cell(cell(kind, limit, per_layer, mix), seed,
                                seconds,
                                trace, "cpu", time.monotonic(),
                                control=control, params=params(kind, seed),
                                step_s=STEP_S)
    finally:
        torch.set_num_threads(threads)
