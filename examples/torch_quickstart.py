"""Quickstart on the PyTorch port: the paper's sizing engine + a tiny
model served end-to-end, on the CUDA card (``--device cpu`` runs the
kernels' plain versions on the host).

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
        [--full-width]

``--full-width`` serves llama3.2-1b at its published width and depth,
with the KV budget scaled by the ratio of the two block sizes, so the
engine holds the same number of blocks and slots as the reduced run.
"""
import argparse

import numpy as np

from repro_torch.configs.paper_models import PAPER_MODELS
from repro_torch.core import sizing
from repro_torch.launch.serve import width_config
from repro_torch.models.common import device_line, resolve_device
from repro_torch.serving import EngineConfig, SamplingParams, ServingEngine


def run(full_width: bool = False, device=None, params=None) -> str:
    """Run the quickstart; returns the text it printed."""
    out = []

    def say(*parts):
        line = " ".join(map(str, parts))
        print(line)
        out.append(line)

    device = resolve_device(device)
    say(device_line(device))
    # 1. Architecture-variant-aware sizing (paper §III-A) -----------------
    say("=== KV cache sizing across attention variants (Table I/III) ===")
    for name, cfg in PAPER_MODELS.items():
        r = sizing.sizing_report(cfg)
        say(f"{name:16s} {r.variant:4s} {r.per_token_layer:7.0f} B/tok/layer"
            f"  (MHA-equivalent {r.mha_equivalent:6.0f} B, "
            f"{r.compression:5.1f}x)  batch {r.max_batch_status_quo:4d}"
            f" -> {r.max_batch_arch_aware:4d}")

    # 2. Serve a tiny llama with the predictive multi-tier cache ---------
    say("\n=== Serving with predictive multi-tier KV cache ===")
    cfg, budget = width_config("llama3.2-1b", full_width, 16e6)
    eng = ServingEngine(cfg, EngineConfig(max_len=256,
                                          kv_budget_bytes=budget),
                        params=params, device=device)
    say(f"decode slots (sizing-engine admission): {eng.scheduler.n_slots}"
        f", block = {eng.manager.block_tokens} tokens")
    rng = np.random.default_rng(0)
    system_prompt = [int(t) for t in rng.integers(0, 200, size=128)]
    for i in range(4):
        user = [int(t) for t in rng.integers(0, 200, size=16)]
        eng.submit(system_prompt + user,
                   params=SamplingParams(max_new_tokens=8),
                   session_id=f"user{i}", block_type="system_prompt")
    stats = eng.run()
    eng.shutdown()
    s, c = stats["scheduler"], stats["cache"]
    say(f"served {s['done']} requests; prefix-hit blocks "
        f"{s['prefix_hit_blocks']} (system prompt reused, prefill "
        f"skipped); dedup hits {c['dedup']['dedup_hits']}; "
        f"hot hit-rate {c['hit_rate_hot']:.0%}")
    return "\n".join(out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="the CUDA card (default) or cpu")
    ap.add_argument("--full-width", action="store_true",
                    help="llama3.2-1b at its published width and depth")
    args = ap.parse_args(argv)
    run(args.full_width, device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
