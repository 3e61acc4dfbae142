#!/usr/bin/env python3
"""Train llama3.2-1b at full width and depth for a few AdamW steps under
several learning-rate schedules on one CUDA card, with the port's kernels
and with their plain versions, and print each run's losses and gradient
norms (one JSON line a run).

    PYTHONPATH=src python3 scripts/train_schedule_probe.py

The step is ``chip_smoke.py``'s train step: 8 sequences of 1024 tokens
from the seekable synthetic stream, two micro-steps, bf16 params from
seed 0.  It shows which schedules a few-step smoke run can use: a short
warmup to a high peak makes Adam's first update a sign step of the
warmup's first lr on every weight.
"""
import json
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch.train import make_batch  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.training import data as data_mod  # noqa: E402
from repro_torch.training import optimizer as opt_mod  # noqa: E402
from repro_torch.training import train as train_mod  # noqa: E402

# (peak lr, warmup steps, kernel backend, steps)
RUNS = ((1e-3, 2, None, 3), (1e-3, 2, "torch", 3), (1e-3, 100, None, 8),
        (3e-4, 100, None, 8), (1e-4, 2, None, 8), (3e-5, 2, None, 8),
        (1e-5, 2, None, 8))


def main() -> int:
    if not torch.cuda.is_available():
        print("train_schedule_probe: needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("llama3.2-1b")
    model = build_model(cfg)
    data = data_mod.SyntheticLM(data_mod.DataConfig(
        vocab_size=cfg.vocab_size, seq_len=1024, global_batch=8))
    batches = [make_batch(data, cfg, s, 8, "cuda") for s in range(8)]
    params0 = model.init_params(0, device="cuda")
    print(json.dumps({"card": torch.cuda.get_device_name(0)}), flush=True)
    for lr, warmup, backend, steps in RUNS:
        step = train_mod.make_train_step(
            model, adamw=opt_mod.AdamWConfig(lr=lr, warmup_steps=warmup,
                                             total_steps=100),
            n_micro=2, backend=backend)
        params, state = params0, opt_mod.init_state(params0)
        out = []
        for s in range(steps):
            params, state, m = step(params, state, batches[s])
            out.append((float(m["loss"]), float(m["grad_norm"])))
        print(json.dumps({"lr": lr, "warmup": warmup, "backend": backend,
                          "loss_grad_norm": out}), flush=True)
        del params, state
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
