"""Training launcher: ``python -m repro_torch.launch.train --arch <id> ...``

The port of the JAX package's ``launch/train.py``: the same flags plus
``--device`` (the CUDA card by default; ``cpu`` runs the kernels' plain
versions).  It runs real steps with checkpoint/restart: kill it at any
step and relaunch with the same ``--ckpt-dir`` and it resumes from the
latest manifest bit for bit (the data stream is a pure function of the
step counter).  One device, no mesh.

    python -m repro_torch.launch.train --arch llama3.2-1b --reduced \\
        --device cpu --steps 4 --ckpt-dir /tmp/ckpt --crash-at 2
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.config import reduce_config
from repro_torch.configs import get_config
from repro_torch.models.common import resolve_device
from repro_torch.models.model import build_model
from repro_torch.training import checkpoint as ckpt_mod
from repro_torch.training import data as data_mod
from repro_torch.training import optimizer as opt_mod
from repro_torch.training import train as train_mod
from repro_torch.training.optimizer import AdamWConfig

CRASH_EXIT = 17


def make_batch(data, cfg, step: int, global_batch: int, device) -> dict:
    """The data stream's batch at ``step`` on ``device``; the VLM gets
    zero patches and the enc-dec zero frames (bf16), as the JAX
    launcher gives them."""
    raw = data.batch(step)
    out = {k: torch.from_numpy(raw[k]).to(device)
           for k in ("tokens", "labels")}
    if cfg.family == "vlm":
        out["patches"] = torch.zeros((global_batch, cfg.n_patches,
                                      cfg.d_model), dtype=torch.bfloat16,
                                     device=device)
    if cfg.family == "encdec":
        out["frames"] = torch.zeros((global_batch, cfg.enc_len, cfg.d_model),
                                    dtype=torch.bfloat16, device=device)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--reduced", action="store_true",
                    help="smoke-scale config (CPU)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--n-micro", type=int, default=1)
    ap.add_argument("--grad-compress", action="store_true")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--crash-at", type=int, default=-1,
                    help=f"fault injection: exit({CRASH_EXIT}) at this step")
    ap.add_argument("--device", default="cuda",
                    help="the CUDA card (default) or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduce_config(cfg)
    model = build_model(cfg)
    adamw = AdamWConfig(lr=args.lr, total_steps=max(args.steps, 100),
                        warmup_steps=max(5, args.steps // 20))
    step_fn = train_mod.make_train_step(
        model, adamw=adamw, n_micro=args.n_micro,
        grad_compress=args.grad_compress)
    data = data_mod.SyntheticLM(data_mod.DataConfig(
        vocab_size=cfg.vocab_size, seq_len=args.seq_len,
        global_batch=args.global_batch))

    params = model.init_params(0, device=device)
    opt_state = opt_mod.init_state(params)
    start_step = 0
    mgr = None
    if args.ckpt_dir:
        mgr = ckpt_mod.CheckpointManager(args.ckpt_dir)
        latest = mgr.latest_step()
        if latest is not None:
            (params, opt_state), _ = mgr.restore((params, opt_state))
            start_step = latest
            print(f"resumed from step {start_step}")

    t0 = time.time()
    metrics = None
    for step in range(start_step, args.steps):
        if step == args.crash_at:
            print(f"fault injection: crashing at step {step}")
            raise SystemExit(CRASH_EXIT)
        params, opt_state, metrics = step_fn(
            params, opt_state,
            make_batch(data, cfg, step, args.global_batch, device))
        if step % args.log_every == 0 or step == args.steps - 1:
            print(f"step {step:5d} loss {float(metrics['loss']):.4f} "
                  f"lr {float(metrics['lr']):.2e} "
                  f"gnorm {float(metrics['grad_norm']):.3f} "
                  f"({time.time() - t0:.1f}s)")
        if mgr and ((step + 1) % args.ckpt_every == 0
                    or step == args.steps - 1):
            m = mgr.save(step + 1, (params, opt_state))
            print(f"  ckpt @{step + 1}: "
                  f"new {m['delta']['new_bytes'] / 1e6:.1f}MB "
                  f"reused {m['delta']['reused_bytes'] / 1e6:.1f}MB")
    if metrics is not None:
        print("final loss:", float(metrics["loss"]))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
