"""Training launcher: ``python -m repro_torch.launch.train --arch <id> ...``

The port of the JAX package's ``launch/train.py``: the same flags plus
``--device`` (the CUDA card by default; ``cpu`` runs the kernels' plain
versions).  It runs real steps with checkpoint/restart: kill it at any
step and relaunch with the same ``--ckpt-dir`` and it resumes from the
latest manifest bit for bit (the data stream is a pure function of the
step counter).

With no process group in the environment (no ``WORLD_SIZE``) it trains
on one device.  Under ``torchrun`` (or ``RANK`` / ``WORLD_SIZE`` /
``MASTER_ADDR`` / ``MASTER_PORT`` set) every rank joins the group
(``nccl`` on cards, each rank on card ``LOCAL_RANK``; ``gloo`` with
``--device cpu``), builds the host mesh (``make_host_mesh()``: n ranks
over "data", one over "model", JAX's default) and the model with its
``MeshSharding``, and places the params, the ZeRO-1 AdamW state and each
step's batch by ``training.train.train_shardings``; every rank builds
the same global batch and keeps its shard.  Checkpoints hold whole
leaves, so a run restores on any number of ranks.  Rank 0 prints.

    python -m repro_torch.launch.train --arch llama3.2-1b --reduced \\
        --device cpu --steps 4 --ckpt-dir /tmp/ckpt --crash-at 2
    torchrun --nproc_per_node 4 -m repro_torch.launch.train --reduced \\
        --device cpu --steps 4
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import time

import torch

from repro_torch.config import reduce_config
from repro_torch.configs import get_config
from repro_torch.distributed import sharding as shlib
from repro_torch.kernels import flash_prefill as fp
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.common import resolve_device, tree_map
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


def join_group(device: torch.device) -> bool:
    """Joins the process group the environment describes (``torchrun``'s
    variables) and returns True; False when there is none (no
    ``WORLD_SIZE``).  ``nccl`` on cards, each rank on card
    ``LOCAL_RANK``; ``gloo`` on the CPU.  A group that cannot form
    raises: the launcher never trains without the group it was given."""
    if "WORLD_SIZE" not in os.environ:
        return False
    import torch.distributed as dist
    if device.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
        dist.init_process_group("nccl")
    else:
        dist.init_process_group("gloo")
    return True


def place_tree(tree, mesh, placements):
    """Each leaf of ``tree`` (a dict tree, or an ``AdamWState`` of them)
    as a DTensor on ``mesh`` under its placements."""
    if isinstance(tree, tuple):
        return type(tree)(*(place_tree(t, mesh, pl)
                            for t, pl in zip(tree, placements)))
    return tree_map(lambda x, pl: shlib.place(x, mesh, pl), tree, placements)


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
    grouped = join_group(device)
    try:
        return train(args, device, grouped)
    finally:
        if grouped:
            import torch.distributed as dist
            dist.destroy_process_group()


def train(args, device: torch.device, grouped: bool) -> int:
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduce_config(cfg)
    if grouped:
        import torch.distributed as dist
        mesh = make_host_mesh(device_type=device.type)
        model = build_model(cfg, shlib.MeshSharding(mesh))
        rank = dist.get_rank()
    else:
        mesh, model, rank = None, build_model(cfg), 0
    say = print if rank == 0 else (lambda *a, **k: None)
    if mesh is not None:
        say(f"process group: {dist.get_backend()}, world size "
            f"{dist.get_world_size()}; mesh "
            f"{dict(zip(mesh.mesh_dim_names, mesh.shape))}")

    def report_launches():
        # this process's launches of the train path's kernels (0 on the
        # CPU, where the plain versions run)
        say("kernel launches:", json.dumps(
            {"flash_prefill": fp.flash_prefill.launches,
             "flash_prefill_bwd": fp.flash_prefill_bwd.launches}))
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
    if mesh is not None:
        sh = train_mod.train_shardings(model, mesh, make_batch(
            data, cfg, 0, args.global_batch, "meta"))
        params = place_tree(params, mesh, sh.params)
        opt_state = place_tree(opt_state, mesh, sh.opt)

    def batch_at(step):
        batch = make_batch(data, cfg, step, args.global_batch, device)
        return batch if mesh is None else place_tree(batch, mesh, sh.batch)

    start_step = 0
    mgr = None
    if args.ckpt_dir:
        mgr = ckpt_mod.CheckpointManager(args.ckpt_dir)
        latest = mgr.latest_step()
        if latest is not None:
            t0 = time.perf_counter()
            (params, opt_state), _ = mgr.restore((params, opt_state))
            start_step = latest
            say(f"resumed from step {start_step} "
                f"(restore {time.perf_counter() - t0:.2f}s)")

    # under a mesh, plain tensors made inside the step (scalars,
    # positions) join DTensors as replicated
    from torch.distributed.tensor.experimental import implicit_replication
    context = contextlib.nullcontext if mesh is None else implicit_replication
    t0 = time.time()
    metrics = None
    for step in range(start_step, args.steps):
        if step == args.crash_at:
            say(f"fault injection: crashing at step {step}")
            report_launches()
            raise SystemExit(CRASH_EXIT)
        with context():
            params, opt_state, metrics = step_fn(params, opt_state,
                                                 batch_at(step))
        if step % args.log_every == 0 or step == args.steps - 1:
            say(f"step {step:5d} loss {_scalar(metrics['loss']):.4f} "
                f"lr {_scalar(metrics['lr']):.2e} "
                f"gnorm {_scalar(metrics['grad_norm']):.3f} "
                f"({time.time() - t0:.3f}s)")
        if mgr and ((step + 1) % args.ckpt_every == 0
                    or step == args.steps - 1):
            ts = time.perf_counter()
            m = mgr.save(step + 1, (params, opt_state))
            say(f"  ckpt @{step + 1}: "
                f"new {m['delta']['new_bytes'] / 1e6:.1f}MB "
                f"reused {m['delta']['reused_bytes'] / 1e6:.1f}MB "
                f"(save {time.perf_counter() - ts:.2f}s)")
    if metrics is not None:
        say("final loss:", _scalar(metrics["loss"]))
    report_launches()
    return 0


def _scalar(x) -> float:
    return float(x.full_tensor() if shlib.is_dtensor(x) else x)


if __name__ == "__main__":
    raise SystemExit(main())
