"""Dry run: trace every (arch x shape x mesh) cell on meta tensors.

The port of the JAX package's ``launch/dryrun.py``.  Proves the
distribution config is coherent without GPUs: each cell's entry point
(the train step, ``prefill`` or ``decode_step``) runs on the 16x16
single-pod mesh or the 2x16x16 multi-pod mesh with its params,
optimizer state, batch and decode state placed as DTensors by the rules
(``distributed/sharding.py``) over meta shards.  A fake process group
of 256 or 512 ranks stands behind the mesh (this process is rank 0);
nothing runs on a device.  ``launch/opcost.py`` counts what rank 0's
shards do; the roofline prices it at the H100's rates
(``launch/mesh.py``); the memory fields say whether a cell fits.

``trace_cell`` takes the place of JAX's ``lower_cell``.  The JAX flags
``--bf16-scores``, ``--static-causal`` and ``--unroll`` shape its
``jnp`` attention's score buffers and its layer scan; the port's
attention is the flash kernel, which keeps no score buffer, and its
layers are a Python loop, so the CLI refuses them.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.2-1b \\
        --shape decode_32k [--multi-pod] [--all] [--out results.json]
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import sys
import time
import traceback
from typing import Any, Dict, Optional

import torch
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.config import (KIND_PREFILL, KIND_TRAIN, SHAPES,
                                ModelConfig, ShapeConfig, padded_head_layout,
                                shape_applicable)
from repro_torch.configs import REGISTRY, get_config
from repro_torch.distributed import sharding as shlib
from repro_torch.launch import opcost
from repro_torch.launch.mesh import (HBM_BW, PEAK_FLOPS_BF16,
                                     PRODUCTION_SHAPES, make_production_mesh)
from repro_torch.models.common import NOSHARD, tree_map
from repro_torch.models.model import build_model
from repro_torch.training import train as train_mod

OPTS = {"sp": False, "defer_grad": False, "bf16_grads": False, "ep": False,
        "kv_dtype": "bfloat16"}
REFUSED = {
    "--bf16-scores": "the port's attention is the flash kernel, which keeps "
                     "no score buffer",
    "--static-causal": "the flash kernel already skips the masked "
                       "upper triangle",
    "--unroll": "the port's layers are a Python loop, not a scan",
}


def _rules_for(shape: ShapeConfig, cfg: Optional[ModelConfig] = None):
    if OPTS["ep"] and cfg is not None and cfg.n_experts > 0:
        return shlib.EP_RULES          # MoE archs only
    if shape.name.startswith("long"):
        return shlib.LONG_CONTEXT_RULES
    if OPTS["sp"] and shape.kind == KIND_TRAIN:
        return shlib.SP_RULES
    return shlib.BASE_RULES


def _place_tree(tree, placements, mesh):
    """Meta DTensors of ``tree``'s leaves' shapes and dtypes under the
    matching placement lists (without a device mesh, ``tree`` itself)."""
    if not isinstance(mesh, DeviceMesh):
        return tree
    if isinstance(tree, tuple):                      # AdamWState
        return type(tree)(*(_place_tree(t, pl, mesh)
                            for t, pl in zip(tree, placements)))
    return tree_map(lambda t, pl: shlib.place_abstract(t.shape, t.dtype,
                                                       mesh, pl),
                    tree, placements)


def _axis(mesh, name: str) -> int:
    return shlib.axis_sizes(mesh).get(name, 1)


def trace_cell(cfg: ModelConfig, shape: ShapeConfig, mesh, *,
               pad_heads: bool = False, debug: bool = False):
    """Runs one (arch x shape) cell's entry point on ``mesh`` under an
    ``OpCounter``; with no mesh, one device's plain meta tensors.
    Returns (counter, aux): aux holds the entry's name, its microbatch
    count and the memory fields."""
    from torch.distributed.tensor.experimental import implicit_replication
    if mesh is None:
        mesh = shlib.MeshShape((1, 1), ("data", "model"))
    if pad_heads:
        padded = padded_head_layout(cfg, _axis(mesh, "model"))
        if padded:
            cfg = dataclasses.replace(cfg, internal_pad_q_heads=padded)
    if OPTS["ep"] and cfg.n_experts:
        tp = _axis(mesh, "model")
        cfg = dataclasses.replace(
            cfg, internal_pad_experts=-(-cfg.n_experts // tp) * tp)
    rules = _rules_for(shape, cfg)
    model = build_model(cfg, shlib.MeshSharding(mesh, rules)
                        if isinstance(mesh, DeviceMesh) else NOSHARD,
                        kv_dtype=OPTS["kv_dtype"])
    params = _place_tree(model.abstract_params(),
                         shlib.tree_shardings(model.specs, mesh, rules), mesh)
    ins = model.input_specs(shape)
    batch = _place_tree(ins, shlib.batch_shardings(ins, mesh, rules), mesh)
    counter = opcost.OpCounter(debug=debug)
    aux: Dict[str, Any] = {}
    if shape.kind == KIND_TRAIN:
        dp = _axis(mesh, "data") * _axis(mesh, "pod")
        n_micro = train_mod.pick_n_microbatches(
            cfg, shape, dp,
            sp_degree=_axis(mesh, "model") if OPTS["sp"] else 1)
        step = train_mod.make_train_step(
            model, n_micro=n_micro, defer_grad_sync=OPTS["defer_grad"],
            bf16_grad_sync=OPTS["bf16_grads"])
        opt_pl = train_mod.train_shardings(model, mesh, ins, rules=rules).opt
        opt = _place_tree(train_mod.abstract_opt_state(model), opt_pl, mesh)
        args = (params, opt, batch)
        aux.update(entry="train_step", n_micro=n_micro)
    elif shape.kind == KIND_PREFILL:
        step = model.prefill
        args = (params, batch)
        aux["entry"] = "prefill"
    else:
        specs = model.decode_state_specs(shape.global_batch, shape.seq_len)
        state = _place_tree(
            model.abstract_decode_state(shape.global_batch, shape.seq_len),
            shlib.tree_shardings(specs, mesh, rules), mesh)
        args = (params, state, batch["tokens"])
        step = model.decode_step
        aux["entry"] = "serve_step(decode)"
    arg_bytes = counter.register_arguments(args)
    with implicit_replication(), counter:
        out = step(*args)
    out_bytes = opcost.local_bytes(out)
    alias = opcost.aliased_bytes(out, args)
    peak = counter.summary.peak_live_bytes
    aux["mem"] = {
        "argument_bytes": arg_bytes,
        "output_bytes": out_bytes,
        "alias_bytes": alias,
        # the trace's peak of live non-argument bytes, less the outputs
        # it ends with: peak_hint is then that peak plus the arguments
        "temp_bytes": max(0, peak - (out_bytes - alias)),
        "peak_hint": arg_bytes + max(0, peak - (out_bytes - alias))
        + out_bytes - alias,
    }
    del out
    return counter, aux


# ---------------------------------------------------------------------------
# roofline terms
# ---------------------------------------------------------------------------
def roofline(cfg: ModelConfig, shape: ShapeConfig,
             summary: opcost.CostSummary, n_devices: int) -> Dict[str, Any]:
    """JAX's fields and formulas at the H100's rates: compute at the
    peak of each op's type, memory at HBM_BW, collectives at each
    group's link rate."""
    flops = summary.flops
    byts = summary.bytes_native
    wire = summary.wire_bytes
    t_comp = summary.compute_s
    t_mem = byts / HBM_BW
    t_coll = summary.collective_s
    terms = {"compute": t_comp, "memory": t_mem, "collective": t_coll}
    bottleneck = max(terms, key=terms.get)
    n = cfg.active_param_count()
    if shape.kind == KIND_TRAIN:
        model_flops = 6.0 * n * shape.tokens
    elif shape.kind == KIND_PREFILL:
        model_flops = 2.0 * n * shape.tokens
    else:
        model_flops = 2.0 * n * shape.global_batch
    model_flops_dev = model_flops / n_devices
    bound = max(t_comp, t_mem, t_coll)
    return {
        "flops_per_dev": flops,
        "bytes_per_dev": byts,
        "bytes_per_dev_raw": summary.bytes_accessed,
        "wire_bytes_per_dev": wire,
        "t_compute": t_comp, "t_memory": t_mem, "t_collective": t_coll,
        "bottleneck": bottleneck,
        "model_flops_per_dev": model_flops_dev,
        "useful_flops_frac": (model_flops_dev / flops) if flops else 0.0,
        "step_time_bound": bound,
        "roofline_frac": (min(1.0, model_flops_dev / PEAK_FLOPS_BF16 / bound)
                          if bound > 0 else 0.0),
        "collectives": summary.collectives,
        "trip_counts": summary.trip_counts,
        "kernels": summary.kernels,
    }


@contextlib.contextmanager
def fake_world(world_size: int):
    """A process group of ``world_size`` ranks on torch's fake backend
    (its collectives do nothing: the meta shards hold no values), this
    process rank 0; destroyed on exit."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(),
                            world_size=world_size, rank=0)
    try:
        yield
    finally:
        dist.destroy_process_group()


def run_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
             verbose: bool = True, pad_heads: bool = False,
             mesh=None, global_batch: Optional[int] = None
             ) -> Optional[Dict[str, Any]]:
    """One cell on the production mesh (made here unless ``mesh`` is
    given; the caller's process group must then be behind it), its batch
    cut to ``global_batch`` if given."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    if global_batch is not None:
        shape = dataclasses.replace(shape, global_batch=global_batch)
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        if verbose:
            print(f"SKIP {arch} x {shape_name}: {why}")
        return None
    mesh = mesh if mesh is not None else make_production_mesh(
        multi_pod=multi_pod)
    n_dev = mesh.size()
    t0 = time.time()
    counter, aux = trace_cell(cfg, shape, mesh, pad_heads=pad_heads)
    t_trace = time.time() - t0
    rf = roofline(cfg, shape, counter.summary, n_dev)
    mesh_name = "x".join(str(s) for s in mesh.shape)
    result = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
              "global_batch": shape.global_batch,
              "n_devices": n_dev, "entry": aux["entry"],
              "n_micro": aux.get("n_micro"), "trace_s": round(t_trace, 2),
              "mem": aux["mem"], **rf}
    if verbose:
        mem = aux["mem"]
        print(f"OK {arch} x {shape_name} [{mesh_name}] "
              f"batch={shape.global_batch} trace={t_trace:.1f}s "
              f"flops/dev={rf['flops_per_dev']:.3e} "
              f"bytes/dev={rf['bytes_per_dev']:.3e} "
              f"wire/dev={rf['wire_bytes_per_dev']:.3e} "
              f"bottleneck={rf['bottleneck']} "
              f"bound={rf['step_time_bound']:.4g}s "
              f"roofline={rf['roofline_frac']:.2%}", flush=True)
        print(f"   mem/dev: args={mem['argument_bytes'] / 1e9:.2f}GB "
              f"temp={mem['temp_bytes'] / 1e9:.2f}GB "
              f"aliased={mem['alias_bytes'] / 1e9:.2f}GB "
              f"peak_hint={mem['peak_hint'] / 1e9:.2f}GB", flush=True)
    return result


def _one_cell(task):
    """A worker process's cell: its own fake process group and mesh ->
    ("ok", result) or ("fail", (arch, shape, mesh, why))."""
    arch, name, shape, names, opts, pad_heads, global_batch = task
    OPTS.update(opts)
    mesh_name = "x".join(str(d) for d in shape)
    try:
        with fake_world(int(torch.Size(shape).numel())):
            from torch.distributed.device_mesh import init_device_mesh
            mesh = init_device_mesh("cpu", shape, mesh_dim_names=names)
            return "ok", run_cell(arch, name, mesh=mesh, pad_heads=pad_heads,
                                  global_batch=global_batch)
    except Exception as e:   # noqa: BLE001
        why = _failed_op(e)
        print(f"FAIL {arch} x {name} [{mesh_name}]: {why}", flush=True)
        return "fail", (arch, name, mesh_name, why)


def _parse_mesh(text: str):
    """"16x16" -> ((16, 16), ("data", "model")); three dims add "pod"."""
    shape = tuple(int(x) for x in text.split("x"))
    names = ("data", "model") if len(shape) == 2 else ("pod", "data",
                                                        "model")
    if len(shape) not in (2, 3):
        raise ValueError(f"--mesh {text}: two or three dims")
    return shape, names


def _failed_op(exc: BaseException) -> str:
    """The innermost frame of the model's or DTensor's code that raised,
    and the exception."""
    frames = traceback.extract_tb(exc.__traceback__)
    where = next((f for f in reversed(frames)
                  if "repro_torch" in f.filename), frames[-1] if frames
                 else None)
    loc = f"{where.filename.split('src/')[-1]}:{where.lineno}" if where \
        else "?"
    return f"{loc}: {type(exc).__name__}: {str(exc)[:300]}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--pad-heads", action="store_true",
                    help="pad q heads per GQA group to divide TP")
    ap.add_argument("--sp", action="store_true",
                    help="sequence-parallel residual stream (train)")
    ap.add_argument("--defer-grad", action="store_true",
                    help="one gradient all-reduce per step")
    ap.add_argument("--bf16-grads", action="store_true",
                    help="bf16 gradient accumulation (half grad wire)")
    ap.add_argument("--int8-kv", action="store_true",
                    help="int8 KV cache with per-token-head scales")
    ap.add_argument("--ep", action="store_true",
                    help="expert parallelism: shard (padded) experts "
                         "over the model axis")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--mesh", default=None,
                    help="another mesh shape, e.g. 1x1 (data x model)")
    ap.add_argument("--global-batch", type=int, default=None,
                    help="each cell at this batch instead of its shape's")
    ap.add_argument("--jobs", type=int, default=1,
                    help="trace the cells in this many worker processes, "
                         "each cell in a fresh one")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=None)
    for flag, why in REFUSED.items():
        ap.add_argument(flag, nargs="?", const=True, default=None,
                        help=f"refused: {why}")
    args = ap.parse_args(argv)
    for flag, why in REFUSED.items():
        if getattr(args, flag[2:].replace("-", "_")) is not None:
            ap.error(f"{flag} has no counterpart in the port: {why}")

    OPTS.update(sp=args.sp, defer_grad=args.defer_grad,
                bf16_grads=args.bf16_grads, ep=args.ep,
                kv_dtype="int8" if args.int8_kv else "bfloat16")
    archs = list(REGISTRY) if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = ([_parse_mesh(args.mesh)] if args.mesh else
                [PRODUCTION_SHAPES[mp] for mp in
                 ([False, True] if args.both_meshes else [args.multi_pod])])

    results, failures = [], []
    if args.jobs > 1:
        import multiprocessing as mp
        # the train cells first: the longest traces start first
        tasks = sorted(((arch, name, shape, names, dict(OPTS),
                         args.pad_heads, args.global_batch)
                        for shape, names in meshes for arch in archs
                        for name in shapes),
                       key=lambda t: SHAPES[t[1]].kind != KIND_TRAIN)
        with mp.get_context("spawn").Pool(args.jobs,
                                          maxtasksperchild=1) as pool:
            for kind, r in pool.imap(_one_cell, tasks):
                if kind == "fail":
                    failures.append(r)
                elif r:
                    results.append(r)
        meshes = []
    for shape, names in meshes:
        with fake_world(int(torch.Size(shape).numel())):
            from torch.distributed.device_mesh import init_device_mesh
            mesh = init_device_mesh("cpu", shape, mesh_dim_names=names)
            for arch in archs:
                for name in shapes:
                    try:
                        r = run_cell(arch, name, mesh=mesh,
                                     pad_heads=args.pad_heads,
                                     global_batch=args.global_batch)
                        if r:
                            results.append(r)
                    except Exception as e:   # noqa: BLE001
                        why = _failed_op(e)
                        mesh_name = "x".join(str(d) for d in shape)
                        failures.append((arch, name, mesh_name, why))
                        print(f"FAIL {arch} x {name} [{mesh_name}]: {why}",
                              flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"results": results, "failures": failures}, f,
                      indent=1)
        print(f"wrote {args.out} ({len(results)} cells, "
              f"{len(failures)} failures)")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
