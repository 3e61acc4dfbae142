#!/usr/bin/env python3
"""Every collective of one reduced (arch x shape) cell of the port's dry
run, with the op and the autograd node that made it.

    PYTHONPATH=src python scripts/trace_collectives.py \\
        --arch llama3.2-1b --shape train_4k --mesh 2x2

Traces the cell as ``launch/dryrun.trace_cell`` does (meta tensors over
a fake process group; no device) and prints, per collective in the
order they ran: its kind, result shape and dtype, group size, wire
bytes a rank moves (floats charged at 2 bytes, the width ``hlocost``
charges them at), the autograd node running at the time ("fwd" outside
the backward; remat's recompute runs under the node that needs it) and
the innermost frames of the port that made it; then the totals by
kind.
"""
from __future__ import annotations

import argparse
import collections
import traceback

import torch

from repro_torch.config import SHAPES, reduce_config, reduce_shape
from repro_torch.configs import get_config
from repro_torch.launch import dryrun, opcost


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--mesh", default="2x2", help="data x model")
    ap.add_argument("--frames", type=int, default=3)
    args = ap.parse_args(argv)
    rows = []

    class Logger(opcost.OpCounter):
        def _count(self, func, a, kwargs, ins, res, out):
            name = func._schema.name.split("::")[-1]
            if (func.namespace == "_c10d_functional"
                    and name in opcost.COLLECTIVES):
                g, _ = opcost._group(a[-1])
                rbytes = sum(t.numel() * (2 if t.is_floating_point()
                                          else t.element_size())
                             for t in res)
                node = torch._C._current_autograd_node()
                frames = [f"{f.filename.split('repro_torch/')[-1]}:"
                          f"{f.lineno} {f.name}"
                          for f in traceback.extract_stack()
                          if "repro_torch" in f.filename
                          and "opcost" not in f.filename]
                rows.append((name, tuple(res[0].shape), res[0].dtype, g,
                             opcost.collective_wire(name, rbytes, g),
                             "fwd" if node is None else node.name(),
                             frames[-args.frames:]))
            return super()._count(func, a, kwargs, ins, res, out)

    from torch.distributed.device_mesh import init_device_mesh
    shape = tuple(int(x) for x in args.mesh.split("x"))
    opcost.OpCounter, counter_cls = Logger, opcost.OpCounter
    try:
        with dryrun.fake_world(int(torch.Size(shape).numel())):
            mesh = init_device_mesh("cpu", shape,
                                    mesh_dim_names=("data", "model"))
            dryrun.trace_cell(reduce_config(get_config(args.arch)),
                              reduce_shape(SHAPES[args.shape]), mesh)
    finally:
        opcost.OpCounter = counter_cls
    totals = collections.defaultdict(lambda: [0, 0.0])
    for i, (kind, shp, dt, g, wire, node, frames) in enumerate(rows):
        print(f"{i:3d} {kind} {list(shp)} {str(dt)[6:]} group {g} "
              f"wire2 {wire:g} [{node}]")
        for f in frames:
            print(f"      {f}")
        totals[kind][0] += 1
        totals[kind][1] += wire
    for kind, (n, wire) in totals.items():
        print(f"total {kind}: {n} collectives, wire2 {wire:g} B")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
