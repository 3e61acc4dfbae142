#!/usr/bin/env python3
"""The readings a cell's limit is set from, in one process.

    python3 perfbench/readings.py --workload <cell> --seeds 1,2,3 \
        --seconds 20 [--control N]

For each seed it makes the weights, serves the cell's traffic at its
own rate for ``--seconds`` and holds the sample of finished requests to
the float32 reference: the widest gap of a served token is the seed's
lower reading.  On the first ``--control`` seeds it also puts the
reference computed in float8 (e4m3) in the program's place: its picks
at the same prompts and served tokens go through the same comparison
and verdict as the served tokens, and ``control_correct`` has to read
false.  One JSON line a seed; the check's lines on standard error.  The
benchmark's own runs never run the control.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--control", type=int, default=0)
    args = ap.parse_args(argv)
    run.fixed_caches(run.ROOT)
    sys.path.insert(0, str(run.ROOT / "src"))
    import torch

    from pb import spec
    if not torch.cuda.is_available():
        print("the readings run on a CUDA card", file=sys.stderr)
        return 2
    cell = spec.load_cell(args.workload, run.ROOT)
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        t0 = time.monotonic()
        out, lines, ctx = run.run_cell(cell, seed, args.seconds, False, "cuda",
                                   t0, control=i < args.control)
        chk = ctx.check
        for ln in lines:
            print(ln, file=sys.stderr, flush=True)
        print(json.dumps({
            "workload": args.workload, "seed": seed,
            "gap_max": chk.get("gap_max"), "control": chk.get("control"),
            "control_correct": chk.get("control_correct"),
            "positions": chk.get("positions"),
            "requests": chk.get("requests"),
            "check_s": chk.get("seconds"), "correct": out["correct"],
            "limit": out["check"]["served_gap"]["limit"],
            "metrics": {k: v["value"] for k, v in out["metrics"].items()},
            "wall_s": time.monotonic() - t0}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
