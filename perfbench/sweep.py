#!/usr/bin/env python3
"""The knee sweep: one cell at a list of offered rates, in one process.

    python3 perfbench/sweep.py --workload <cell> --rates 0.5,1,2 \
        --seconds 40 --seed 7

For each offered rate (sessions a second) it serves the cell's traffic
for ``--seconds`` on a fresh engine over the same weights and prints one
JSON line: requests due and finished, output tokens a second, the tails
of time to first token and of the mean time between tokens, and the
requests waiting for a slot or for their prompt's prefill at each
quarter of the window.  The backlog grew where that count rises from
the half to the close; the knee is the highest rate at which it does
not.  The check against the reference is skipped.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import run


def backlog_at(win, frac: float) -> int:
    """Requests waiting for a slot or for their prefill after the last
    step before ``frac`` of the window."""
    t = win.t_open + frac * win.seconds
    before = [s.waiting + s.prefilling for s in win.steps if s.t1 <= t]
    return before[-1] if before else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=40.0)
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args(argv)
    run.fixed_caches(run.ROOT)
    sys.path.insert(0, str(run.ROOT / "src"))
    import torch

    from pb import readers, spec, serve
    from pb.weights import make_params
    from repro_torch.models.model import build_model
    if not torch.cuda.is_available():
        print("the sweep runs on a CUDA card", file=sys.stderr)
        return 2
    cell = spec.load_cell(args.workload, run.ROOT)
    cfg = spec.model_config(cell.config, cell.config_name)
    params = make_params(build_model(cfg).param_specs(), args.seed, "cuda")
    cell.cell = dict(cell.cell, check=dict(cell.cell["check"],
                                           max_requests=0))
    for rate in (float(r) for r in args.rates.split(",")):
        t0 = time.monotonic()
        _, _, ctx = run.run_cell(cell, args.seed, args.seconds, False,
                                 "cuda", t0, rate=rate, params=params)
        w = ctx.window
        done = sum(1 for h in w.handles if h.done_t is not None
                   and h.done_t <= w.t_close)
        q = [backlog_at(w, f) for f in (0.25, 0.5, 0.75, 1.0)]
        print(json.dumps({
            "workload": args.workload, "sessions_per_s": rate,
            "due": len(w.handles), "finished": done,
            "output_tok_per_s": readers.output_tok_per_s(ctx),
            "ttft_p50_ms": 1e3 * readers.pctl(readers.ttfts(w), 0.5),
            "ttft_p95_ms": readers.ttft_p95_ms(ctx),
            "tbt_p95_ms": readers.tbt_p95_ms(ctx),
            "backlog_quarters": q, "backlog_grew": q[3] > q[1] + 1,
            "steps": len(w.steps)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
