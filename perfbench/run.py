#!/usr/bin/env python3
"""The benchmark of the PyTorch / CUDA port: one cell, one run.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout: loads the cell (``BENCHMARK.json``,
``perfbench/cells/<cell>.json`` and the configuration and traffic mix it
names), makes the weights on the card from the seed, warms the served
path up on a throwaway engine, then serves the cell's open-loop traffic
through ``repro_torch``'s front-end and engine for ``--seconds``.  Once
the window has closed it frees the program's state and holds a sample
of the finished requests' served tokens to the plain reference
(``perfbench/reference``).  The last line of standard output is one
JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device`` (+ ``breakdown`` with ``--trace 1``) and ``check``, each
number compared beside its limit; the same numbers end standard error.

It exits non-zero and prints no result without a CUDA card (or fewer
cards than the cell asks for), without the program beside it, or when
JAX or the JAX package was loaded into this process.
"""
from __future__ import annotations

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
if str(HERE) not in sys.path:
    sys.path.insert(0, str(HERE))

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def say(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def forbidden_modules(names=None):
    """Top-level names among ``names`` (the loaded modules by default)
    that the port must not pull in, compared whole (``repro_torch`` is
    not ``repro``)."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def fixed_caches(root: Path) -> None:
    """Build and kernel caches at fixed paths inside the checkout; the
    port's own ``nvcc`` libraries go to ``build/repro_torch``."""
    os.environ["TORCH_EXTENSIONS_DIR"] = str(root / "build" / "torch_ext")
    os.environ["TRITON_CACHE_DIR"] = str(root / "build" / "triton")


def warm_up(cfg, ecfg, params, device, vocab: int) -> None:
    """Run every entry point the window drives on a throwaway engine:
    chunk prefill from 0 and at an offset past a shared block (a
    copy-on-write hit), decode over several rows; then free its pool."""
    import numpy as np

    from repro_torch.core import sizing
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.frontend import ServingFrontend
    from repro_torch.serving.request import SamplingParams

    rng = np.random.default_rng(12345)
    bt = sizing.block_tokens(cfg)
    eng = ServingEngine(cfg, ecfg, params=params, device=device)
    fe = ServingFrontend(eng)
    a = [int(x) for x in rng.integers(1, vocab, bt + 90)]
    greedy = SamplingParams(max_new_tokens=4, temperature=0.0)
    fe.submit(a, params=greedy, retain_blocks=True)
    for _ in range(4):
        fe.submit([int(x) for x in rng.integers(1, vocab, 70)],
                  params=greedy)
    while fe.in_flight():
        fe.pump_once()
    fe.submit(a[:bt] + [int(x) for x in rng.integers(1, vocab, 80)],
              params=greedy)
    while fe.in_flight():
        fe.pump_once()
    fe.stop(drain=False)
    eng.release_resources()


def run_cell(cell, seed: int, seconds: float, trace: bool, device: str,
             t_start: float, rate: float = None, control: bool = False,
             params=None, step_s: float = None) -> tuple:
    """One run of ``cell``; returns (the result dict, the check's
    lines, the run's ``Ctx``).  ``device`` "cpu" is for the test suite;
    ``rate`` overrides the cell's (the knee sweep), ``control`` also
    judges the float8 reference's picks as the program's tokens are
    judged (``readings.py``), ``params``
    reuses weights already made from this seed; ``step_s`` (the test
    suite) serves on a virtual clock that each engine step advances by
    that many seconds, so a slow CPU serves the same window."""
    import torch

    from pb import check, readers, spec, traffic
    from pb import trace as tr
    from pb.serve import serve_window
    from pb.weights import make_params
    from reference import forward as reference
    from repro_torch.models.model import build_model
    from repro_torch.serving.engine import EngineConfig, ServingEngine
    from repro_torch.serving.frontend import ServingFrontend

    c = cell.config
    serve = c["serve"]
    cfg = spec.model_config(c, cell.config_name)
    max_len = int(serve["max_len"])
    budget = int(serve["slots"]) * max_len * spec.kv_bytes_per_token(c)
    ecfg = EngineConfig(max_len=max_len, kv_budget_bytes=float(budget),
                        seed=int(seed) % (1 << 31))
    if params is None:
        params = make_params(build_model(cfg).param_specs(), seed, device)
    warm_up(cfg, ecfg, params, device, cfg.vocab_size)
    gc.collect()
    eng = ServingEngine(cfg, ecfg, params=params, device=device)
    if step_s is None:
        fe = ServingFrontend(eng)
    else:
        from repro_torch.serving.frontend import VirtualClock
        fe = ServingFrontend(eng, clock=VirtualClock(), step_time_s=step_s)
    rate = float(cell.cell["sessions_per_s"] if rate is None else rate)
    arrivals = traffic.generate(cell.mix, rate, seconds, seed,
                                cfg.vocab_size, max_len)
    spans = tr.Spans()
    if trace:
        tr.install(fe, eng, spans)
    cuda = device != "cpu"
    if cuda:
        torch.cuda.synchronize()
    setup = time.monotonic() - t_start
    with tr.profiled(trace) as prof:
        win = serve_window(fe, eng, arrivals, seconds,
                           float(serve.get("temperature", 0.0)))
        if cuda:
            torch.cuda.synchronize()
    spans.remove()
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    say(f"window: {len(win.handles)} requests due, {len(win.steps)} steps, "
        f"generator lag max {max(win.lags, default=0.0) * 1e3:.3f} ms, p95 "
        f"{(readers.pctl(win.lags, 0.95) or 0.0) * 1e3:.3f} ms")
    ctx = readers.Ctx(window=win, peak_bytes=peak, setup_s=setup)
    ctx.flops_per_token, ctx.head_flops = spec.family(c).active_flops(
        params, c)
    # prompt tokens the admitted requests have covered by the close, by a
    # hit or by prefill: a request still prefilling counts its cursor
    ctx.prompt_tokens_covered = sum(
        len(h.request.prefill_tokens) - h.request.prefill_left
        for h in win.handles if h.request is not None
        and h.request.prefill_tokens is not None)
    summary = None
    if trace:
        summary = tr.reduce_trace(prof, spans.host) if prof else None
        del prof
        ctx.trace = summary
        ctx.calls = [(k.op,) + tr.call_cost(k) for k in spans.calls]
        if summary is not None:
            say(f"trace: {summary.n_device_events} device events, busy "
                f"{summary.busy_s:.6f} s of {summary.window_s:.6f} s; op "
                f"device s {json.dumps(summary.op_device_s)}")
    spans.calls.clear()
    spans.host.clear()
    ttft, tpot = readers.ttfts(win), readers.tpots(win)
    tails = {f"{name}_p{p}_ms": 1e3 * v for name, vals in (("ttft", ttft),
                                                          ("tbt", tpot))
             for p in (50, 90, 95)
             for v in [readers.pctl(vals, p / 100)] if v is not None}
    tails.update(requests=len(ttft), tbt_requests=len(tpot),
                 output_tok_per_s=readers.output_tok_per_s(ctx))
    say("served: " + json.dumps(tails))
    stats = fe.stats()
    # free the program's state before the reference runs
    fe.stop(drain=False)
    eng.release_resources()
    handles = win.handles
    del eng, fe
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    chk = cell.cell["check"]
    samples = check.finished_sample(handles, seed, int(chk["min_tokens"]),
                                    int(chk["max_requests"]))
    reference.no_tf32()
    limit = float(chk["gap_limit"])
    t_check = time.monotonic()
    if samples:
        ref32 = reference.load(c, params, "fp32")
        got = check.served_gap(ref32, samples, device)
    else:
        got = {"gap_max": None, "positions": 0, "requests": 0}
    got["seconds"] = time.monotonic() - t_check
    gap = got["gap_max"]
    correct = check.verdict(gap, limit) and len(handles) > 0
    lines = [f"checked {got['requests']} requests, {got['positions']} "
             f"served tokens in {got['seconds']:.3f} s"]
    if control and samples:
        # the float8 reference in the program's place, judged as the
        # program's tokens are: its picks at the same positions
        picks = check.control_picks(reference.load(c, params, "fp8"),
                                    samples, device)
        ctl = check.served_gap(ref32, samples, device, chosen=picks)
        got["control"] = ctl["gap_max"]
        got["control_correct"] = check.verdict(ctl["gap_max"], limit)
        verdict = "correct" if got["control_correct"] else "NOT correct"
        lines.append(f"control served_gap {ctl['gap_max']} limit {limit} "
                     f"-> {verdict}")
    failed = stats["shed"] + (0 if correct else max(1, got["requests"]))

    if trace:
        metrics = {}
        for m in cell.per_layer:
            v = spec.metric_reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        metrics = {}
        for m in cell.end_to_end:
            v = readers.END_TO_END[m["name"]](ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    out = {"correct": bool(correct), "attempted": len(handles),
           "failed": int(failed), "metrics": metrics,
           "device": {"platform": "gpu" if cuda else "cpu",
                      "kind": (torch.cuda.get_device_name(0) if cuda
                               else "cpu"),
                      "count": int(cell.bench["chips"]),
                      "memory_peak_bytes": int(peak)}}
    if trace and summary is not None:
        out["device"]["busy_s"] = summary.busy_s
        out["device"]["window_s"] = summary.window_s
        out["breakdown"] = {"device_ops": [list(x) for x in
                                           summary.device_ops],
                            "idle_gaps": [list(x) for x in
                                          summary.idle_gaps]}
    out["check"] = {"served_gap": {"value": gap, "limit": limit}}
    ctx.check = got
    lines.append(f"check served_gap {gap} limit {limit} -> "
                 f"{'correct' if correct else 'NOT correct'}")
    return out, lines, ctx


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    fixed_caches(ROOT)
    if not (ROOT / "BENCHMARK.json").exists():
        say("no BENCHMARK.json at the checkout's root")
        return 2
    from pb import spec
    cell = spec.load_cell(args.workload, ROOT)
    src = ROOT / "src"
    if not (src / "repro_torch").is_dir():
        say(f"the program (src/repro_torch) is not in {ROOT}")
        return 2
    sys.path.insert(0, str(src))
    import torch
    chips = int(cell.bench["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        say(f"{args.workload} needs {chips} CUDA device(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    out, lines, _ = run_cell(cell, args.seed, args.seconds,
                             bool(args.trace), "cuda", T_START)
    bad = forbidden_modules()
    if bad:
        say(f"loaded in this process: {', '.join(bad)}")
        return 3
    for ln in lines:
        say(ln)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
