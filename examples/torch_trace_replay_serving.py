"""Trace-driven end-to-end serving replay on the PyTorch port (paper
§V-E at the engine), on the CUDA card (``--device cpu`` runs the
kernels' plain versions on the host).

Replays a slice of the synthetic agentic workload through the live
``ServingEngine`` (paged KV pool, CoW prefix sharing, chunked prefill,
async tier transfers) under a virtual clock, and compares the Bayesian
eviction policy against LRU on the same trace: engine-level tier-0/1
hit rate, TTFT/TBT percentiles and virtual throughput.

    PYTHONPATH=src python examples/torch_trace_replay_serving.py
        [--device cpu] [--n-sessions 8] [--max-turns 5]
"""
import argparse

from repro_torch.models.common import device_line, resolve_device
from repro_torch.traces.serving_replay import (ServingReplayConfig,
                                               run_serving_replay)


def replay(policy: str, n_sessions: int = 8, max_turns: int = 5,
           device=None, params=None, **kw):
    """One policy's replay; ``kw`` overrides ``ServingReplayConfig``
    fields (``async_transfers=False`` makes it deterministic)."""
    # tier capacities sized for pressure at this reduced trace scale
    # (the full-scale defaults live in ENGINE_REPLAY_BLOCKS)
    return run_serving_replay(ServingReplayConfig(
        workload="agentic", policy=policy, n_sessions=n_sessions,
        max_turns=max_turns, hot_blocks=40, t1_blocks=56, **kw),
        device=device, params=params)


def run(n_sessions: int = 8, max_turns: int = 5, device=None,
        params=None) -> str:
    """Replay under both policies; returns the text it printed."""
    out = []

    def say(*parts):
        line = " ".join(map(str, parts))
        print(line)
        out.append(line)

    device = resolve_device(device)
    say(device_line(device))
    say("agentic trace -> live engine, bayesian vs lru "
        "(~1-2 min on CPU)\n")
    results = []
    for policy in ("bayesian", "lru"):
        r = replay(policy, n_sessions, max_turns, device=device,
                   params=params)
        results.append(r)
        say(f"[{policy}]")
        say(f"  engine hit rate (tiers 0-1): {100 * r.engine_hit_rate:.1f}%"
            f"  (served from cache at any tier: {100 * r.reuse_rate:.1f}%)")
        say(f"  hit source: pool/CoW {r.cow_share_hits}, "
            f"tier payload inject {r.inject_hits} "
            f"(t0 {r.hot_hits_t0} / t1 {r.hot_hits_t1})")
        say(f"  promotions {r.promotions}, demotions {r.demotions}")
        say(f"  TTFT p50/p95: {1e3 * r.ttft_p50:.1f} / "
            f"{1e3 * r.ttft_p95:.1f} ms (virtual)")
        say(f"  TBT p50/p95:  {1e3 * r.tbt_p50:.1f} / "
            f"{1e3 * r.tbt_p95:.1f} ms (virtual)")
        say(f"  throughput: {r.throughput_tok_s:.0f} tok/s (virtual), "
            f"{r.requests_done} turns, wall {r.wall_s:.0f}s\n")
    bay, lru = results
    say(f"bayesian - lru hit-rate gap: "
        f"{100 * (bay.engine_hit_rate - lru.engine_hit_rate):+.1f} pts")
    return "\n".join(out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="the CUDA card (default) or cpu")
    ap.add_argument("--n-sessions", type=int, default=8)
    ap.add_argument("--max-turns", type=int, default=5)
    args = ap.parse_args(argv)
    run(args.n_sessions, args.max_turns, device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
