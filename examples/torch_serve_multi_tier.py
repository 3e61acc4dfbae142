"""End-to-end serving driver on the PyTorch port: batched requests
through the full predictive multi-tier stack, with per-tier stats,
preemption and a replica-failure drill, on the CUDA card (``--device
cpu`` runs the kernels' plain versions on the host).

    PYTHONPATH=src python examples/torch_serve_multi_tier.py
        [--device cpu] [--full-width]

``--full-width`` serves llama3.2-1b at its published width and depth
with the KV budget scaled to hold as many blocks (``width_config``).
"""
import argparse

import numpy as np

from repro_torch.launch.serve import width_config
from repro_torch.models.common import device_line, resolve_device
from repro_torch.serving import EngineConfig, SamplingParams, ServingEngine
from repro_torch.serving.cluster import ReplicaCluster


def run(full_width: bool = False, device=None, params=None) -> str:
    """Run the driver; returns the text it printed."""
    out = []

    def say(*parts):
        line = " ".join(map(str, parts))
        print(line)
        out.append(line)

    device = resolve_device(device)
    say(device_line(device))
    cfg, budget = width_config("llama3.2-1b", full_width, 8e6)
    ecfg = EngineConfig(max_len=256, kv_budget_bytes=budget,
                        policy="bayesian")
    eng = ServingEngine(cfg, ecfg, params=params, device=device)
    rng = np.random.default_rng(1)
    templates = [[int(t) for t in rng.integers(0, 200, size=128)]
                 for _ in range(3)]
    reqs = []
    for i in range(12):
        tpl = templates[i % 3]
        user = [int(t) for t in rng.integers(0, 200, size=24)]
        reqs.append(eng.submit(tpl + user,
                               params=SamplingParams(max_new_tokens=6),
                               session_id=f"s{i}",
                               block_type="system_prompt"))
    stats = eng.run()
    say("=== single engine (paged block-table KV) ===")
    say("done:", stats["scheduler"]["done"],
        " prefix-hit blocks:", stats["scheduler"]["prefix_hit_blocks"])
    if stats.get("allocator"):
        al = stats["allocator"]
        say(f"page pool: {al['n_pages']} pages, peak {al['peak_in_use']} "
            f"in use, {al['shares']} CoW shares, "
            f"{al['cow_copies']} CoW copies")
    if stats.get("async_transfers"):
        aw = stats["async_transfers"]
        say(f"async transfers: {aw['completed']} completed off the step "
            f"loop ({aw['sim_time_total']:.2e}s modelled), "
            f"{aw['failed']} failed")
    for t in stats["cache"]["tiers"][:3]:
        say(f"  tier {t['tier']:10s} used {t['used'] / 1e6:6.2f} MB  "
            f"reads {t['reads']:4d}  writes {t['writes']:4d}  "
            f"evictions {t['evictions']}")
    say("predictor posteriors (observed pairs):")
    for k, v in stats["cache"]["predictor"].items():
        if v["obs"] > 0:
            say(f"  {k:45s} P={v['mean']:.2f} obs={v['obs']:.0f}")
    eng.shutdown()

    say("\n=== 2-replica cluster with failure drill ===")
    # every replica serves the single engine's weights (the JAX cluster
    # makes each replica's from the same seed)
    weights = eng.params
    cluster = ReplicaCluster(engine_factory=lambda: ServingEngine(
        cfg, ecfg, params=weights, device=device), n_replicas=2)
    del eng
    for i in range(8):
        user = [int(t) for t in rng.integers(0, 200, size=24)]
        cluster.submit(templates[0] + user, session_id=f"c{i % 4}",
                       params=SamplingParams(max_new_tokens=4),
                       block_type="system_prompt")
    for e in cluster.engines.values():
        e.step()
    victim = sorted(cluster.engines)[0]
    lost = cluster.fail_replica(victim)
    say(f"killed {victim}: re-dispatched {lost} in-flight requests, "
        f"{cluster.reprefill_tokens} tokens to re-prefill")
    agg = cluster.run()
    say("all completed:", agg["done"],
        f" fleet hot hit-rate: {agg['fleet']['hit_rate_hot']:.2%}")
    cluster.shutdown()
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
