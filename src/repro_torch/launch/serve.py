"""Serving launcher CLI: single engine or a multi-replica cluster.

``python -m repro_torch.launch.serve --arch llama3.2-1b --reduced --requests 32``

The cluster machinery lives in ``repro_torch/serving/cluster.py``
(``ReplicaCluster`` + pluggable routing policies); this module is a thin
command line over it and demonstrates the large-scale serving
properties:

  * session affinity via the same consistent-hash ring as the RDMA tier
    (sessions stick to replicas -> prefix caches stay warm) — or
    round-robin / least-loaded routing via ``--routing``;
  * replica failure (``--fail-replica``): the router drops the node,
    in-flight requests re-dispatch to a successor replica and lost KV
    blocks are re-prefilled — the paper's graceful-degradation story;
  * elastic scale-out (``--add-replica``): a replica joins mid-run,
    remapping ~1/n of sessions;
  * wall-clock serving (``--frontend``): the thread-pumped
    ``ServingFrontend`` under open-loop Poisson load from
    ``traces/loadgen.py``, with SLO-aware admission
    (``--qps``/``--duration``/``--ttft-budget-ms``/``--slo-action``)
    and a goodput/shed/TTFT report.

See ``docs/SERVING.md`` for the operations guide.  The port of the JAX
package's ``launch/serve.py``: the same flags plus ``--device`` (the
CUDA card by default; ``cpu`` runs the kernels' plain versions).
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.config import reduce_config
from repro_torch.configs import get_config
from repro_torch.core import sizing
from repro_torch.serving import EngineConfig, SamplingParams, ServingEngine
from repro_torch.serving.cluster import ROUTERS, ReplicaCluster


def width_config(arch: str, full_width: bool, kv_budget_bytes: float):
    """(config, budget): ``arch`` reduced with ``kv_budget_bytes``, or at
    its published width with the budget scaled by the ratio of the two
    block sizes, so that the pool holds as many blocks and slots."""
    full = get_config(arch)
    reduced = reduce_config(full)
    if not full_width:
        return reduced, kv_budget_bytes
    return full, kv_budget_bytes * (sizing.block_bytes(full)
                                    / sizing.block_bytes(reduced))


def run_open_loop(fe, arrivals) -> float:
    """Start ``fe``'s pump thread, submit each arrival at its offset on
    the wall clock, then drain, stop and check the ledger; returns the
    wall seconds from the first offset to the drained stop."""
    fe.start()
    t0 = time.monotonic()
    for a in arrivals:
        dt = (t0 + a.t) - time.monotonic()
        if dt > 0:
            time.sleep(dt)
        fe.submit(list(a.prompt),
                  params=SamplingParams(max_new_tokens=a.max_new),
                  session_id=a.session_id, arrival_t=t0 + a.t,
                  block_types=list(a.block_types), tool=a.tool,
                  retain_blocks=not a.last_turn)
    fe.stop(drain=True)
    wall = time.monotonic() - t0
    fe.check_ledger()
    return wall


def _serve_frontend(args) -> int:
    """Real-clock open-loop serving: background pump thread + Poisson
    schedule, SLO admission, goodput/TTFT report."""
    from repro_torch.serving.frontend import ServingFrontend, SLOConfig
    from repro_torch.traces.loadgen import offered_summary, trace_load
    from repro_torch.traces.serving_replay import ServingReplayConfig, build_engine

    rcfg = ServingReplayConfig(workload=args.workload, seed=args.seed,
                               policy=args.policy, async_transfers=False)
    engine = build_engine(rcfg, device=args.device)
    budget = (args.ttft_budget_ms / 1e3 if args.ttft_budget_ms > 0
              else float("inf"))
    fe = ServingFrontend(engine,
                         slo=SLOConfig(ttft_budget_s=budget,
                                       action=args.slo_action))
    arrivals = trace_load(args.workload, args.qps,
                          duration_s=args.duration, seed=args.seed)
    print(f"offered: {offered_summary(arrivals)}")
    wall = run_open_loop(fe, arrivals)
    st = fe.stats()
    print(f"served {st['done']}/{st['offered']} requests "
          f"({st['shed']} shed, goodput {st['goodput']}) in "
          f"{wall:.1f}s")
    print(f"ttft p50/p99: {st['ttft_p50'] * 1e3:.1f}/"
          f"{st['ttft_p99'] * 1e3:.1f} ms  "
          f"tbt p50/p99: {st['tbt_p50'] * 1e3:.1f}/"
          f"{st['tbt_p99'] * 1e3:.1f} ms  "
          f"est step: {st['est_step_s'] * 1e3:.2f} ms")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--replicas", type=int, default=1)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--routing", default="affine", choices=sorted(ROUTERS),
                    help="cluster request routing policy")
    ap.add_argument("--fail-replica", action="store_true",
                    help="kill a replica mid-run (fault-tolerance demo)")
    ap.add_argument("--add-replica", action="store_true",
                    help="scale out by one replica mid-run")
    ap.add_argument("--policy", default="bayesian",
                    choices=["bayesian", "ema", "lru"])
    ap.add_argument("--frontend", action="store_true",
                    help="wall-clock ServingFrontend under open-loop "
                         "Poisson load (real threads, real clock)")
    ap.add_argument("--workload", default="lmsys",
                    help="loadgen workload (sharegpt/lmsys/agentic/"
                         "file:<path>)")
    ap.add_argument("--qps", type=float, default=8.0,
                    help="offered Poisson rate for --frontend")
    ap.add_argument("--duration", type=float, default=5.0,
                    help="load duration in seconds for --frontend")
    ap.add_argument("--ttft-budget-ms", type=float, default=0.0,
                    help="SLO TTFT budget (0 = no admission control)")
    ap.add_argument("--slo-action", default="shed",
                    choices=["shed", "queue"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device the engines run on (cpu: the "
                         "kernels' plain versions)")
    args = ap.parse_args(argv)

    if args.frontend:
        return _serve_frontend(args)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduce_config(cfg)
    ecfg = EngineConfig(max_len=512, kv_budget_bytes=64e6,
                        policy=args.policy)
    rng = np.random.default_rng(0)
    system = [int(t) for t in rng.integers(0, cfg.vocab_size, size=256)]

    t0 = time.time()
    if args.replicas == 1:
        eng = ServingEngine(cfg, ecfg, device=args.device)
        for i in range(args.requests):
            user = [int(t) for t in rng.integers(0, cfg.vocab_size,
                                                 size=32)]
            eng.submit(system + user,
                       params=SamplingParams(max_new_tokens=args.max_new),
                       session_id=f"s{i % 4}", block_type="system_prompt")
        stats = eng.run()
        eng.shutdown()
    else:
        cluster = ReplicaCluster(cfg, ecfg, n_replicas=args.replicas,
                                 routing=args.routing, device=args.device)
        for i in range(args.requests):
            user = [int(t) for t in rng.integers(0, cfg.vocab_size,
                                                 size=32)]
            cluster.submit(system + user, session_id=f"s{i % 4}",
                           params=SamplingParams(max_new_tokens=args.max_new),
                           block_type="system_prompt")
            if args.fail_replica and i == args.requests // 2:
                cluster.step()
                victim = sorted(cluster.engines)[0]
                lost = cluster.fail_replica(victim)
                print(f"killed {victim}, re-dispatched {lost} requests")
            if args.add_replica and i == args.requests // 2:
                name = cluster.add_replica()
                print(f"scaled out: {name} joined "
                      f"({cluster.n_replicas} replicas)")
        stats = cluster.run()
        cluster.shutdown()
    dt = time.time() - t0
    done = (stats["scheduler"]["done"] if args.replicas == 1
            else stats["done"])
    print(f"served {done} requests in {dt:.1f}s")
    if args.replicas == 1:
        s = stats["scheduler"]
        c = stats["cache"]
        print(f"ttft p50/p99: {s['ttft_p50'] * 1e3:.0f}/"
              f"{s['ttft_p99'] * 1e3:.0f} ms  "
              f"prefix-hit blocks: {s['prefix_hit_blocks']}  "
              f"hot hit-rate: {c['hit_rate_hot']:.2%}")
    else:
        print(f"routing: {stats['routing']}  "
              f"fleet hot hit-rate: {stats['fleet']['hit_rate_hot']:.2%}")
        print(f"re-dispatched after failure: {stats['redispatched']}  "
              f"re-prefilled tokens: {stats['reprefill_tokens']}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
