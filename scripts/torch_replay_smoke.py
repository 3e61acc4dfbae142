#!/usr/bin/env python3
"""The trace -> engine serving replay smoke on the PyTorch port, on the
CUDA card (``--device cpu`` runs the kernels' plain versions on the
host).  The phases and assertions of ``scripts/replay_smoke.py``:

* a tiny agentic trace (2 sessions x 2 turns) through the live
  ``ServingEngine``: it completes with sane accounting;
* segment-granular prefix reuse: a prompt that diverges in block 0
  resumes at least one mid-prompt block the radix prefix cannot see;
* the same trace through a 2-replica ``ReplicaCluster`` with a
  mid-replay failover: every turn completes and the redispatch /
  re-prefill accounting is consistent;
* once more with the fleet-shared tier 4 bound: cross-replica imports
  happen;
* a few seconds of real-clock serving through the thread-pumped
  ``ServingFrontend`` at low open-loop QPS: goodput == offered;
* a fault-injected chaos replay (seeded transient I/O errors and
  payload corruption on tiers 1-5): zero hung requests, at least one
  absorbed retry, and every injected corruption caught by its crc32
  check before decode.  On the card a tier payload is the bf16 K/V
  copied off the device, so this is the path the check guards.

The JAX script's step-loop microbench phase (``benchmarks/
steploop_bench.py``) is left out: the benchmark harness has not been
ported, and its host-overhead ratio has no counterpart here yet.

``REPLAY_SMOKE_BUDGET_S`` (0/unset disables) bounds the whole run's
wall seconds; a ``smoke summary`` line carries the per-phase timings.

    PYTHONPATH=src python scripts/torch_replay_smoke.py [--device cpu]
"""
import argparse
import os
import time

from repro_torch.core.faults import FaultProfile
from repro_torch.launch.serve import run_open_loop
from repro_torch.models.common import device_line, resolve_device
from repro_torch.serving.frontend import ServingFrontend
from repro_torch.serving.request import SamplingParams
from repro_torch.traces.loadgen import trace_load
from repro_torch.traces.serving_replay import (ClusterReplayConfig,
                                               ServingReplayConfig,
                                               build_engine,
                                               run_cluster_replay,
                                               run_serving_replay)


def single_engine_smoke(device=None, params=None) -> None:
    r = run_serving_replay(ServingReplayConfig(
        workload="agentic", policy="bayesian", n_sessions=2, max_turns=2,
        max_steps=500), device=device, params=params)
    assert r.requests_done > 0, "no turns completed"
    assert r.generated_tokens > 0, "no tokens generated"
    assert 0.0 <= r.engine_hit_rate <= 1.0
    assert r.engine_hit_rate <= r.reuse_rate
    assert r.virtual_time_s > 0.0
    print(f"replay smoke ok: {r.requests_done} turns, "
          f"hit {100 * r.engine_hit_rate:.1f}%, "
          f"reuse {100 * r.reuse_rate:.1f}%, "
          f"wall {r.wall_s:.1f}s")


def segment_smoke(device=None, params=None) -> int:
    """Segment-granular prefix reuse through the live engine: two
    ShareGPT-shaped sessions whose prompts diverge mid-prompt (the
    second rewrites block 0 but keeps blocks 1..3) must resume at least
    one mid-prompt segment past the divergence (CoW share or tier
    fetch), which the radix prefix cannot see at all."""
    import numpy as np
    eng = build_engine(ServingReplayConfig(
        workload="sharegpt", policy="bayesian", n_sessions=2,
        async_transfers=False), device=device, params=params)
    bt = eng.manager.block_tokens
    rng = np.random.default_rng(0)
    blocks = [[int(t) for t in rng.integers(0, 200, size=bt)]
              for _ in range(4)]
    tail = [int(t) for t in rng.integers(0, 200, size=5)]
    r1 = eng.submit(sum(blocks, []) + tail,
                    params=SamplingParams(max_new_tokens=2),
                    session_id="seg-a", retain_blocks=True)
    eng.run(max_steps=500)
    assert r1.generated, "first session produced no tokens"
    # outside the first prompts' [0, 200), inside the vocabulary (the JAX
    # script draws [200, 400) from the 256-token vocabulary, which its
    # embedding gather clamps; the port's raises)
    divergent = [int(t) for t in rng.integers(200, eng.cfg.vocab_size,
                                              size=bt)]
    r2 = eng.submit(divergent + sum(blocks[1:], []) + tail,
                    params=SamplingParams(max_new_tokens=2),
                    session_id="seg-b")
    eng.run(max_steps=500)
    st = eng.stats()
    eng.shutdown()
    assert r2.generated, "divergent session produced no tokens"
    assert r2.prefix_hit_blocks == 0           # radix sees nothing
    assert r2.segment_hit_blocks >= 1, "no resumed-segment hits"
    resumed = st["segment_share_hits"] + st["segment_inject_hits"]
    assert resumed >= 1
    print(f"segment smoke ok: {r2.segment_hit_blocks} mid-prompt blocks "
          f"resumed past the divergence ({st['segment_share_hits']} "
          f"CoW-shared, {st['segment_inject_hits']} injected), "
          f"radix prefix hits {r2.prefix_hit_blocks}")
    return resumed


def cluster_smoke(device=None, params=None) -> None:
    """2 replicas x 2 sessions, round-robin (both replicas guaranteed
    traffic), one replica killed after the first completed turn: the
    failover path must redispatch and still finish every turn."""
    r = run_cluster_replay(ClusterReplayConfig(
        workload="agentic", policy="bayesian", n_sessions=2, max_turns=2,
        n_replicas=2, routing="round_robin", fail_replica_after_turns=1,
        max_steps=500), device=device, params=params)
    assert r.requests_done == 4, f"expected 4 turns, got {r.requests_done}"
    assert len(r.failed_replicas) == 1
    assert r.redispatched >= 0 and r.reprefill_tokens >= 0
    assert (r.redispatched == 0) == (r.reprefill_tokens == 0)
    assert 0.0 <= r.fleet_hit_rate <= r.fleet_reuse_rate <= 1.0
    assert sum(p.requests_done for p in r.per_replica) == r.requests_done
    assert r.virtual_time_s > 0.0
    print(f"cluster smoke ok: {r.requests_done} turns on "
          f"{r.n_replicas} replicas ({len(r.failed_replicas)} failed), "
          f"fleet hit {100 * r.fleet_hit_rate:.1f}%, "
          f"redispatched {r.redispatched}, "
          f"re-prefilled {r.reprefill_tokens} tokens, "
          f"wall {r.wall_s:.1f}s")


def shared_tier_smoke(device=None, params=None) -> None:
    """2 replicas with the fleet-shared tier 4 bound, session-blind
    routing: the trace's cross-session sharing must surface as at least
    one cross-replica tier-4 import.  3 sessions (odd) so round-robin
    really alternates a session's turns across replicas."""
    r = run_cluster_replay(ClusterReplayConfig(
        workload="agentic", policy="bayesian", n_sessions=3, max_turns=2,
        n_replicas=2, routing="round_robin", shared_tier=True,
        max_steps=500), device=device, params=params)
    assert r.requests_done == 6, f"expected 6 turns, got {r.requests_done}"
    assert r.shared_tier
    assert r.shared_hit_blocks > 0, "no cross-replica shared-tier imports"
    assert r.fleet_hit_rate_incl_shared >= r.fleet_hit_rate
    assert r.shared_hit_rate <= r.fleet_hit_rate_incl_shared <= 1.0
    print(f"shared-tier smoke ok: {r.requests_done} turns, "
          f"hot {100 * r.fleet_hit_rate:.1f}%, "
          f"incl-shared {100 * r.fleet_hit_rate_incl_shared:.1f}%, "
          f"{r.shared_hit_blocks} imported blocks, "
          f"wall {r.wall_s:.1f}s")


def frontend_smoke(device=None, params=None) -> float:
    """A few seconds of real-clock serving through the thread-pumped
    ``ServingFrontend`` at a low Poisson rate: no admission pressure, so
    goodput must equal offered (nothing shed, nothing leaked)."""
    fe = ServingFrontend(build_engine(ServingReplayConfig(
        workload="agentic", policy="bayesian", n_sessions=2,
        async_transfers=False), device=device, params=params))
    arrivals = trace_load("agentic", 6.0, duration_s=2.0, seed=0,
                          n_sessions=2, max_turns=2)
    # warm up inline (arrival-shaped prompts, concurrent) so the timed
    # phase measures serving, not the kernels' first launches
    n_warm = 2
    for k in range(n_warm):
        fe.submit([k + 1] * len(arrivals[k].prompt),
                  params=SamplingParams(max_new_tokens=2))
    while fe.in_flight() > 0:
        fe.pump_once()
    run_open_loop(fe, arrivals)
    st = fe.stats()
    offered = len(arrivals) + n_warm       # + the warm-up requests
    assert st["offered"] == offered
    assert st["shed"] == 0 and st["in_flight"] == 0
    assert st["goodput"] == st["offered"], (
        f"goodput {st['goodput']} != offered {st['offered']} "
        f"(shed {st['shed']}, done {st['done']})")
    print(f"frontend smoke ok: {st['done']} served at real clock, "
          f"ttft p99 {st['ttft_p99'] * 1e3:.0f}ms, "
          f"tbt p99 {st['tbt_p99'] * 1e3:.1f}ms")
    return st["ttft_p99"]


def chaos_smoke(device=None, params=None):
    """Fault-injected replay: one session under tier pressure (tiny
    tier-0/1 capacities force demote/promote traffic through the faulted
    tiers) with seeded transient read / write errors and payload
    corruptions on tiers 1-5, transfers inline.  Every turn must still
    complete (errors retry, corrupt payloads convert to recompute:
    nothing hangs), with at least one retry absorbed and every injected
    corruption caught by its crc32 check before decode.  Returns the
    replay's result."""
    prof = {t: FaultProfile(read_error_rate=0.25, write_error_rate=0.1,
                            corruption_rate=0.2) for t in (1, 2, 3, 4, 5)}
    r = run_serving_replay(ServingReplayConfig(
        workload="agentic", policy="bayesian", n_sessions=1, max_turns=3,
        max_steps=2000, async_transfers=False, hot_blocks=4, t1_blocks=8,
        fault_profiles=prof, fault_seed=3), device=device, params=params)
    hung = r.turns_submitted - r.requests_done
    corruptions = r.injected.get("injected_corruptions", 0)
    assert hung == 0, f"{hung} requests hung under faults"
    assert r.retries >= 1, "no transient fault was retried"
    assert corruptions >= 1, "no corruption was injected"
    assert r.integrity_failures == corruptions, (
        f"{corruptions} corruptions injected, "
        f"{r.integrity_failures} caught")
    print(f"chaos smoke ok: {r.requests_done}/{r.turns_submitted} turns "
          f"under faults (0 hung), {r.retries} retries, "
          f"{r.io_errors} escalations, "
          f"{r.integrity_failures}/{corruptions} corruptions caught, "
          f"{r.fetch_recomputes} fetch recomputes, wall {r.wall_s:.1f}s")
    return r


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="the CUDA card (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    print(device_line(device))
    budget_s = float(os.environ.get("REPLAY_SMOKE_BUDGET_S", "0"))
    times = {}
    t0 = time.perf_counter()
    results = {}
    for name, phase in (("single", single_engine_smoke),
                        ("segment", segment_smoke),
                        ("cluster", cluster_smoke),
                        ("shared", shared_tier_smoke),
                        ("frontend", frontend_smoke),
                        ("chaos", chaos_smoke)):
        ts = time.perf_counter()
        results[name] = phase(device=device)
        times[name] = time.perf_counter() - ts
    print("steploop smoke skipped: the step-loop microbench "
          "(benchmarks/steploop_bench.py) is not ported")
    elapsed = time.perf_counter() - t0
    chaos = results["chaos"]
    print(f"smoke summary: device={device} "
          + " ".join(f"{k}={v:.1f}s" for k, v in times.items())
          + f" segment_resumed_blocks={results['segment']} "
          f"frontend_ttft_p99_ms={results['frontend'] * 1e3:.0f} "
          f"chaos_retries={chaos.retries} "
          f"chaos_integrity_catches={chaos.integrity_failures} "
          f"total={elapsed:.1f}s "
          f"budget={budget_s:.0f}s" + (" (disabled)" if not budget_s else ""))
    assert not budget_s or elapsed <= budget_s, (
        f"replay smoke took {elapsed:.1f}s > budget {budget_s:.0f}s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
