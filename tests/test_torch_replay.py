"""The port's trace-replay, cluster and front-end drivers against the
JAX package on the CPU: the same replay configurations through both
(the JAX ``init_params`` tree crossed over through numpy, the port's
block-recompute constant patched to the JAX engine's, transfers inline
so every run is deterministic) must give the same result dataclasses
field for field, but for the wall-clock readings.  Also the port's own
numbers, which ``chip_smoke.py``'s ``replay`` phase holds the card to
at the port's H100 constant, and the fleet store's payload round
trip."""
import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")
import jax  # noqa: E402

from repro.core.faults import FaultProfile as JFault  # noqa: E402
from repro.models.model import build_model as jax_build  # noqa: E402
from repro.serving.frontend import ServingFrontend as JFrontend  # noqa: E402
from repro.serving.frontend import SLOConfig as JSLO  # noqa: E402
from repro.serving.frontend import VirtualClock as JClock  # noqa: E402
from repro.serving.request import SamplingParams as JSampling  # noqa: E402
from repro.traces import loadgen as j_loadgen  # noqa: E402
from repro.traces import serving_replay as jsr  # noqa: E402
from repro_torch.core.faults import FaultProfile as TFault  # noqa: E402
from repro_torch.core.tiers import FleetKVStore  # noqa: E402
from repro_torch.launch import serve as t_serve  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.serving import ServingFrontend as TFrontend  # noqa: E402
from repro_torch.serving import SLOConfig as TSLO  # noqa: E402
from repro_torch.serving import VirtualClock as TClock  # noqa: E402
from repro_torch.serving import engine as t_engine  # noqa: E402
from repro_torch.serving.request import SamplingParams as TSampling  # noqa: E402
from repro_torch.traces import loadgen as t_loadgen  # noqa: E402
from repro_torch.traces import serving_replay as tsr  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# the JAX engine prices block recompute at the TPU v5e bf16 peak
JAX_RECOMPUTE_FLOPS = 197e12
# wall-clock readings: the replay's wall seconds and the manager's wall
# time in segment scans
WALL_FIELDS = ("wall_s", "segment_lookup_s")
# (workload, segment_reuse) -> the port's replay at its H100 constant,
# 12 sessions x 6 turns, seed 0, bayesian, transfers inline; chip_smoke.py
# holds its CUDA run of the same configurations to a copy of these
REPLAY_PINS = {
    ("lmsys", False): {
        "engine_hit_rate": 0.852, "seen_blocks": 250, "hot_hits_t0": 142,
        "hot_hits_t1": 71, "cow_share_hits": 142, "inject_hits": 76,
        "segment_hit_blocks": 0, "promotions": 5, "requests_done": 28,
        "ttft_p50": 0.07900000000000004, "ttft_p95": 0.14482343999999994,
        "ttft_p99": 0.15272343999999993},
    ("agentic", False): {
        "engine_hit_rate": 0.8393393393393394, "seen_blocks": 666,
        "hot_hits_t0": 267, "hot_hits_t1": 292, "cow_share_hits": 267,
        "inject_hits": 318, "segment_hit_blocks": 0, "promotions": 26,
        "requests_done": 71, "ttft_p50": 0.1264000000000003,
        "ttft_p95": 0.24490000000000012, "ttft_p99": 0.2844000000000001},
    ("sharegpt", True): {
        "engine_hit_rate": 0.7196819085487077, "seen_blocks": 503,
        "hot_hits_t0": 127, "hot_hits_t1": 235, "cow_share_hits": 91,
        "inject_hits": 196, "segment_hit_blocks": 216, "promotions": 141,
        "requests_done": 58, "ttft_p50": 0.0868999999999999,
        "ttft_p95": 0.11849999999999997, "ttft_p99": 0.12639999999999996},
    ("lmsys", True): {
        "engine_hit_rate": 0.944, "seen_blocks": 250, "hot_hits_t0": 142,
        "hot_hits_t1": 94, "cow_share_hits": 142, "inject_hits": 76,
        "segment_hit_blocks": 32, "promotions": 14, "requests_done": 28,
        "ttft_p50": 0.07900000000000004, "ttft_p95": 0.14482343999999994,
        "ttft_p99": 0.15272343999999993},
}
# docs/EVALUATION.md's live-engine hit rates (percent, one decimal)
EVALUATION_HIT_PCT = {("lmsys", False): 85.2, ("agentic", False): 83.9,
                      ("sharegpt", True): 72.0, ("lmsys", True): 94.4}


@pytest.fixture(scope="module")
def params():
    """The JAX replay engine's params (its seed-0 ``init_params``), as
    the port's CPU tensors."""
    tree = jax_build(jsr.replay_model_config(32)).init_params(
        jax.random.PRNGKey(0))
    return params_from_numpy(jax.tree.map(np.asarray, tree), device="cpu")


@pytest.fixture
def jax_constant(monkeypatch):
    monkeypatch.setattr(t_engine, "H100_BF16_PEAK_FLOPS", JAX_RECOMPUTE_FLOPS)


def _fields(result) -> dict:
    d = dataclasses.asdict(result)
    for key in WALL_FIELDS:
        d.pop(key, None)
    return d


def _replay_cfg(mod, **kw):
    return mod.ServingReplayConfig(async_transfers=False, **kw)


@pytest.mark.parametrize("workload,segments", list(EVALUATION_HIT_PCT))
def test_serving_replay_matches_jax(params, jax_constant, workload, segments):
    kw = dict(workload=workload, segment_reuse=segments)
    want = jsr.run_serving_replay(_replay_cfg(jsr, **kw))
    got = tsr.run_serving_replay(_replay_cfg(tsr, **kw), device="cpu",
                                 params=params)
    assert _fields(got) == _fields(want)
    assert round(100 * got.engine_hit_rate, 1) == \
        EVALUATION_HIT_PCT[(workload, segments)]
    pins = REPLAY_PINS[(workload, segments)]
    assert {k: _fields(got)[k] for k in pins} == pins


def test_chaos_replay_matches_jax(params, jax_constant):
    """lmsys under --table chaos's tier pressure and its transient 1e-2
    fault profile on tiers 2-5, one fault seed."""
    kw = dict(workload="lmsys", hot_blocks=16, t1_blocks=16, t2_blocks=16,
              t3_blocks=16, fault_seed=7)

    def profiles(fault):
        return {t: fault(read_error_rate=1e-2, write_error_rate=1e-2,
                         corruption_rate=1e-3) for t in (2, 3, 4, 5)}
    want = jsr.run_serving_replay(_replay_cfg(
        jsr, fault_profiles=profiles(JFault), **kw))
    got = tsr.run_serving_replay(_replay_cfg(
        tsr, fault_profiles=profiles(TFault), **kw), device="cpu",
        params=params)
    assert _fields(got) == _fields(want)
    assert got.retries > 0 and got.requests_done == got.turns_submitted
    assert got.integrity_failures == got.injected["injected_corruptions"]


def test_cluster_replay_matches_jax(params, jax_constant):
    """Two replicas under round-robin with the fleet-shared tier 4, one
    failed once 10 turns have completed."""
    kw = dict(workload="lmsys", n_replicas=2, routing="round_robin",
              shared_tier=True, fail_replica_after_turns=10,
              async_transfers=False)
    want = jsr.run_cluster_replay(jsr.ClusterReplayConfig(**kw))
    got = tsr.run_cluster_replay(tsr.ClusterReplayConfig(**kw),
                                 device="cpu", params=params)
    assert _fields(got) == _fields(want)
    assert got.shared_hit_blocks > 0 and got.failed_replicas
    assert got.requests_done == want.requests_done > 0


def _engine_state(eng, reqs) -> dict:
    """Scheduler queues (as indices into ``reqs``), free slots and
    pages, and the cache manager's registrations, residency and
    counters."""
    sch, mgr = eng.scheduler, eng.manager
    index = {r.request_id: i for i, r in enumerate(reqs)}
    stats = dataclasses.asdict(mgr.stats)
    stats.pop("segment_lookup_time")
    return {"running": sorted(index[i] for i in sch.running),
            "blocked": sorted(index[i] for i in sch.blocked),
            "waiting": [index[r.request_id] for r in sch.waiting],
            "preempted": [index[r.request_id] for r in sch.preempted],
            "done": [index[r.request_id] for r in sch.done],
            "free_slots": eng.kv.free_slots(),
            "free_pages": eng.kv.allocator.n_free,
            "metas": sorted(mgr.metas), "payloads": sorted(mgr._payloads),
            "tiers": {t.spec.tier_id: sorted(t.blocks())
                      for t in mgr.hierarchy.tiers},
            "stats": stats}


def _cancel_release(mod, sampling, **kw):
    """Twelve lmsys turns on the replay engine's eight slots, two steps;
    then cancel a running request and a waiting one, step on, and tear
    down."""
    eng = mod.build_engine(_replay_cfg(mod, workload="lmsys"), **kw)
    specs = [t for sess in _turn_specs(mod, 6) for t in sess[:2]]
    reqs = [eng.submit(s.prompt, params=sampling(max_new_tokens=4),
                       session_id=s.session_id, block_types=s.block_types,
                       retain_blocks=True) for s in specs]
    eng.step()
    eng.step()
    running = next(r for r in reqs if r.request_id in eng.scheduler.running)
    waiting = next(r for r in reqs if r in eng.scheduler.waiting)
    out = {"cancelled": [eng.cancel_request(running),
                         eng.cancel_request(waiting),
                         eng.cancel_request(running)]}
    out["after_cancel"] = _engine_state(eng, reqs)
    eng.step()
    out["after_step"] = _engine_state(eng, reqs)
    eng.release_resources()
    out["after_release"] = _engine_state(eng, reqs)
    out["phases"] = [r.phase.name for r in reqs]
    return eng, out


def _turn_specs(mod, n_sessions):
    cfg = mod.replay_model_config(32)
    sessions = mod.workload_sessions(
        "lmsys", mod.TraceConfig(n_sessions=n_sessions, seed=0))
    cache = {}
    return [[mod._turn_spec(t, 32, cfg.vocab_size, 4, cache) for t in s]
            for s in sessions]


def test_cancel_and_release_match_jax(params, jax_constant):
    jeng, want = _cancel_release(jsr, JSampling)
    teng, got = _cancel_release(tsr, TSampling, device="cpu", params=params)
    assert got == want
    assert got["cancelled"] == [True, True, False]
    assert got["after_release"]["metas"] == []
    # the port also drops the KV pool from the device at teardown
    assert teng.kv.pools == {} and teng.kv._cached_state is None
    assert teng.worker is None and jeng.worker is None


def test_fleet_payload_round_trips_bit_exact(params):
    """A block one replica publishes to the fleet store and another
    imports lands in the importer's pool with the publisher's bits."""
    rcfg = _replay_cfg(tsr, workload="lmsys")
    a, b = (tsr.build_engine(rcfg, device="cpu", params=params)
            for _ in range(2))
    store = FleetKVStore(next(t.spec for t in a.manager.hierarchy.tiers
                              if t.spec.tier_id == 4))
    a.bind_fleet_store(store, "a")
    b.bind_fleet_store(store, "b")
    spec = _turn_specs(tsr, 1)[0][0]
    a.submit(spec.prompt, params=TSampling(max_new_tokens=2),
             session_id=spec.session_id, retain_blocks=True)
    a.run()
    req = b.submit(spec.prompt, params=TSampling(max_new_tokens=2),
                   session_id=spec.session_id, retain_blocks=True)
    b.step()                             # admission imports the prefix
    n = req.shared_hit_blocks
    assert n == (len(spec.prompt) - 1) // 32 > 0   # prefill stops short
    assert b.stats()["shared_fetch_hits"] == n
    for i, bid in enumerate(a.manager.match_prefix(spec.prompt[:-1])[:n]):
        published = a.manager._payloads[bid]
        assert published.dtype == np.uint16
        assert np.array_equal(b.kv.extract_block(req.slot, 32 * i, 32),
                              published)
    b.run()
    a.shutdown()
    b.shutdown()


def _frontend_stats(mod, fe_mod, loadgen, **kw):
    frontend, clock, slo = fe_mod
    rcfg = mod.ServingReplayConfig(workload="lmsys", n_sessions=4, seed=0,
                                   async_transfers=False, max_step_tokens=32)
    fe = frontend(mod.build_engine(rcfg, **kw), clock=clock(),
                  step_time_s=5e-3, slo=slo(ttft_budget_s=0.15))
    arrivals = loadgen.trace_load("lmsys", 100.0, n_requests=30, seed=5,
                                  n_sessions=4, max_turns=2)
    fe.serve_schedule(arrivals)
    fe.check_ledger()
    st = fe.stats()
    fe.stop()
    return st


def test_frontend_schedule_matches_jax(params, jax_constant):
    want = _frontend_stats(jsr, (JFrontend, JClock, JSLO), j_loadgen)
    got = _frontend_stats(tsr, (TFrontend, TClock, TSLO), t_loadgen,
                          device="cpu", params=params)
    assert got == want
    assert got["shed"] > 0 and got["done"] > 0


@pytest.mark.parametrize("argv", [
    [], ["--replicas", "2", "--fail-replica"],
    ["--replicas", "2", "--add-replica", "--routing", "round_robin"],
    ["--frontend", "--duration", "1"]],
    ids=["single", "failover", "scale_out", "frontend"])
def test_serve_cli_on_cpu(argv, capsys):
    assert t_serve.main(["--arch", "llama3.2-1b", "--reduced", "--requests",
                         "8", "--max-new", "4", "--device", "cpu",
                         *argv]) == 0
    assert "served" in capsys.readouterr().out


@pytest.mark.parametrize("workload,segments", [("sharegpt", True)])
def test_replay_pins_at_h100_constant(workload, segments):
    """The port's own numbers at its H100 constant, which the card's
    replay phase runs under.  ``test_serving_replay_matches_jax`` holds
    all four cells to the pins under the JAX constant; this runs the
    cell with the most tier churn (promotions) once more to show the
    constant changes nothing there: the reduced model's block recompute
    is so cheap that either constant gives the same decisions."""
    got = dataclasses.asdict(tsr.run_serving_replay(
        _replay_cfg(tsr, workload=workload, segment_reuse=segments),
        device="cpu"))
    want = REPLAY_PINS[(workload, segments)]
    assert {k: got[k] for k in want} == want


def test_chip_smoke_holds_the_same_pins():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert smoke.REPLAY_PINS == REPLAY_PINS


def test_drivers_need_cuda_or_explicit_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tsr.build_engine(_replay_cfg(tsr))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tsr.run_serving_replay(_replay_cfg(tsr, n_sessions=1))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_serve.main(["--reduced"])
