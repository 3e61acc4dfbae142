"""The port's examples and replay smoke against the JAX package's, on
the CPU: the serving examples print the JAX examples' lines (after the
device line the port adds), the replay example and the smoke's chaos
phase give the JAX replays' results field for field (but for the wall
clock), and the train demo resumes bit for bit.

Both sides serve the JAX engine's own weights (its seed-0
``init_params``, crossed over through numpy) and price block recompute
at the JAX engine's constant, as ``tests/test_torch_replay.py`` does.
The port's engine keeps the paper's H100 tier table (``PAPER_TIER_SPECS``)
where the JAX engine keeps the TPU v5e's: both tables are in the
verbatim copy of ``core/tiers.py``, and the printed lines differ only by
their tiers' names."""
import dataclasses
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")
import jax  # noqa: E402

from repro.config import reduce_config as j_reduce  # noqa: E402
from repro.configs import get_config as j_get  # noqa: E402
from repro.models.model import build_model as jax_build  # noqa: E402
from repro.serving import EngineConfig as JEngineConfig  # noqa: E402
from repro.traces import serving_replay as jsr  # noqa: E402
from repro_torch.core.tiers import (PAPER_TIER_SPECS,  # noqa: E402
                                    TPU_V5E_TIER_SPECS)
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.serving import engine as t_engine  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# the JAX engine prices block recompute at the TPU v5e bf16 peak
JAX_RECOMPUTE_FLOPS = 197e12
WALL_FIELDS = ("wall_s", "segment_lookup_s")
# the port's tier names -> the JAX engine's, tier by tier
TIER_NAMES = {p.name: j.name for p, j in zip(PAPER_TIER_SPECS,
                                              TPU_V5E_TIER_SPECS)}
SERVING = ("quickstart", "serve_multi_tier", "agentic_serving")
# the port's chaos replay (torch_replay_smoke's) on the CPU at its H100
# recompute constant; chip_smoke.py's chaos phase holds its card run to a
# copy of these
CHAOS_PINS = {
    "requests_done": 3, "turns_submitted": 3, "seen_blocks": 24,
    "hot_hits_t0": 4, "hot_hits_t1": 4, "cow_share_hits": 1,
    "inject_hits": 8, "segment_hit_blocks": 11, "segment_inject_hits": 11,
    "promotions": 12, "demotions": 80, "generated_tokens": 12, "steps": 20,
    "retries": 22, "io_errors": 0, "integrity_failures": 10,
    "fetch_recomputes": 6, "ttft_p99": 0.03542752153656406,
    "injected": {"injected_read_errors": 13, "injected_write_errors": 9,
                 "injected_corruptions": 10, "injected_brownouts": 0,
                 "injected_stalls": 0, "injected_flaps": 0},
}


def _load(path: Path):
    spec = importlib.util.spec_from_file_location(
        "ex_" + path.stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _fields(result) -> dict:
    d = dataclasses.asdict(result)
    for key in WALL_FIELDS:
        d.pop(key, None)
    return d


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the reduced models' ops are too small to gain
    from more, and the parallel test run's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def engine_params():
    """The JAX serving engine's params (``init_params`` at
    ``EngineConfig().seed``) as the port's CPU tensors."""
    tree = jax_build(j_reduce(j_get("llama3.2-1b"))).init_params(
        jax.random.PRNGKey(JEngineConfig().seed))
    return params_from_numpy(jax.tree.map(np.asarray, tree), device="cpu")


@pytest.fixture(scope="module")
def replay_params():
    """The JAX replay engine's params (its seed-0 ``init_params``)."""
    tree = jax_build(jsr.replay_model_config(32)).init_params(
        jax.random.PRNGKey(0))
    return params_from_numpy(jax.tree.map(np.asarray, tree), device="cpu")


@pytest.fixture
def jax_constant(monkeypatch):
    monkeypatch.setattr(t_engine, "H100_BF16_PEAK_FLOPS", JAX_RECOMPUTE_FLOPS)


@pytest.mark.parametrize("name", SERVING)
def test_serving_example_prints_the_jax_lines(name, engine_params,
                                              jax_constant, capsys):
    _load(ROOT / "examples" / f"{name}.py").main()
    want = capsys.readouterr().out.splitlines()
    text = _load(ROOT / "examples" / f"torch_{name}.py").run(
        device="cpu", params=engine_params)
    assert capsys.readouterr().out.splitlines() == text.splitlines()
    device, *got = text.splitlines()
    assert device == "device: cpu"
    for ours, theirs in TIER_NAMES.items():
        got = [line.replace(f"tier {ours:10s}", f"tier {theirs:10s}")
               for line in got]
    assert got == want


@pytest.mark.parametrize("policy", ["bayesian", "lru"])
def test_replay_example_matches_jax(policy, replay_params, jax_constant):
    """The replay example's configuration at 2 sessions x 2 turns,
    transfers inline (the async worker's completion step may vary)."""
    ex = _load(ROOT / "examples" / "torch_trace_replay_serving.py")
    got = ex.replay(policy, 2, 2, device="cpu", params=replay_params,
                    async_transfers=False)
    want = jsr.run_serving_replay(jsr.ServingReplayConfig(
        workload="agentic", policy=policy, n_sessions=2, max_turns=2,
        hot_blocks=40, t1_blocks=56, async_transfers=False))
    assert _fields(got) == _fields(want)
    assert got.requests_done == 4


def test_replay_example_runs(replay_params):
    ex = _load(ROOT / "examples" / "torch_trace_replay_serving.py")
    lines = ex.run(1, 1, device="cpu", params=replay_params).splitlines()
    assert lines[0] == "device: cpu"
    assert sum("1 turns" in line for line in lines) == 2
    assert lines[-1].startswith("bayesian - lru hit-rate gap:")


def test_train_demo_resumes_bit_for_bit(tmp_path):
    """4 steps straight against a run cut at step 3 (after the step-2
    checkpoint) and relaunched: the step-4 checkpoints' leaves (hash,
    dtype, shape) are equal."""
    ex = _load(ROOT / "examples" / "torch_train_demo.py")
    kw = dict(steps=4, ckpt_every=2, device="cpu")
    straight = ex.run(ckpt_dir=str(tmp_path / "a"), **kw)
    with pytest.raises(SystemExit) as e:
        ex.run(ckpt_dir=str(tmp_path / "b"), crash_at=3, **kw)
    assert e.value.code == 17
    resumed = ex.run(ckpt_dir=str(tmp_path / "b"), **kw)
    assert "resumed from step 2" in resumed
    assert "resumed" not in straight
    a, b = (json.loads((tmp_path / d / "ckpt_00000004.json").read_text())
            for d in "ab")
    assert a["leaves"] and a["leaves"] == b["leaves"]
    last = [line for line in straight.splitlines()
            if line.startswith("final loss")]
    assert last and last == [line for line in resumed.splitlines()
                             if line.startswith("final loss")]


def test_chaos_smoke_matches_jax(replay_params, jax_constant, monkeypatch,
                                 capsys):
    """The port's chaos phase and the JAX script's ``chaos_smoke``: the
    same replay field for field, with corruptions injected and every one
    caught."""
    jscript = _load(ROOT / "scripts" / "replay_smoke.py")
    seen = []

    def record(*args, **kw):
        seen.append(jsr.run_serving_replay(*args, **kw))
        return seen[-1]
    monkeypatch.setattr(jscript, "run_serving_replay", record)
    jscript.chaos_smoke()
    smoke = _load(ROOT / "scripts" / "torch_replay_smoke.py")
    got = smoke.chaos_smoke(device="cpu", params=replay_params)
    want, = seen
    assert _fields(got) == _fields(want)
    assert got.injected["injected_corruptions"] >= 1
    assert got.integrity_failures == got.injected["injected_corruptions"]
    assert "chaos smoke ok" in capsys.readouterr().out


def test_chaos_pins_at_h100_constant():
    """The port's chaos replay on its own seed-0 weights at its H100
    constant, as the card runs it."""
    smoke = _load(ROOT / "scripts" / "torch_replay_smoke.py")
    got = _fields(smoke.chaos_smoke(device="cpu"))
    assert {k: got[k] for k in CHAOS_PINS} == CHAOS_PINS


def test_chip_smoke_holds_the_chaos_pins():
    assert _load(ROOT / "chip_smoke.py").CHAOS_PINS == CHAOS_PINS


@pytest.mark.parametrize("path", [
    *(f"examples/torch_{n}.py" for n in SERVING),
    "examples/torch_trace_replay_serving.py",
    "examples/torch_train_demo.py", "scripts/torch_replay_smoke.py"])
def test_entry_points_need_cuda_or_explicit_cpu(path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _load(ROOT / path).main([])
