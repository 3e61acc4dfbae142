"""The port's replay smoke (``scripts/torch_replay_smoke.py``) end to end
on the CPU: every phase's own checks pass and the summary line names the
device; the step-loop phase says why it is left out.  Its chaos phase is
held to the JAX script's in ``tests/test_torch_examples.py``."""
import importlib.util
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture
def one_thread():
    """One intra-op thread: the reduced model's ops are too small to gain
    from more, and the parallel test run's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_replay_smoke_runs_on_cpu(one_thread, capsys):
    spec = importlib.util.spec_from_file_location(
        "torch_replay_smoke", ROOT / "scripts" / "torch_replay_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert smoke.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "steploop smoke skipped" in out
    assert out.splitlines()[-1].startswith("smoke summary: device=cpu")
