"""The port's train step, checkpoints and train launcher, on the CPU:
three ``make_train_step`` steps against the JAX package's jitted step
(one microbatch, two, ``defer_grad_sync`` and ``bf16_grad_sync``); the
behaviours ``tests/test_training.py`` holds the JAX package to, on the
port (loss decreases, microbatching equals the full batch, compression
stays close, checkpoints round-trip bit for bit and skip unchanged
leaves, crash-resume equals the straight run, the data stream is
seekable, the schedule warms up and decays); a checkpoint the JAX
package wrote restored bit for bit, and the port's manifest of the same
state equal to JAX's; the launcher's crash and resume.  Reduced
llama3.2-1b from the JAX ``init_params`` tree (float32) crossed through
numpy."""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.training import checkpoint as jckpt  # noqa: E402
from repro.training import optimizer as jopt  # noqa: E402
from repro.training import train as jtrain  # noqa: E402
from repro_torch.config import reduce_config as t_reduce  # noqa: E402
from repro_torch.configs import get_config as t_get  # noqa: E402
from repro_torch.models.common import tree_map  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.training import checkpoint as ckpt_mod  # noqa: E402
from repro_torch.training import data as data_mod  # noqa: E402
from repro_torch.training import optimizer as topt  # noqa: E402
from repro_torch.training import train as ttrain  # noqa: E402
from test_torch_training import flat, jax_tree  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ARCH = "llama3.2-1b"
ADAMW = dict(lr=1e-3, total_steps=100, warmup_steps=2)
MODES = {"n_micro1": dict(n_micro=1), "n_micro2": dict(n_micro=2),
         "defer": dict(n_micro=2, defer_grad_sync=True),
         "bf16_sync": dict(n_micro=2, bf16_grad_sync=True)}


@pytest.fixture(scope="module")
def setup():
    jm, tree = jax_tree(ARCH)
    tm = build_model(t_reduce(t_get(ARCH)))
    data = data_mod.SyntheticLM(data_mod.DataConfig(
        vocab_size=tm.cfg.vocab_size, seq_len=64, global_batch=4))
    return jm, tree, tm, data


_JAX_STEPS = {}


def jax_step(jm, mode):
    """The JAX package's jitted step, compiled once per mode."""
    if mode not in _JAX_STEPS:
        _JAX_STEPS[mode] = jax.jit(jtrain.make_train_step(
            jm, adamw=jopt.AdamWConfig(**ADAMW), **MODES[mode]))
    return _JAX_STEPS[mode]


def t_batch(data, step):
    return {k: torch.from_numpy(v) for k, v in data.batch(step).items()}


def run(tm, params, data, steps, start=0, opt_state=None, **kw):
    """``steps`` port train steps from ``start``: (params, state,
    losses)."""
    step_fn = ttrain.make_train_step(tm, adamw=topt.AdamWConfig(**ADAMW),
                                     **kw)
    opt_state = topt.init_state(params) if opt_state is None else opt_state
    losses = []
    for s in range(start, start + steps):
        params, opt_state, m = step_fn(params, opt_state, t_batch(data, s))
        losses.append(float(m["loss"]))
    return params, opt_state, losses


def leaves_equal(a, b) -> bool:
    la, lb = ckpt_mod._leaf_paths(a), ckpt_mod._leaf_paths(b)
    return [k for k, _ in la] == [k for k, _ in lb] and all(
        x.dtype == y.dtype and torch.equal(x, y)
        for (_, x), (_, y) in zip(la, lb))


# ---------------------------------------------------------------------------
# against the JAX step
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mode", sorted(MODES))
def test_train_steps_match_jax(setup, mode):
    """Three steps from the same float32 params and batches.  Step 1 runs
    in float32 on both sides: loss, grad norm, lr and every master within
    1e-4.  Its update casts the params to bf16 (both frameworks do), so
    steps 2-3 compute in bf16, where the two round at other places: each
    loss within 1e-4 relative, the grad norm within 2e-3 relative, and
    the masters after step 3 within 1e-5 on average and 2 * lr at most
    (Adam's normalised update moves a weight by up to lr a step, so a
    near-zero gradient that rounds to the other sign moves it by up to
    2 lr)."""
    jm, tree, tm, data = setup
    step = jax_step(jm, mode)
    jp = jax.tree.map(jnp.asarray, tree)
    jo = jopt.init_state(jp)
    tp = params_from_numpy(tree, device="cpu")
    to = topt.init_state(tp)
    t_step = ttrain.make_train_step(tm, adamw=topt.AdamWConfig(**ADAMW),
                                    **MODES[mode])
    for s in range(3):
        raw = data.batch(s)
        jp, jo, jm_ = step(jp, jo, {k: jnp.asarray(v) for k, v in raw.items()})
        tp, to, tm_ = t_step(tp, to, t_batch(data, s))
        assert set(tm_) == set(jm_)
        np.testing.assert_allclose(float(tm_["loss"]), float(jm_["loss"]),
                                   rtol=1e-4)
        np.testing.assert_allclose(float(tm_["lr"]), float(jm_["lr"]),
                                   rtol=1e-6)
        np.testing.assert_allclose(float(tm_["grad_norm"]),
                                   float(jm_["grad_norm"]),
                                   rtol=1e-4 if s == 0 else 2e-3)
        assert all(t.dtype == torch.bfloat16 for t in flat(tp).values())
        jmast = flat(jax.tree.map(np.asarray, jo.master))
        gaps = [np.abs(t.numpy() - jmast[path])
                for path, t in flat(to.master).items()]
        if s == 0:
            assert max(g.max() for g in gaps) <= 1e-4
    gaps = np.concatenate([g.ravel() for g in gaps])
    assert gaps.mean() <= 1e-5
    assert gaps.max() <= 2 * ADAMW["lr"]
    assert int(to.step) == int(jo.step) == 3


# ---------------------------------------------------------------------------
# the behaviours of tests/test_training.py, on the port
# ---------------------------------------------------------------------------
def test_loss_decreases(setup):
    _, tree, tm, data = setup
    _, _, losses = run(tm, params_from_numpy(tree, device="cpu"), data, 12)
    assert losses[-1] < losses[0]


def test_microbatching_matches_full_batch(setup):
    _, tree, tm, data = setup
    params = params_from_numpy(tree, device="cpu")
    _, _, l1 = run(tm, params, data, 3, n_micro=1)
    _, _, l2 = run(tm, params, data, 3, n_micro=2)
    # grad accumulation == full batch (up to bf16 accumulation noise)
    np.testing.assert_allclose(l1, l2, rtol=2e-2, atol=2e-2)


def test_grad_compression_close_to_exact(setup):
    _, tree, tm, data = setup
    params = params_from_numpy(tree, device="cpu")
    _, _, l1 = run(tm, params, data, 5)
    _, _, l2 = run(tm, params, data, 5, grad_compress=True)
    np.testing.assert_allclose(l1, l2, rtol=0.1, atol=0.1)


def test_checkpoint_roundtrip_bitexact(setup, tmp_path):
    _, tree, tm, data = setup
    p1, o1, _ = run(tm, params_from_numpy(tree, device="cpu"), data, 2)
    mgr = ckpt_mod.CheckpointManager(str(tmp_path))
    mgr.save(2, (p1, o1))
    (p2, o2), manifest = mgr.restore((p1, o1))
    assert isinstance(o2, topt.AdamWState) and manifest["step"] == 2
    assert leaves_equal((p1, o1), (p2, o2))


def test_delta_checkpoint_skips_unchanged(setup, tmp_path):
    _, tree, _, _ = setup
    params = params_from_numpy(tree, device="cpu")
    mgr = ckpt_mod.CheckpointManager(str(tmp_path))
    o = topt.init_state(params)
    mgr.save(1, (params, o))
    m2 = mgr.save(2, (params, o))       # identical state
    assert m2["delta"]["new_bytes"] == 0
    assert m2["delta"]["reused_bytes"] > 0


def test_checkpoint_gc_keeps_the_latest(setup, tmp_path):
    """Manifests past ``keep`` go, with the blobs only they referenced;
    writes leave no temporary file behind."""
    _, tree, _, _ = setup
    params = params_from_numpy(tree, device="cpu")
    mgr = ckpt_mod.CheckpointManager(str(tmp_path), keep=2)
    for step in range(1, 5):
        scaled = tree_map(lambda p: p * step, params)
        mgr.save(step, scaled)
    manifests = sorted(f for f in os.listdir(tmp_path) if f.endswith(".json"))
    assert manifests == ["ckpt_00000003.json", "ckpt_00000004.json"]
    live = set()
    for f in manifests:
        live.update(v["hash"] + ".npy" for v in json.loads(
            (tmp_path / f).read_text())["leaves"].values())
    assert set(os.listdir(tmp_path / "blobs")) == live
    assert mgr.latest_step() == 4


def test_crash_resume_equivalence(setup, tmp_path):
    """Train 6 straight == train 3, 'crash', restore, train 3 more."""
    _, tree, tm, data = setup
    params = params_from_numpy(tree, device="cpu")
    pa, oa, _ = run(tm, params, data, 6)
    p1, o1, _ = run(tm, params, data, 3)
    mgr = ckpt_mod.CheckpointManager(str(tmp_path))
    mgr.save(3, (p1, o1))
    (p1r, o1r), _ = mgr.restore((p1, o1))
    pb, ob, _ = run(tm, p1r, data, 3, start=3, opt_state=o1r)
    assert leaves_equal((pa, oa), (pb, ob)), "resume diverged"


def test_data_pipeline_deterministic_and_seekable(setup):
    data = setup[3]
    b1 = data.batch(7)
    np.testing.assert_array_equal(b1["tokens"], data.batch(7)["tokens"])
    it = data.iterate(start_step=7)
    np.testing.assert_array_equal(next(it)["tokens"], b1["tokens"])


def test_lr_schedule_warmup_and_decay():
    cfg = topt.AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=100)
    lrs = [float(topt.lr_schedule(cfg, torch.tensor(s)))
           for s in (0, 5, 10, 50, 99)]
    assert lrs[0] < lrs[1] < lrs[2]
    assert lrs[2] >= lrs[3] >= lrs[4]
    assert lrs[4] >= 0.09 * cfg.lr


# ---------------------------------------------------------------------------
# checkpoints across the two packages
# ---------------------------------------------------------------------------
def test_jax_checkpoint_restores_in_port(setup, tmp_path):
    """A JAX state one step in (bf16 params, float32 AdamW state) saved by
    the JAX manager restores in the port bit for bit, and the port's
    manifest of it equals JAX's: the same leaf keys, hashes, dtypes,
    tags and shapes."""
    jm, tree, tm, data = setup
    jp = jax.tree.map(jnp.asarray, tree)
    jp, jo, _ = jax_step(jm, "n_micro1")(
        jp, jopt.init_state(jp),
        {k: jnp.asarray(v) for k, v in data.batch(0).items()})
    jman = jckpt.CheckpointManager(str(tmp_path / "jax")).save(1, (jp, jo))
    like_p = tree_map(lambda a: a.to(torch.bfloat16),
                           params_from_numpy(tree, device="cpu"))
    like = (like_p, topt.init_state(like_p))
    (tp, to), manifest = ckpt_mod.CheckpointManager(
        str(tmp_path / "jax")).restore(like)
    assert manifest["step"] == 1 and isinstance(to, topt.AdamWState)
    assert to.step.dtype == torch.int32 and int(to.step) == 1
    for t_tree, j_tree in ((tp, jp), (to.master, jo.master), (to.m, jo.m),
                           (to.v, jo.v)):
        jf = flat(jax.tree.map(
            lambda a: np.asarray(a.astype(jnp.float32)), j_tree))
        for path, t in flat(t_tree).items():
            np.testing.assert_array_equal(t.float().numpy(), jf[path])
    tman = ckpt_mod.CheckpointManager(str(tmp_path / "port")).save(
        1, (tp, to))
    assert list(tman["leaves"]) == list(jman["leaves"])
    assert tman["leaves"] == jman["leaves"]
    assert "1/.master/layers/attn/wq" in tman["leaves"]
    assert tman["leaves"]["0/embed"]["tag"] == "bfloat16"


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------
def _launch(ckpt_dir, *extra):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--reduced",
         "--device", "cpu", "--steps", "4", "--seq-len", "16",
         "--global-batch", "2", "--ckpt-every", "1", "--log-every", "1",
         "--ckpt-dir", str(ckpt_dir), *extra],
        env=env, capture_output=True, text=True, timeout=300)


def test_launcher_crash_and_resume(tmp_path):
    """``--crash-at 2`` exits 17 after the step-2 checkpoint; the relaunch
    resumes from it and ends on the straight run's state (the same
    manifest hashes at step 4)."""
    straight = _launch(tmp_path / "a")
    assert straight.returncode == 0, straight.stderr
    crashed = _launch(tmp_path / "b", "--crash-at", "2")
    assert crashed.returncode == 17, crashed.stderr
    assert "crashing at step 2" in crashed.stdout
    resumed = _launch(tmp_path / "b")
    assert resumed.returncode == 0, resumed.stderr
    assert "resumed from step 2" in resumed.stdout

    def final(d):
        return json.loads((d / "ckpt_00000004.json").read_text())["leaves"]
    assert final(tmp_path / "a") == final(tmp_path / "b")
