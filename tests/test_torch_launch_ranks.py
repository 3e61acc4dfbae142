"""The port's train step on four real ranks on the CPU (``gloo``,
spawned processes), against one process.

The train launcher (``python -m repro_torch.launch.train``, the ranks
given the variables ``torchrun`` sets): a (4, 1) ("data", "model") host
mesh, the params, the ZeRO-1 AdamW state and each batch placed by
``train_shardings``; reduced llama3.2-1b, 3 steps of 8 x 16 tokens,
bf16 params as the launcher trains them:

* at ``--n-micro`` 1 and 2 every param and AdamW state leaf equals the
  one-process run's within ``STATE_RTOL`` of the leaf's largest
  magnitude: each rank's weight gradient is a bf16 product over its own
  rows, rounded before the ranks' float32 sum, where one process rounds
  the whole sum once (2^-9 each), and AdamW's normalised update carries
  that into the master weights;
* ``--crash-at 2`` exits 17 on every rank, and the relaunch resumes from
  the step-2 checkpoint and ends on the straight 4-rank run's state bit
  for bit (the same manifest hashes);
* the 4-rank manifest has the one-process manifest's keys, shapes,
  dtypes and tags;
* with no group, the launcher's state is the one-device train step's
  (``make_train_step`` on unplaced tensors) bit for bit.

The sharded gradients themselves, in float32 on a (2, 2) mesh, for one
reduced model of each family (``compute_grads`` on params placed by
``tree_shardings`` and a batch by ``batch_shardings``): every leaf
within ``GRAD_RTOL`` of its largest magnitude of one process's
(float32 sums in another order).  These caught gradients that a
``local_map`` left unsummed over the ranks that split its computation:
the embedding's (llama's and the VLM's), the MoE router's and combine
weights', RWKV6's bonus and the Mamba2 mixer's inputs.

The ranks run everything in one spawn, each launch and the gradient
checks on a port of their own, with a time limit of their own
(``LIMIT_S``); the test process never joins a process group."""
import json
import os
import socket
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

LIMIT_S = 150.0
WORLD = 4
STEPS = 3
BASE = ["--reduced", "--device", "cpu", "--steps", str(STEPS),
        "--seq-len", "16", "--global-batch", "8", "--ckpt-every", "1",
        "--log-every", "1"]
# the 4-rank runs: (name, extra flags)
RUNS = (("micro1", []), ("micro2", ["--n-micro", "2"]),
        ("crash", ["--crash-at", "2"]), ("resume", []))
# every leaf of the 4-rank state against one process's, as a share of
# the leaf's largest magnitude (the runs read at most 0.74 %, v of wv)
STATE_RTOL = 2.0 ** -6
# (family's reduced config, rows, sequence): granite-moe at 4 x 256, so
# that its dispatch groups (256 tokens) are one process's on two data
# ranks
GRAD_CASES = (("llama3.2-1b", 4, 32), ("granite-moe-1b-a400m", 4, 256),
              ("llama-3.2-vision-11b", 4, 32), ("whisper-tiny", 4, 32),
              ("zamba2-1.2b", 4, 32), ("rwkv6-1.6b", 4, 32))
GRAD_RTOL = 1e-5


def _free_ports(n):
    socks = [socket.socket() for _ in range(n)]
    try:
        for s in socks:
            s.bind(("localhost", 0))
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


def _grad_errors(arch, rows, seq):
    """Each grad leaf's largest difference from one process's, over its
    largest magnitude: float32 ``compute_grads`` of reduced ``arch`` on
    a (2, 2) mesh (the world's four ranks)."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.config import reduce_config
    from repro_torch.configs import get_config
    from repro_torch.distributed import sharding as shlib
    from repro_torch.models.common import tree_leaves, tree_map
    from repro_torch.models.model import build_model
    from repro_torch.training import train as train_mod
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    cfg = reduce_config(get_config(arch))
    plain = build_model(cfg)
    params = plain.init_params(0, device="cpu", dtype=torch.float32)
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (rows, seq))
                              .astype(np.int32))
    batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, 1)}
    if cfg.family == "vlm":
        batch["patches"] = torch.from_numpy(rng.standard_normal(
            (rows, cfg.n_patches, cfg.d_model)).astype(np.float32))
    if cfg.family == "encdec":
        batch["frames"] = torch.from_numpy(rng.standard_normal(
            (rows, cfg.enc_len, cfg.d_model)).astype(np.float32))
    want, _ = train_mod.compute_grads(plain, params, batch)
    model = build_model(cfg, shlib.MeshSharding(mesh))
    placed = tree_map(lambda p, pl: shlib.place(p, mesh, pl), params,
                      shlib.tree_shardings(model.specs, mesh))
    placed_batch = {k: shlib.place(v, mesh, shlib.batch_shardings(
        {"x": v}, mesh)["x"]) for k, v in batch.items()}
    with implicit_replication():
        got, _ = train_mod.compute_grads(model, placed, placed_batch)
    return [float((g.full_tensor() - w).abs().max()
                  / max(1e-30, float(w.abs().max())))
            for g, w in zip(tree_leaves(got), tree_leaves(want))]


def _worker(rank: int, ports, out_dir: str) -> None:
    import torch.distributed as dist

    from repro_torch.launch import train
    torch.set_num_threads(1)
    res = {}
    for (name, extra), port in zip(RUNS, ports):
        os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank),
                          WORLD_SIZE=str(WORLD), MASTER_ADDR="localhost",
                          MASTER_PORT=str(port))
        ckpt = os.path.join(out_dir, "crash" if name == "resume" else name)
        try:
            res[name] = train.main(BASE + ["--ckpt-dir", ckpt] + extra)
        except SystemExit as e:
            res[name] = e.code
    dist.init_process_group("gloo", init_method=f"tcp://localhost:"
                            f"{ports[-1]}", world_size=WORLD, rank=rank)
    try:
        res["grads"] = {arch: _grad_errors(arch, rows, seq)
                        for arch, rows, seq in GRAD_CASES}
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)


def _leaves(ckpt_dir, step=STEPS):
    """{key: (manifest entry, array)} of the checkpoint at ``step``."""
    man = json.loads((ckpt_dir / f"ckpt_{step:08d}.json").read_text())
    return {k: (v, np.load(ckpt_dir / "blobs" / f"{v['hash']}.npy"))
            for k, v in man["leaves"].items()}


def _as_float(meta, arr):
    if meta["tag"] == "bfloat16":
        return (arr.astype(np.uint32) << 16).view(np.float32)
    return arr.astype(np.float64)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every launch's checkpoints: the four 4-rank runs in one spawn, the
    two one-process runs in this process."""
    import torch.multiprocessing as mp
    from repro_torch.launch import train
    out = tmp_path_factory.mktemp("ranks")
    ctx = mp.start_processes(_worker, args=(_free_ports(len(RUNS) + 1),
                                            str(out)),
                             nprocs=WORLD, join=False, start_method="spawn")
    deadline = time.monotonic() + LIMIT_S
    try:
        while not ctx.join(timeout=1.0):
            assert time.monotonic() < deadline, \
                f"the ranks did not finish within {LIMIT_S} s"
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
    codes = [json.loads((out / f"rank{r}.json").read_text())
             for r in range(WORLD)]
    one = {}
    for name, extra in RUNS[:2]:
        d = out / f"one_{name}"
        assert train.main(BASE + ["--ckpt-dir", str(d)] + extra) == 0
        one[name] = d
    return out, codes, one


@pytest.mark.parametrize("name", ["micro1", "micro2"])
def test_four_ranks_match_one_process(runs, name):
    out, codes, one = runs
    assert all(c[name] == 0 for c in codes), codes
    got, want = _leaves(out / name), _leaves(one[name])
    assert got.keys() == want.keys()
    for key, (meta, arr) in want.items():
        a, b = _as_float(meta, arr), _as_float(*got[key])
        err = float(np.abs(a - b).max(initial=0.0))
        assert err <= STATE_RTOL * float(np.abs(a).max(initial=0.0)), key


@pytest.mark.parametrize("arch", [c[0] for c in GRAD_CASES])
def test_sharded_grads_match_one_process(runs, arch):
    _, res, _ = runs
    for r in res:
        assert max(r["grads"][arch]) <= GRAD_RTOL, (arch, r["grads"][arch])


def test_four_ranks_resume_bit_for_bit(runs):
    out, codes, _ = runs
    assert all(c["crash"] == 17 for c in codes), codes
    assert all(c["resume"] == 0 for c in codes), codes
    assert (out / "crash" / "ckpt_00000002.json").exists()
    resumed = {k: m for k, (m, _) in _leaves(out / "crash").items()}
    straight = {k: m for k, (m, _) in _leaves(out / "micro1").items()}
    assert resumed == straight


def test_four_rank_manifest_is_one_process(runs):
    out, _, one = runs
    got, want = _leaves(out / "micro1"), _leaves(one["micro1"])
    strip = lambda m: {k: (v["shape"], v["dtype"], v["tag"])  # noqa: E731
                       for k, (v, _) in m.items()}
    assert strip(got) == strip(want)


def test_no_group_is_the_one_device_step(runs):
    """The launcher with no process group against ``make_train_step`` on
    the unplaced tree (the one-device path): the same manifest hashes."""
    from repro_torch.config import reduce_config
    from repro_torch.configs import get_config
    from repro_torch.launch.train import make_batch
    from repro_torch.models.model import build_model
    from repro_torch.training import checkpoint as ckpt_mod
    from repro_torch.training import data as data_mod
    from repro_torch.training import optimizer as opt_mod
    from repro_torch.training import train as train_mod
    _, _, one = runs
    cfg = reduce_config(get_config("llama3.2-1b"))
    model = build_model(cfg)
    step_fn = train_mod.make_train_step(model, adamw=opt_mod.AdamWConfig(
        lr=3e-4, total_steps=100, warmup_steps=5))
    data = data_mod.SyntheticLM(data_mod.DataConfig(
        vocab_size=cfg.vocab_size, seq_len=16, global_batch=8))
    params = model.init_params(0, device="cpu")
    state = opt_mod.init_state(params)
    for step in range(STEPS):
        params, state, _ = step_fn(params, state,
                                   make_batch(data, cfg, step, 8, "cpu"))
    want = {k: ckpt_mod._hash_array(ckpt_mod._to_numpy(x)[0])
            for k, x in ckpt_mod._leaf_paths((params, state))}
    got = {k: m["hash"] for k, (m, _) in _leaves(one["micro1"]).items()}
    assert got == want
