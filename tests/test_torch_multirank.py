"""Four real ranks on the CPU (``gloo``), a (2, 2) ("data", "model")
mesh: the port's distribution computes what one process computes.

Each rank places the same seeded values by the rules and checks, against
the one-process port on the same values:

* the reduced llama3.2-1b's float32 ``prefill`` logits, params placed by
  ``tree_shardings`` and the tokens by ``batch_shardings`` (within 1e-5);
* a decode step over the slot cache split over the sequence (the split
  decode and the in-place write of each shard; logits within 1e-5, the
  caches exact);
* ``MeshSharding.embed_lookup`` against a vocab-sharded table (exact);
* one AdamW step with the optimizer state placed by ``zero1_shardings``
  and the gradients a partial sum over the data axis (within 1e-6).

The ranks run in spawned processes with a time limit of their own
(``LIMIT_S``); the test process never joins a process group."""
import json
import os
import socket
import time

import numpy as np
import torch

LIMIT_S = 150.0
WORLD = 4


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _checks(rank: int) -> dict:
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Partial, Replicate
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.config import reduce_config
    from repro_torch.configs import get_config
    from repro_torch.distributed import sharding as shlib
    from repro_torch.models.common import tree_leaves, tree_map
    from repro_torch.models.model import build_model
    from repro_torch.training import optimizer as opt_mod

    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    cfg = reduce_config(get_config("llama3.2-1b"))
    out = {}

    # -- prefill logits ------------------------------------------------------
    plain = build_model(cfg)
    params = plain.init_params(0, device="cpu", dtype=torch.float32)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (4, 16)).astype(np.int32))
    want, want_state = plain.prefill(params, {"tokens": tokens})
    shd = shlib.MeshSharding(mesh)
    model = build_model(cfg, shd)
    placed = tree_map(lambda p, pl: shlib.place(p, mesh, pl), params,
                      shlib.tree_shardings(model.specs, mesh))
    tok = shlib.place(tokens, mesh, shlib.batch_shardings(
        {"t": tokens}, mesh)["t"])
    with implicit_replication():
        got, state = model.prefill(placed, {"tokens": tok})
    out["prefill_err"] = float((got.full_tensor() - want).abs().max())
    out["k_err"] = float((state["k"].full_tensor()
                          - want_state["k"]).abs().max())
    out["k_placements"] = [repr(p) for p in state["k"].placements]

    # -- a decode step over the sequence-sharded slot cache ---------------------
    st = plain.init_decode_state(4, 32, device="cpu")
    for key in ("k", "v"):
        st[key][:, :, :16] = want_state[key].to(st[key].dtype)
    st["lengths"][:] = 16
    nxt = tokens[:, -1].clone()
    pst = tree_map(lambda t, pl: shlib.place(t, mesh, pl), st,
                   shlib.tree_shardings(plain.decode_state_specs(4, 32),
                                        mesh))
    want_d, want_st = plain.decode_step(params, tree_map(torch.clone, st),
                                        nxt)
    with implicit_replication():
        got_d, pst = model.decode_step(placed, pst, shlib.place(
            nxt, mesh, shlib.batch_shardings({"t": nxt}, mesh)["t"]))
    out["decode_err"] = float((got_d.full_tensor() - want_d).abs().max())
    out["cache_err"] = float(max(
        (pst[key].full_tensor() - st2).abs().max()
        for key, st2 in (("k", want_st["k"]), ("v", want_st["v"]))))

    # -- embed_lookup against a vocab-sharded table ----------------------------
    emb = placed["embed"]
    with implicit_replication():
        rows = shd.embed_lookup(emb, tok[:, 0])
    out["embed_placement"] = repr(emb.placements)
    out["embed_err"] = float((rows.full_tensor()
                              - params["embed"][tokens[:, 0].long()]
                              ).abs().max())

    # -- one AdamW step, ZeRO-1 state ------------------------------------------
    rng = np.random.default_rng(1)
    grads = tree_map(lambda p: torch.from_numpy(rng.standard_normal(
        tuple(p.shape)).astype(np.float32)), params)
    state0 = opt_mod.init_state(params)
    cfg_opt = opt_mod.AdamWConfig(lr=1e-3, warmup_steps=1)
    w_params, w_state, w_m = opt_mod.apply_updates(cfg_opt, params, grads,
                                                   state0)
    z1 = shlib.zero1_shardings(model.specs, mesh)
    p_pl = shlib.tree_shardings(model.specs, mesh)
    pstate = opt_mod.AdamWState(
        step=state0.step,
        master=tree_map(lambda t, pl: shlib.place(t, mesh, pl),
                        state0.master, z1),
        m=tree_map(lambda t, pl: shlib.place(t, mesh, pl), state0.m, z1),
        v=tree_map(lambda t, pl: shlib.place(t, mesh, pl), state0.v, z1))

    def partial(g, pl):
        # each data rank holds half the gradient: a partial sum
        full = shlib.place(g, mesh, [Replicate()] + list(pl[1:]))
        return DTensor.from_local(full.to_local() / 2, mesh,
                                  [Partial()] + list(pl[1:]),
                                  run_check=False)

    pgrads = tree_map(partial, grads, p_pl)
    with implicit_replication():
        g_params, g_state, g_m = opt_mod.apply_updates(cfg_opt, placed,
                                                       pgrads, pstate)
    errs = []
    for tree_w, tree_g in ((w_state.master, g_state.master),
                           (w_state.m, g_state.m), (w_state.v, g_state.v)):
        errs += [float((g.full_tensor() - w).abs().max())
                 for w, g in zip(tree_leaves(tree_w), tree_leaves(tree_g))]
    out["adamw_err"] = max(errs)
    out["grad_norm_err"] = float(abs(g_m["grad_norm"].full_tensor()
                                     - w_m["grad_norm"]))
    out["param_placements_kept"] = all(
        list(g.placements) == list(p.placements)
        for g, p in zip(tree_leaves(g_params), tree_leaves(placed)))
    out["zero1_placed"] = sorted({repr(x.placements) for x in
                                  tree_leaves(g_state.m)})
    dist.barrier()
    return out


def _worker(rank: int, port: int, out_dir: str) -> None:
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=WORLD, rank=rank)
    try:
        res = _checks(rank)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"{rank}.json"), "w") as f:
        json.dump(res, f)


def test_four_ranks_match_one_process(tmp_path):
    import torch.multiprocessing as mp
    ctx = mp.start_processes(_worker, args=(_free_port(), str(tmp_path)),
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
    for rank in range(WORLD):
        res = json.loads((tmp_path / f"{rank}.json").read_text())
        assert res["prefill_err"] <= 1e-5, res
        assert res["k_err"] <= 1e-5, res
        assert "Shard(dim=2)" in res["k_placements"]     # kv_seq over model
        assert res["decode_err"] <= 1e-5, res
        assert res["cache_err"] == 0.0, res
        assert "Shard(dim=0)" in res["embed_placement"]  # vocab-sharded
        assert res["embed_err"] == 0.0, res
        assert res["adamw_err"] <= 1e-6, res
        assert res["grad_norm_err"] <= 1e-4, res
        assert res["param_placements_kept"], res
        assert any("Shard" in p and p.startswith("(Shard")
                   for p in res["zero1_placed"]), res
