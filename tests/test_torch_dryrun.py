"""The port's dry run: the op counter (``launch/opcost.py``) and the
traced cells (``launch/dryrun.py``), on the CPU with meta tensors.

Every process group here is the fake backend's, made and destroyed by
the ``world`` fixture around one test, so no other test sees one."""
import dataclasses
import json
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.config import reduce_config as j_reduce
from repro.config import reduce_shape as j_reduce_shape
from repro.configs import get_config as j_get
from repro.models.model import build_model as j_build
from repro.training import train as j_train
from repro_torch.config import SHAPES, reduce_config, reduce_shape
from repro_torch.configs import get_config
from repro_torch.kernels import cost
from repro_torch.launch import dryrun, opcost

FAMILIES = ("llama3.2-1b", "granite-moe-3b-a800m", "llama-3.2-vision-11b",
            "whisper-tiny", "zamba2-1.2b", "rwkv6-1.6b")
KINDS = ("train_4k", "prefill_32k", "decode_32k")


@pytest.fixture
def world():
    """``world(n)``: a fake process group of n ranks for the block."""
    return dryrun.fake_world


def _mesh(shape):
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))


def test_opcost_collectives_multiply(world):
    """The counterpart of ``test_hlocost_trip_count_multiplies``: five
    [8,8] float32 matmuls, each followed by an all-reduce over a group
    of 4.  Flops 2*8*8*8 = 1024 each; wire 2*(g-1)/g of the 256-byte
    result each, 1920 in all.  JAX's test charges 192 each: it prices
    float32 at its TPU-native 2 bytes, to undo XLA:CPU's bf16 -> f32
    promotion; a torch trace keeps each tensor's own width."""
    import torch.distributed as dist
    import torch.distributed._functional_collectives as funcol
    with world(4):
        x = torch.empty((8, 8), dtype=torch.float32, device="meta")
        counter = opcost.OpCounter()
        with counter:
            for _ in range(5):
                x = funcol.all_reduce(x @ x, "sum", dist.group.WORLD)
                x = funcol.wait_tensor(x)
    s = counter.summary
    assert s.flops == pytest.approx(1024 * 5)
    assert s.matmul_flops == pytest.approx(1024 * 5)
    assert s.wire_bytes == pytest.approx(2 * 3 / 4 * 256 * 5)
    assert s.collectives["all_reduce"]["count"] == 5
    assert s.trip_counts == {}
    assert s.bytes_native == s.bytes_accessed


def _trace(arch, sname, shape=None):
    """A reduced cell on a mesh of ``shape`` (a process group must be
    behind it), or without one on one device's plain meta tensors."""
    cfg = reduce_config(get_config(arch))
    mesh = _mesh(shape) if shape else None
    counter, aux = dryrun.trace_cell(cfg, reduce_shape(SHAPES[sname]), mesh)
    return counter.summary, aux


@pytest.mark.parametrize("sname", KINDS)
@pytest.mark.parametrize("arch", FAMILIES)
def test_reduced_cells_trace_and_split(world, arch, sname):
    """Each family's cell traces on a 2x2 mesh.  Its matmul flops per
    device are the one-device count over the 4 devices when every
    product splits over both axes (the dense decoder's, its split decode
    included: kernel 1 returns each slice's log-sum-exp, so no plain
    scores are computed beside it), and at most over the 2 data shards
    where some weights stay whole over ``model`` (a router, Mamba's B/C
    projections, RWKV's decay LoRA, the VLM's patch projection)."""
    with world(4):
        split, aux = _trace(arch, sname, (2, 2))
    whole, _ = _trace(arch, sname)
    assert split.flops > 0 and aux["mem"]["peak_hint"] > 0
    if arch == "llama3.2-1b":
        assert split.matmul_flops == pytest.approx(whole.matmul_flops / 4)
    else:
        assert whole.matmul_flops / 4 <= split.matmul_flops \
            <= whole.matmul_flops / 2
    if arch != "rwkv6-1.6b" and sname != "decode_32k":
        assert split.kernels["flash_prefill"]["calls"] > 0
    if arch != "rwkv6-1.6b" and sname == "decode_32k":
        assert split.kernels["paged_decode"]["calls"] > 0
    assert split.wire_bytes > 0 and whole.wire_bytes == 0


def test_kernels_priced_by_cost_formulas(world):
    """A prefill cell's flash kernel calls carry ``kernels/cost.py``'s
    flash_cost of each rank's shard: batch over data, the query heads
    (and the K/V repeated to them) over model."""
    cfg = reduce_config(get_config("llama3.2-1b"))
    shape = reduce_shape(SHAPES["prefill_32k"])
    with world(4):
        s, _ = _trace("llama3.2-1b", "prefill_32k", (2, 2))
    b, sq, h, hd = shape.global_batch // 2, shape.seq_len, \
        cfg.n_heads // 2, cfg.hd
    t = torch.empty((b, sq, h, hd), dtype=torch.bfloat16, device="meta")
    nbytes, flops = cost.flash_cost({"q": t, "k": t, "v": t})
    k = s.kernels["flash_prefill"]
    assert k["calls"] == cfg.n_layers
    assert k["flops"] == flops * cfg.n_layers
    assert k["bytes"] == nbytes * cfg.n_layers


def test_split_decode_priced_as_kernel_1_with_lse(world):
    """At 2x2 the decode cache's sequence is split over ``model``: each
    rank's kernel 1 call covers its half of every row's keys, with the
    whole query (all heads) and the slice's log-sum-exp [B,Hq] float32
    as a second output, priced by ``cost.decode_cost`` plus that
    output's bytes; nothing else reads K."""
    cfg = reduce_config(get_config("llama3.2-1b"))
    shape = reduce_shape(SHAPES["decode_32k"])
    with world(4):
        s, _ = _trace("llama3.2-1b", "decode_32k", (2, 2))
    b, s_loc = shape.global_batch // 2, shape.seq_len // 2
    meta = dict(device="meta")
    q = torch.empty((b, cfg.n_heads, cfg.hd), dtype=torch.bfloat16, **meta)
    kp = torch.empty((b, s_loc, cfg.n_kv_heads, cfg.hd),
                     dtype=torch.bfloat16, **meta)
    tables = torch.empty((b, 1), dtype=torch.int32, **meta)
    nbytes, flops = cost.decode_cost(
        {"q": q, "k_pages": kp, "block_tables": tables}, b * s_loc)
    k = s.kernels["paged_decode"]
    assert k["calls"] == cfg.n_layers
    assert k["flops"] == flops * cfg.n_layers
    assert k["bytes"] == (nbytes + b * cfg.n_heads * 4) * cfg.n_layers


def _jax_argument_bytes(sname) -> int:
    """JAX's ``compiled.memory_analysis().argument_size_in_bytes`` of
    the reduced llama3.2-1b cell on the one CPU device."""
    cfg = j_reduce(j_get("llama3.2-1b"))
    shape = j_reduce_shape(SHAPES[sname])
    model = j_build(cfg)
    params = model.abstract_params()
    ins = model.input_specs(shape)
    if shape.kind == "train":
        step = j_train.make_train_step(model, n_micro=1)
        args = (params, j_train.abstract_opt_state(model), ins)
    elif shape.kind == "prefill":
        step, args = model.prefill, (params, ins)
    else:
        step = model.decode_step
        args = (params, model.abstract_decode_state(shape.global_batch,
                                                    shape.seq_len),
                jax.ShapeDtypeStruct((shape.global_batch,), jnp.int32))
    compiled = jax.jit(step).lower(*args).compile()
    return compiled.memory_analysis().argument_size_in_bytes


@pytest.mark.parametrize("sname", KINDS)
def test_argument_bytes_equal_jax(world, sname):
    """At a 1x1 mesh the trace's argument bytes are JAX's, exactly: the
    same leaves in the same dtypes (params, AdamW state, batch, decode
    state)."""
    with world(1):
        _, aux = _trace("llama3.2-1b", sname, (1, 1))
    assert aux["mem"]["argument_bytes"] == _jax_argument_bytes(sname)


def test_peak_hint_is_the_trace_peak(world):
    """peak_hint = arguments + temp + outputs - aliased (JAX's formula),
    which the fields make the trace's peak of live bytes plus the
    arguments; a decode step's state is written in place, so it is
    aliased."""
    with world(1):
        s, aux = _trace("llama3.2-1b", "decode_32k", (1, 1))
    m = aux["mem"]
    assert m["peak_hint"] == (m["argument_bytes"] + m["temp_bytes"]
                              + m["output_bytes"] - m["alias_bytes"])
    assert m["peak_hint"] == m["argument_bytes"] + s.peak_live_bytes
    cfg = reduce_config(get_config("llama3.2-1b"))
    shape = reduce_shape(SHAPES["decode_32k"])
    kv = 2 * cfg.n_layers * shape.global_batch * shape.seq_len \
        * cfg.n_kv_heads * cfg.hd * 2
    assert m["alias_bytes"] >= kv


# ---------------------------------------------------------------------------
# the reduced llama3.2-1b cells priced by JAX's hlocost and by the port
# ---------------------------------------------------------------------------
JAX_MESHES = {1: (1, 1), 4: (2, 2)}


def _jax_cells(n_dev: int) -> dict:
    """Run in a child process whose XLA_FLAGS give the CPU ``n_dev``
    devices (the test process keeps its one): each reduced llama3.2-1b
    cell lowered by JAX's ``lower_cell`` on a ``JAX_MESHES[n_dev]`` mesh
    and compiled.  Per cell, the flops of the ``dot`` ops without batch
    dimensions (the weight products; the batched ones are the ``jnp``
    attention, which the port runs as kernels), each multiplied by its
    enclosing loops' trip counts as ``hlocost`` does, and
    ``hlocost.analyze``'s collectives (floats charged at 2 bytes)."""
    import numpy as np
    devices = jax.devices()     # before JAX's dryrun module sets XLA_FLAGS
    assert len(devices) == n_dev
    from repro.launch import dryrun as jdry
    from repro.launch import hlocost
    mesh = jax.sharding.Mesh(np.array(devices).reshape(JAX_MESHES[n_dev]),
                             ("data", "model"))
    out = {}
    for sname in KINDS:
        lowered, _ = jdry.lower_cell(j_reduce(j_get("llama3.2-1b")),
                                     j_reduce_shape(SHAPES[sname]), mesh)
        hlo = lowered.compile().as_text()
        comps = hlocost.parse_module(hlo)
        entry = next(hlocost._COMP_HDR_RE.match(line).group(2)
                     for line in hlo.splitlines()
                     if line.startswith("ENTRY"))
        flops = [0.0]

        def walk(name, mult, stack=()):
            comp = comps.get(name)
            if comp is None or name in stack:
                return
            for op in comp.ops:
                if op.kind == "while":
                    m = hlocost._WHILE_ATTR_RE.search(op.line)
                    tm = hlocost._TRIP_RE.search(op.line)
                    trips = (int(tm.group(1)) if tm else
                             hlocost._trip_count(comps[m.group(1)]))
                    walk(m.group(2), mult * trips, stack + (name,))
                elif op.kind in ("call", "conditional", "async-start",
                                 "fusion"):
                    m = hlocost._CALL_ATTR_RE.search(op.line)
                    if m:
                        walk(m.group(1), mult, stack + (name,))
                elif (op.kind == "dot" and not re.search(
                        r"lhs_batch_dims=\{[\d,]+\}", op.line)):
                    lhs = hlocost._SHAPE_RE.search(
                        comp.shapes[op.operands[0]]).group(2).split(",")
                    contr = 1
                    for d in re.search(r"lhs_contracting_dims=\{([\d,]*)\}",
                                       op.line).group(1).split(","):
                        contr *= int(lhs[int(d)]) if d else 1
                    flops[0] += (2.0 * hlocost._result_elems(op.result_text)
                                 * contr * mult)

        walk(entry, 1)
        out[sname] = {"dot_flops": flops[0],
                      "collectives": hlocost.analyze(hlo).collectives}
    return out


@pytest.fixture(scope="module")
def jax_cells():
    """{n_dev: _jax_cells(n_dev)} from one child process per mesh."""
    out = {}
    for n_dev in JAX_MESHES:
        env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS=(
            f"--xla_force_host_platform_device_count={n_dev}"))
        r = subprocess.run([sys.executable, __file__, str(n_dev)], env=env,
                           capture_output=True, text=True, timeout=300)
        assert r.returncode == 0, r.stderr[-3000:]
        out[n_dev] = json.loads(r.stdout.strip().splitlines()[-1])
    return out


class _Width2Counter(opcost.OpCounter):
    """The op counter, also charging each collective's floats at 2 bytes
    (``wire2``), the width hlocost charges them at."""

    def _count(self, func, args, kwargs, ins, res, out):
        name = func._schema.name.split("::")[-1]
        if func.namespace == "_c10d_functional" and name in opcost.COLLECTIVES:
            g, _ = opcost._group(args[-1])
            rbytes = sum(t.numel() * (2 if t.is_floating_point()
                                      else t.element_size()) for t in res)
            slot = self.summary.collectives.setdefault(
                name, {"count": 0, "bytes": 0.0, "wire": 0.0})
            slot["wire2"] = slot.get("wire2", 0.0) + opcost.collective_wire(
                name, rbytes, g)
        return super()._count(func, args, kwargs, ins, res, out)


# The sum reductions at 2x2 (all-reduces, and the reduce-scatters the
# port makes where GSPMD all-reduces): the port's wire per device (floats
# at 2 bytes) against JAX's all-reduce wire, and JAX's all-reduces the
# port does not make.  Reduced llama3.2-1b: 2 layers, batch 1 and Hq 4 x
# hd 16 per device at 2x2.
REDUCTIONS = {
    # the same five [B,S,D] all-reduces (embedding, and each layer's two
    # row-parallel products); JAX adds one of the last position's row,
    # 64 floats
    "prefill_32k": {"minus_bytes": 2 * 64, "extra": 1},
    # the same all-reduces but for the split decode's weighted outputs
    # [B,Hq,hd] = 64 floats a layer: JAX all-reduces them (64 x 2 bytes on
    # the wire), the port reduce-scatters them into the head split of the
    # output product (32 x 2); JAX adds an all-reduce of two int32 (4
    # bytes by hlocost's tuple rule)
    "decode_32k": {"minus_bytes": 2 * (64 * 2 - 32 * 2) + 4, "extra": 1},
    # ZeRO-1: the port reduce-scatters every gradient into the moments'
    # split, half the wire of GSPMD's all-reduce of it; the port makes
    # more [B,S,D] all-reduces in the backward and the recompute than
    # XLA keeps (PERF.md §7), and XLA combines its all-reduces into
    # tuples, so neither the count nor an exact difference is held: the
    # ratio as measured (0.947), within 2 %
    "train_4k": {"ratio": 0.947, "tol": 0.02},
}


@pytest.mark.parametrize("n_dev", sorted(JAX_MESHES))
@pytest.mark.parametrize("sname", KINDS)
def test_cell_costs_against_jax(world, jax_cells, monkeypatch, sname, n_dev):
    """The reduced llama3.2-1b cell on a 1x1 and a 2x2 mesh, traced by
    the port and lowered by JAX.  The weight products' flops per device
    are JAX's exactly (hlocost's dot formula, trip counts applied): the
    port counts every product JAX's partitioned HLO has, at its local
    shape.  At 2x2 the sum reductions' wire per device (floats at 2
    bytes on both sides) and their count are JAX's less the reductions
    JAX makes and the port does not (REDUCTIONS, byte for byte; for the
    train step a ratio)."""
    monkeypatch.setattr(opcost, "OpCounter", _Width2Counter)
    with world(n_dev):
        s, _ = _trace("llama3.2-1b", sname, JAX_MESHES[n_dev])
    j = jax_cells[n_dev][sname]
    assert s.matmul_flops == pytest.approx(j["dot_flops"], rel=1e-12)
    if n_dev == 1:
        assert s.wire_bytes == 0
        return
    red = [s.collectives.get(k, {}) for k in ("all_reduce",
                                              "reduce_scatter_tensor")]
    wire = sum(c.get("wire2", 0.0) for c in red)
    jar = j["collectives"]["all-reduce"]
    want = REDUCTIONS[sname]
    if "ratio" in want:
        assert wire / jar["wire"] == pytest.approx(want["ratio"],
                                                   abs=want["tol"])
    else:
        assert wire == jar["wire"] - want["minus_bytes"]
        assert sum(c.get("count", 0) for c in red) == \
            jar["count"] - want["extra"]


@pytest.mark.parametrize("flag", sorted(dryrun.REFUSED))
def test_cli_refuses_jax_only_flags(flag, capsys):
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "llama3.2-1b", "--shape", "decode_32k",
                     flag])
    assert e.value.code == 2
    err = capsys.readouterr().err
    assert "no counterpart in the port" in err
    assert dryrun.REFUSED[flag] in err


def test_main_reports_a_failed_cell(world, monkeypatch, capsys):
    """A cell that raises is printed FAIL with where it failed, and main
    returns 1."""
    def boom(*a, **k):
        raise RuntimeError("no sharding rule")
    monkeypatch.setattr(dryrun, "trace_cell", boom)
    monkeypatch.setattr(dryrun, "PRODUCTION_SHAPES",
                        {False: ((2, 2), ("data", "model"))})
    monkeypatch.setattr(dryrun, "make_production_mesh",
                        lambda multi_pod=False: _mesh((2, 2)))
    assert dryrun.main(["--arch", "llama3.2-1b", "--shape",
                        "decode_32k"]) == 1
    out = capsys.readouterr().out
    assert "FAIL llama3.2-1b x decode_32k" in out
    assert "no sharding rule" in out
    import torch.distributed as dist
    assert not dist.is_initialized()


def test_peak_flops_constants_from_one_place():
    """chip_smoke.py and the roofline price with launch/mesh.py's
    numbers."""
    from repro_torch.launch import mesh
    assert cost.bound(mesh.HBM_BW * 1e-3, 0.0) == (1.0, "bytes")
    assert cost.bound(0.0, mesh.PEAK_FLOPS_BF16 * 1e-3) == (1.0,
                                                            "operations")
    assert mesh.group_link_bw(range(8)) == mesh.NVLINK_BW
    assert mesh.group_link_bw(range(16)) == mesh.NODE_LINK_BW
    assert dataclasses.is_dataclass(opcost.CostSummary)


if __name__ == "__main__":
    print(json.dumps(_jax_cells(int(sys.argv[1]))))
