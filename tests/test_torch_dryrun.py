"""The port's dry run: the op counter (``launch/opcost.py``) and the
traced cells (``launch/dryrun.py``), on the CPU with meta tensors.

Every process group here is the fake backend's, made and destroyed by
the ``world`` fixture around one test, so no other test sees one."""
import dataclasses
import json
import math
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
# the reduced MoE cell, held at 2x2 only
MOE_CELL = ("granite-moe-1b-a400m", "train_4k")
# the recurrent and cross-attention families' train cells, held at 1x1
# and 2x2
FAMILY_CELLS = (("rwkv6-1.6b", "train_4k"), ("zamba2-1.2b", "train_4k"),
                ("whisper-tiny", "train_4k"))


def _jax_cells(n_dev: int) -> dict:
    """Run in a child process whose XLA_FLAGS give the CPU ``n_dev``
    devices (the test process keeps its one): each reduced llama3.2-1b
    cell and ``FAMILY_CELLS`` (and at 2x2 ``MOE_CELL``; keyed
    "arch/shape") lowered by JAX's ``lower_cell`` on a
    ``JAX_MESHES[n_dev]`` mesh and compiled.  Per cell, the flops of the
    ``dot`` ops without batch dimensions (the weight products; the
    batched ones are the ``jnp`` attention, which the port runs as
    kernels), each multiplied by its enclosing loops' trip counts as
    ``hlocost`` does; ``weight_flops``, those of them whose einsum (the
    op's name) takes a weight as its second operand, one with no batch
    index "b" (XLA drops a batch dim of size one, which turns a mixer's
    product over one row and one chunk into a dot without batch
    dimensions, and names it no einsum); ``hlocost.analyze``'s
    collectives (floats charged at 2 bytes) and every all-reduce's
    elements (``ar_elems``: each operand's dims, as many times as its
    loops run; ``hlocost`` charges a tuple all-reduce half its
    elements' bytes)."""
    import numpy as np
    devices = jax.devices()     # before JAX's dryrun module sets XLA_FLAGS
    assert len(devices) == n_dev
    from repro.launch import dryrun as jdry
    from repro.launch import hlocost
    mesh = jax.sharding.Mesh(np.array(devices).reshape(JAX_MESHES[n_dev]),
                             ("data", "model"))
    out = {}
    cells = [("llama3.2-1b", sname) for sname in KINDS] + list(FAMILY_CELLS)
    if n_dev > 1:
        cells.append(MOE_CELL)
    for arch, sname in cells:
        lowered, _ = jdry.lower_cell(j_reduce(j_get(arch)),
                                     j_reduce_shape(SHAPES[sname]), mesh)
        hlo = lowered.compile().as_text()
        comps = hlocost.parse_module(hlo)
        entry = next(hlocost._COMP_HDR_RE.match(line).group(2)
                     for line in hlo.splitlines()
                     if line.startswith("ENTRY"))
        cfg = j_reduce(j_get(arch))
        slots = None
        if cfg.n_experts:
            # the one-hot dispatch / combine products contract or make the
            # slot dim, experts x capacity (the port scatters instead)
            from repro.models import moe as jmoe
            sh = j_reduce_shape(SHAPES[sname])
            t = sh.global_batch * sh.seq_len
            ng = jmoe._n_groups(t, JAX_MESHES[n_dev][0])
            slots = cfg.layout_n_experts * max(4, math.ceil(
                t // ng * cfg.top_k / cfg.n_experts * cfg.capacity_factor))
        flops = [0.0]
        weight_flops = [0.0]
        expert_flops = [0.0]
        ar_elems = []

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
                elif op.kind in ("all-reduce", "all-reduce-start"):
                    ar_elems.extend([dims] * mult for _, dims in
                                    hlocost._SHAPE_RE.findall(
                                        op.result_text))
                elif op.kind == "dot":
                    lhs, rhs = (hlocost._SHAPE_RE.search(
                        comp.shapes[o]).group(2).split(",")
                        for o in op.operands[:2])
                    contr = 1
                    for d in re.search(r"lhs_contracting_dims=\{([\d,]*)\}",
                                       op.line).group(1).split(","):
                        contr *= int(lhs[int(d)]) if d else 1
                    f = (2.0 * hlocost._result_elems(op.result_text)
                         * contr * mult)
                    dims = lhs + rhs + hlocost._SHAPE_RE.search(
                        op.result_text).group(2).split(",")
                    if re.search(r"lhs_batch_dims=\{[\d,]+\}", op.line):
                        # the experts' products, batched over the experts
                        if re.search(r"gec[df],e[df][df]->gec[df]", op.line):
                            expert_flops[0] += f
                    elif slots is None or str(slots) not in dims:
                        flops[0] += f
                        name = re.search(r'op_name="([^"]*)"', op.line)
                        specs = re.findall(r"([\w.]+(?:,[\w.]+)+)->",
                                           name.group(1) if name else "")
                        operands = specs[-1].split(",") if specs else []
                        if len(operands) == 2 and "b" not in operands[1]:
                            weight_flops[0] += f

        walk(entry, 1)
        key = sname if arch == "llama3.2-1b" else f"{arch}/{sname}"
        out[key] = {"dot_flops": flops[0], "weight_flops": weight_flops[0],
                    "expert_flops": expert_flops[0],
                    "collectives": hlocost.analyze(hlo).collectives,
                    "ar_elems": [d for ds in ar_elems for d in ds]}
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
    (``wire2``), the width hlocost charges them at, listing each
    all-reduce's result shape (``shapes``), and summing the flops of the
    products without a batch dimension (``mm_flops``: ``mm`` and
    ``addmm``; the port runs every weight product as one)."""

    def _count(self, func, args, kwargs, ins, res, out):
        name = func._schema.name.split("::")[-1]
        if name in ("mm", "addmm"):
            from torch.utils.flop_counter import flop_registry
            self.summary.mm_flops = getattr(self.summary, "mm_flops", 0.0) \
                + float(flop_registry[func._overloadpacket](
                    *args, **kwargs, out_val=out))
        if func.namespace == "_c10d_functional" and name in opcost.COLLECTIVES:
            g, _ = opcost._group(args[-1])
            rbytes = sum(t.numel() * (2 if t.is_floating_point()
                                      else t.element_size()) for t in res)
            slot = self.summary.collectives.setdefault(
                name, {"count": 0, "bytes": 0.0, "wire": 0.0})
            slot["wire2"] = slot.get("wire2", 0.0) + opcost.collective_wire(
                name, rbytes, g)
            slot.setdefault("shapes", []).extend(
                ",".join(map(str, t.shape)) for t in res)
        return super()._count(func, args, kwargs, ins, res, out)


# The sum reductions at 2x2 (all-reduces, and the reduce-scatters the
# port makes where GSPMD all-reduces): the port's wire per device (floats
# at 2 bytes) against hlocost's all-reduce wire, byte for byte less
# ``minus_bytes``, and their count less ``extra`` (None: not comparable).
# Reduced llama3.2-1b: 2 layers, batch 1, S 64, D 64 and Hq 4 x hd 16 per
# device at 2x2; a [B,S,D] all-reduce is 4096 floats, 8192 bytes.
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
    # The train step, op by op (hlocost charges a tuple all-reduce half
    # its elements' bytes, taking it for a -start op's (input, output)
    # pair, and XLA combines all-reduces into tuples, so the count is not
    # comparable: the bytes alone are held, and the [B,S,D] all-reduces
    # element by element below):
    # * the same [B,S,D] all-reduces in the forward (embedding, two a
    #   layer), remat's recompute (the attention output's, one a layer)
    #   and the logits' backward: 8 x 8192 bytes on both sides;
    # * each layer's input gradients: JAX all-reduces the partial
    #   gradients of q, k, v (a tuple of 3 [B,S,D], charged 12288) and of
    #   gate, up (a tuple of 2, charged 8192) one by one; the port sums
    #   each group's partials first and all-reduces twice (2 x 8192):
    #   4096 a layer, 8192 in all;
    # * the loss: JAX's tuple of five scalars and the label logits
    #   [B,S,1] (charged (5 x 2 + 128) / 2 = 69) against the port's one
    #   all-reduce of the label logits (128): -59; the max and sum [B,S]
    #   all-reduces the same (2 x 128);
    # * JAX's two scalar tuples (12 + 3 elements, charged 12 and 3)
    #   against the port's four scalar all-reduces of the gradient norm
    #   (4 x 2): +7;
    # * the weight gradients: JAX's all-reduces over "data" (tuples,
    #   charged 2 x 18560 + 8256) move what the port's ZeRO-1
    #   reduce-scatters into the moments' split move, 45376 bytes.
    "train_4k": {"minus_bytes": 2 * 4096 - 59 + 7, "extra": None},
}
# [B,S,D] all-reduces of the train step: JAX's elements less the port's
# (three a layer: the partial input gradients the port sums first)
BSD_MERGED = {"train_4k": 3 * 2}


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
    train step the bytes, and its [B,S,D] all-reduces element by
    element)."""
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
    assert wire == jar["wire"] - want["minus_bytes"]
    if want["extra"] is not None:
        assert sum(c.get("count", 0) for c in red) == \
            jar["count"] - want["extra"]
    if sname in BSD_MERGED:
        bsd = "1,64,64"          # [B,S,D] at 2x2: batch 1 a device
        assert s.collectives["all_reduce"]["shapes"].count(bsd) == \
            j["ar_elems"].count(bsd) - BSD_MERGED[sname]


# The reduced MoE train cell at 2x2 (granite-moe-1b-a400m: 2 layers, 4
# experts top-2, capacity 40 a group, D 64, batch 1 and S 64 a device),
# op by op, hlocost's bytes against the port's:
# * JAX reduces each layer's expert output in slot space [G,E,C,D] (10240
#   floats, 20480 bytes); the port combines first and reduces in token
#   space [B,S,D] (8192): 12288 a layer;
# * the backward of the expert products: JAX's tuple of three slot-space
#   partial gradients (charged 30720) against the port's one, of their
#   sum (20480): 10240 a layer; q, k, v as in the dense cell: 4096 a
#   layer;
# * the router's load statistics [E] float32: JAX's forward tuple of two
#   (charged 8) and its recompute's one (8) against the port's one in the
#   forward (the top-k counts, 8) and one in the backward (the gradient
#   of the summed probabilities, a partial sum over "data" in the
#   forward, arrives whole: 8), a layer: 0; the port multiplies the
#   counts into the probabilities' partial sum and all-reduces the aux
#   loss itself, both layers' [2] at once in the loss: 4;
# * the port's extra, 256 a layer: its token-space combine makes the
#   combine weights' gradient [B,S,k] a partial sum over "model" (an
#   all-reduce, 256); it pays for reducing the expert output in token
#   space, 12288 a layer less (above). The load statistics are summed
#   per data shard (``moe._sharded_load_sums``), so the probabilities'
#   gradient [B,S,E] stays local: no reduce-scatter;
# * the weight gradients: as the dense cell's, but for the router
#   [L,D,E]: JAX charges its [E,D/2] tuple element 128 a layer, the
#   port's ZeRO-1 reduce-scatter moves 512: -256 in all;
# * the loss and scalars as the dense cell's (-59 + 8: JAX's scalar
#   tuples hold 16 elements here).
MOE_MINUS = (2 * 12288 + 2 * 10240 + 2 * 4096 - 4 - 2 * 256 - 256
             - 59 + 8)


# The router's weight gradient: JAX computes an [E, D/2] half of it a
# device (t = 64 tokens) and trades halves by a collective permute, the
# port the whole [D, E] on each device: 2 x E x D/2 x t flops more a
# layer.
MOE_ROUTER_GRAD = 2 * (2 * 4 * 32 * 64)


def test_moe_train_costs_against_jax(world, jax_cells, monkeypatch):
    """``MOE_CELL`` on a 2x2 mesh: the weight products' flops per device
    are JAX's exactly (its unbatched products less the one-hot dispatch
    and combine, which the port scatters and gathers, plus the experts'
    batched products), but for ``MOE_ROUTER_GRAD``; the sum reductions'
    wire is JAX's less ``MOE_MINUS`` (op by op above; the count is not
    comparable, as in the dense train cell)."""
    monkeypatch.setattr(opcost, "OpCounter", _Width2Counter)
    with world(4):
        s, _ = _trace(*MOE_CELL, JAX_MESHES[4])
    j = jax_cells[4]["/".join(MOE_CELL)]
    assert s.matmul_flops == pytest.approx(
        j["dot_flops"] + j["expert_flops"] + MOE_ROUTER_GRAD, rel=1e-12)
    wire = sum(s.collectives.get(k, {}).get("wire2", 0.0)
               for k in ("all_reduce", "reduce_scatter_tensor"))
    assert wire == j["collectives"]["all-reduce"]["wire"] - MOE_MINUS


# The family cells at 2x2, op by op, hlocost's all-reduce bytes against
# the port's sum reductions (JAX's less the port's; floats at 2 bytes;
# batch 1 and S 64 a device, D 64, 4 heads of 16 split 2 a device; a
# decoder-side [B,S,D] all-reduce 8192 bytes).  On every side the same
# forward [B,S,D] all-reduces (the embedding and each row-parallel
# product), the same of remat's recompute and of the logits' backward;
# the port all-reduces each group of partial input gradients once, on
# their sum, where JAX all-reduces a tuple of them (charged half its
# elements' bytes), and reduce-scatters the weight gradients into ZeRO-1's
# split where JAX all-reduces tuples over "data" (the same bytes, but as
# stated).  The loss: JAX's max and sum [B,S] all-reduces and a tuple of
# scalars with the label logits [B,S,1] against the port's three [B,S]
# all-reduces (384).  The scalars: JAX's scalar tuples against the
# port's four gradient-norm all-reduces (8).
FAMILY_MINUS = {
    # rwkv6-1.6b, 2 layers, decay LoRA 32, F 128:
    # * the loss: 128 + 128 + (7 x 2 + 128) / 2 = 327 against 384: -57;
    # * the time mix's input gradients: JAX's tuple of five (the r, k, v,
    #   g products' [B,S,D] and the decay LoRA activation's [B,S,32],
    #   36864 bytes) charged 18432 a layer, against the port's four
    #   [B,S,D] all-reduces and its reduce-scatter of the LoRA
    #   activation's gradient into the sequence split (2048; gathered
    #   whole at the decay's input, where JAX reduces the whole and
    #   splits the product after): -16384 a layer;
    # * the channel mix's: JAX's tuple of two [B,S,D] charged 8192 a
    #   layer (XLA splits the receptance product cw_r over "model", so
    #   xr's gradient is a partial sum too); the rules keep cw_r whole,
    #   so the port all-reduces xk's alone, 8192: 0;
    # * the port's extra, 4096 a layer: the gate's backward reads the
    #   value product kv as DTensor saved it, a partial sum (the port
    #   all-reduces the channel mix's output after the gate, in the
    #   residual: one forward all-reduce, as JAX's), and reduce-scatters
    #   it. It stays: reducing kv before the gate moves the all-reduce
    #   into remat's recompute as well (8192 a layer), since the port's
    #   remat keeps no collective's output;
    # * the weight gradients: XLA computes cw_r's and decay_a's split
    #   over "model" (collective permutes gather them) and all-reduces
    #   [D, D/2] and [D/2, LoRA] halves, 3072 elements a layer fewer than
    #   the port's whole [D, D] and [D, LoRA]: -6144; JAX sums the
    #   embedding table's gradient through an all-to-all of the token
    #   rows' gradients and a scatter-add, no all-reduce, where the port
    #   reduce-scatters the table's [V/2, D] gradient: -8192; JAX's lone
    #   [D] all-reduce of a norm scale is charged whole (128), the
    #   port's reduce-scatter of it moves 64: +64;
    # * the scalars: 36 against 8: +28.
    "rwkv6-1.6b": -57 - 2 * 16384 - 2 * 4096 - 6144 - 8192 + 64 + 28,
    # zamba2-1.2b, 4 Mamba2 layers (d_inner 128, N 16, 8 heads: 64 and 4
    # a device), the shared attention block applied twice:
    # * the gated norm's statistics over the split d_inner: JAX's [B,S]
    #   all-reduce in the forward (128) and a tuple of two in remat's
    #   recompute and the backward (charged 128), against the port's
    #   three reduce-scatters of [B,S,1] into the sequence split (3 x
    #   64), a layer: +256;
    # * the loss: 128 + 128 + (8 x 2 + 128) / 2 = 328 against 384: -56;
    # * the Mamba input gradients: JAX's tuple of six (three [B,S,D],
    #   B's and C's [B,S,N], one [B,S,64]; 36864 bytes) charged 18432 a
    #   layer, against the port's all-reduce of their [B,S,D] sum (8192)
    #   and of B's and C's gradients (2 x 2048): +6144 a layer;
    # * the shared block's input gradients: q, k, v's tuple charged 12288
    #   against the port's one of their sum (8192), gate and up's tuple
    #   charged 8192 against the port's one (8192), an application:
    #   +8192;
    # * the weight gradients: JAX all-reduces the shared block's over
    #   "data" once an application (wq, wk, wv, wo 2048 each, w_gate,
    #   w_up, w_down 4096 each, ln1 and ln2 64 each: 20608), the port
    #   once, their sum: +20608; XLA computes w_B's and w_C's split over
    #   "model" ([N, D/2] halves, 512 elements each) where the port
    #   computes them whole (1024 each; FAMILY_FLOPS): -4 x 1024;
    # * the scalars: 35 against 8: +27.
    "zamba2-1.2b": 256 - 56 + 4 * 6144 + 8192 + 20608 - 4 * 1024 + 27,
    # whisper-tiny, 2 encoder layers over 16 frames (a [B,P,D] all-reduce
    # 2048) and 2 decoder layers with cross attention:
    # * the loss: 128 + 128 + (14 x 2 + 128) / 2 = 334 against 384: -50;
    # * the decoder's self-attention input gradients: q, k, v's tuple
    #   charged 12288 against the port's one of their sum (8192), a
    #   layer: +8192; the FFN's: gate and up's tuple charged 8192 against
    #   the port's 8192: 0;
    # * the cross attention's: JAX's tuple of the query's [B,S,D] and K's
    #   and V's [B,P,D] input gradients (12288) charged 6144 a layer,
    #   against the port's all-reduce of the query's a layer (2 x 8192)
    #   and of the K/V input gradients summed over the layers, once, at
    #   the encoder's output (2048): -6144;
    # * the encoder's: q, k, v's tuple charged 3072 against the port's
    #   2048, a layer: +2048; the FFN's tuple charged 2048 against 2048:
    #   0;
    # * the weight gradients: JAX's lone [D] all-reduce of a norm scale
    #   charged whole (128), the port's reduce-scatter of it 64: +64;
    # * the scalars: 32 against 8: +24.
    "whisper-tiny": -50 + 8192 - 6144 + 2048 + 64 + 24,
}
# The weight products' flops at 2x2, the port's more than JAX's: XLA
# splits w_B's and w_C's gradient products over "model" (each rank one
# [N, D/2] half), the port computes them whole on each rank: 2 x N x D/2
# x t flops more a product, two a layer (t = 64 tokens).
FAMILY_FLOPS = {"zamba2-1.2b": 4 * 2 * (2 * 16 * 32 * 64)}


@pytest.mark.parametrize("n_dev", sorted(JAX_MESHES))
@pytest.mark.parametrize("arch", [cell[0] for cell in FAMILY_CELLS])
def test_family_train_costs_against_jax(world, jax_cells, monkeypatch, arch,
                                        n_dev):
    """A ``FAMILY_CELLS`` cell on a 1x1 and a 2x2 mesh, traced by the
    port and lowered by JAX: the weight products' flops per device (the
    port's ``mm`` / ``addmm``, JAX's ``weight_flops``) are JAX's exactly,
    but for FAMILY_FLOPS at 2x2; the mixers' products (the WKV and SSD
    chunks, batched) and the attention (kernels on the port's side) are
    kept apart.  At 2x2 the sum reductions' wire per device is JAX's
    all-reduce wire less FAMILY_MINUS (op by op above; the counts are
    not comparable, as in the dense train cell)."""
    monkeypatch.setattr(opcost, "OpCounter", _Width2Counter)
    sname = dict(FAMILY_CELLS)[arch]
    with world(n_dev):
        s, _ = _trace(arch, sname, JAX_MESHES[n_dev])
    j = jax_cells[n_dev][f"{arch}/{sname}"]
    extra = FAMILY_FLOPS.get(arch, 0) if n_dev > 1 else 0
    assert s.mm_flops == pytest.approx(j["weight_flops"] + extra,
                                       rel=1e-12)
    if n_dev == 1:
        assert s.wire_bytes == 0
        return
    wire = sum(s.collectives.get(k, {}).get("wire2", 0.0)
               for k in ("all_reduce", "reduce_scatter_tensor"))
    assert wire == j["collectives"]["all-reduce"]["wire"] - FAMILY_MINUS[arch]


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
