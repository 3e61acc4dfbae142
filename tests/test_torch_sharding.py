"""The port's sharding rules (``repro_torch.distributed.sharding``) and its
dry-run stand-ins (``abstract_params``, ``abstract_opt_state``,
``input_specs``, ``abstract_decode_state``) against the JAX package's,
at production sizes.

The JAX side runs its rule functions on ``jax.sharding.AbstractMesh``
(no devices), the port's on ``MeshShape`` (no ranks): no process group
exists in this process.  For every arch in the registry at full size,
on both production meshes and under each of the four rule sets, every
leaf's rule, even-divisibility check and ZeRO-1 spec must equal JAX's:
the parameter tree, the decode state at ``decode_32k`` and
``long_500k``, and the batch of every shape's inputs."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh
from jax.sharding import PartitionSpec as JP

from repro.config import SHAPES as J_SHAPES
from repro.config import shape_applicable as j_applicable
from repro.configs import REGISTRY as J_REGISTRY
from repro.distributed import sharding as jsh
from repro.models.common import PSpec as JPSpec
from repro.models.model import build_model as j_build
from repro.training import train as j_train
from repro_torch.config import SHAPES
from repro_torch.configs import REGISTRY
from repro_torch.distributed import sharding as tsh
from repro_torch.models.common import tree_leaves
from repro_torch.models.model import build_model
from repro_torch.training import train as t_train

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
RULE_SETS = ("BASE_RULES", "LONG_CONTEXT_RULES", "EP_RULES", "SP_RULES")


def _jleaves(tree):
    return jax.tree.leaves(tree, is_leaf=lambda x: isinstance(x, JPSpec))


def _same(jspec, tspec) -> bool:
    return tuple(jspec) == tuple(tspec)


def _check_tree(jspecs, tspecs, jrules, trules, amesh, tmesh, what):
    """Leaf by leaf: logical_to_pspec, _evenly_shardable and zero1_spec."""
    jl, tl = _jleaves(jspecs), tree_leaves(tspecs)
    assert len(jl) == len(tl), what
    for i, (j, t) in enumerate(zip(jl, tl)):
        assert tuple(j.shape) == tuple(t.shape) and j.axes == t.axes, \
            (what, i)
        jp = jsh.logical_to_pspec(j.axes, jrules)
        tp = tsh.logical_to_pspec(t.axes, trules)
        assert _same(jp, tp), (what, i, jp, tp)
        je = jsh._evenly_shardable(jp, j.shape, amesh)
        te = tsh._evenly_shardable(tp, t.shape, tmesh)
        assert _same(je, te), (what, i, je, te)
        jz = jsh.zero1_spec(je, j.shape, amesh)
        tz = tsh.zero1_spec(te, t.shape, tmesh)
        assert _same(jz, tz), (what, i, jz, tz)


@pytest.mark.parametrize("rules", RULE_SETS)
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(REGISTRY))
def test_rules_match_jax(arch, mesh, rules):
    shape, names = MESHES[mesh]
    amesh = AbstractMesh(shape, names)
    tmesh = tsh.MeshShape(shape, names)
    jrules = jsh._filter_axes(getattr(jsh, rules), amesh)
    trules = tsh._filter_axes(getattr(tsh, rules), tmesh)
    assert jrules == trules
    jm, tm = j_build(J_REGISTRY[arch]), build_model(REGISTRY[arch])
    _check_tree(jm.specs, tm.specs, jrules, trules, amesh, tmesh, "params")
    for sname in ("decode_32k", "long_500k"):
        s = SHAPES[sname]
        _check_tree(jm.decode_state_specs(s.global_batch, s.seq_len),
                    tm.decode_state_specs(s.global_batch, s.seq_len),
                    jrules, trules, amesh, tmesh, sname)
    for sname, s in SHAPES.items():
        jb = jsh.batch_shardings(jm.input_specs(J_SHAPES[sname]), amesh,
                                 getattr(jsh, rules))
        tb = {k: tsh.batch_pspec(tuple(v.shape), tmesh, getattr(tsh, rules))
              for k, v in tm.input_specs(s).items()}
        assert sorted(jb) == sorted(tb)
        for k in tb:
            assert _same(jb[k].spec, tb[k]), (sname, k)
    # the placements say the same: Shard(dim) on each axis of a dim's entry
    from torch.distributed.tensor import Replicate, Shard
    pl = tsh.to_placements(tsh.P(trules["batch"], None, "model"), tmesh)
    for axis, p in zip(names, pl):
        if axis == "model":
            assert p == Shard(2)
        else:
            assert p == (Shard(0) if axis in (trules["batch"] or ())
                         else Replicate())


def _shape_dtype(t) -> tuple:
    return tuple(t.shape), str(t.dtype).replace("torch.", "")


def _cells():
    for arch in sorted(REGISTRY):
        for sname in SHAPES:
            if j_applicable(J_REGISTRY[arch], J_SHAPES[sname])[0]:
                yield arch, sname


@pytest.mark.parametrize("arch,sname", list(_cells()))
def test_abstract_trees_match_jax(arch, sname):
    jm, tm = j_build(J_REGISTRY[arch]), build_model(REGISTRY[arch])
    s, js = SHAPES[sname], J_SHAPES[sname]
    pairs = [(jm.abstract_params(), tm.abstract_params()),
             (jm.input_specs(js), tm.input_specs(s))]
    if s.kind == "decode":
        pairs.append((jm.abstract_decode_state(s.global_batch, s.seq_len),
                      tm.abstract_decode_state(s.global_batch, s.seq_len)))
    if s.kind == "train":
        jo, to = j_train.abstract_opt_state(jm), t_train.abstract_opt_state(tm)
        pairs += [(jo.step, to.step), (jo.master, to.master), (jo.m, to.m),
                  (jo.v, to.v)]
    for jt, tt in pairs:
        jl, tl = jax.tree.leaves(jt), tree_leaves(tt)
        assert len(jl) == len(tl)
        for j, t in zip(jl, tl):
            assert t.device.type == "meta"
            assert (tuple(j.shape), jnp.dtype(j.dtype).name) \
                == _shape_dtype(t)


# -- the cases of tests/test_sharding_and_costs.py ---------------------------
ONE = tsh.MeshShape((1, 1), ("data", "model"))


def test_logical_to_pspec():
    rules = {"vocab": "model", "embed": None, "batch": ("pod", "data")}
    assert tsh.logical_to_pspec(("vocab", "embed"), rules) == tsh.P("model")
    assert tsh.logical_to_pspec(("batch", None, "vocab"), rules) \
        == tsh.P(("pod", "data"), None, "model")


def test_evenly_shardable_drops_indivisible():
    # 1-device mesh: everything trivially divisible
    assert tsh._evenly_shardable(tsh.P("model"), (10,), ONE) == tsh.P("model")
    # 10 rows over 16 do not divide: replicated, as JAX's
    mesh = tsh.MeshShape((16, 16), ("data", "model"))
    amesh = AbstractMesh((16, 16), ("data", "model"))
    assert tsh._evenly_shardable(tsh.P("model"), (10,), mesh) == tsh.P()
    assert tuple(jsh._evenly_shardable(JP("model"), (10,), amesh)) == ()


def test_zero1_shards_largest_free_dim():
    assert tsh.zero1_spec(tsh.P(None, "model"), (8, 16), ONE,
                          axis="data") == tsh.P("data", "model")


def test_batch_shardings_replicate_small_batch():
    tree = {"tokens": torch.empty((1, 8), dtype=torch.int32, device="meta")}
    sh = tsh.batch_shardings(tree, ONE)
    # batch=1 on size-1 axes: sharded-over-1 == replicated, both legal
    from torch.distributed.tensor import Replicate, Shard
    assert all(p in (Replicate(), Shard(0)) for p in sh["tokens"])
    mesh = tsh.MeshShape((16, 16), ("data", "model"))
    assert tsh.batch_pspec((1, 8), mesh) == tsh.P()
    assert np.all([p == Replicate() for p in tsh.batch_shardings(
        tree, mesh)["tokens"]])
