"""Per-device cost of a traced entry point: flops, HBM bytes, collective
wire bytes and the peak of live memory.

The counterpart of the JAX package's ``launch/hlocost.py``.  There is no
HLO to parse: ``OpCounter``, a ``TorchDispatchMode``, runs the entry
point on meta tensors (DTensors over meta shards under a mesh) and
counts every aten op that runs on a rank's local tensors, with the
fields of ``hlocost.CostSummary``:

* ``flops``: matmul-class ops from ``torch.utils.flop_counter``'s
  formulas on the local operand shapes; every other arithmetic op one
  flop per result element, as ``hlocost`` counts elementwise ops; data
  movement (views, copies, casts, gathers, concatenation) none.  A
  kernel call (``kernels/abstract.py``) adds the flops and bytes of
  ``kernels/cost.py``'s formulas, the ones ``chip_smoke.py`` bounds the
  kernels with.
* ``bytes_accessed``: an eager backend launches each aten op as its own
  kernel, so each op moves its operands' and its result's bytes at
  their own dtype widths (a gather or an indexed write its slice twice,
  as ``hlocost`` charges them; views and allocations nothing).
  ``bytes_native`` equals it: ``hlocost`` charges float32 at 2 B to undo
  XLA:CPU's bf16 -> f32 promotion, which a torch trace does not make.
* ``wire_bytes``: the ``_c10d_functional`` collectives that DTensor
  issues, with ``hlocost._collective_wire``'s ring factors over the
  group's size (all-gather (g-1)/g of the result, all-reduce 2(g-1)/g,
  reduce-scatter (g-1) times the result, all-to-all the result), and
  ``collective_s``, each collective's wire over its group's link rate
  (``launch/mesh.group_link_bw``).
* ``trip_counts``: empty; the port's layer loops are Python loops, so
  every layer's ops are traced and counted.

The dispatch mode sees a DTensor op before DTensor splits it; it
passes such ops on (``NotImplemented``) and counts the local ops and
collectives DTensor then runs.  Ops on fake tensors are DTensor's
sharding propagation (global shapes, no work) and are skipped.

``peak_live_bytes`` follows every local storage an op creates, from its
creation to its release (a weak reference on the storage), beside the
storages registered as arguments; its peak over the trace is the
device memory the entry point needs beyond its arguments.
"""
from __future__ import annotations

import weakref
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.kernels import cost
from repro_torch.launch.mesh import PEAK_FLOPS_BF16, group_link_bw


COLLECTIVES = ("all_reduce", "all_gather_into_tensor", "reduce_scatter_tensor",
               "all_to_all_single", "broadcast")
# ops that move data without arithmetic: no flops (hlocost's _MOVE_OPS)
_MOVE = {"_to_copy", "copy", "copy_", "clone", "cat", "stack", "index",
         "index_select", "gather", "embedding", "index_put", "index_put_",
         "index_copy", "index_copy_", "scatter", "scatter_", "where",
         "masked_fill", "masked_fill_", "constant_pad_nd", "slice_scatter",
         "select_scatter", "repeat", "repeat_interleave", "expand_copy",
         "fill", "fill_", "zero_", "flip", "roll", "contiguous",
         "_unsafe_index", "embedding_dense_backward"}
# ops that allocate without reading anything: no flops, no bytes read
_ALLOC = {"empty", "empty_like", "empty_strided", "new_empty",
          "new_empty_strided", "zeros", "zeros_like", "new_zeros", "ones",
          "ones_like", "new_ones", "full", "full_like", "new_full",
          "arange", "scalar_tensor", "lift_fresh", "lift_fresh_copy",
          "_local_scalar_dense"}
# slice-sized traffic: 2x the moved slice (hlocost's SLICE_OPS)
_SLICE_RESULT = {"index", "index_select", "gather", "embedding",
                 "_unsafe_index"}
_SLICE_UPDATE = {"index_put", "index_put_", "index_copy", "index_copy_",
                 "scatter", "scatter_", "slice_scatter", "select_scatter"}


@dataclass
class CostSummary:
    flops: float = 0.0
    matmul_flops: float = 0.0       # the flop_counter ops' share
    bytes_accessed: float = 0.0
    wire_bytes: float = 0.0
    bytes_native: float = 0.0       # = bytes_accessed (see the docstring)
    collectives: Dict[str, Dict[str, float]] = field(default_factory=dict)
    trip_counts: Dict[str, int] = field(default_factory=dict)
    compute_s: float = 0.0          # flops over the peak of their type
    collective_s: float = 0.0       # wire over each group's link rate
    kernels: Dict[str, Dict[str, float]] = field(default_factory=dict)
    peak_live_bytes: float = 0.0    # beyond the registered arguments
    detail: Optional[List] = None


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _group(name: str):
    from torch.distributed.distributed_c10d import (
        _resolve_process_group, get_process_group_ranks)
    pg = _resolve_process_group(name)
    return pg.size(), get_process_group_ranks(pg)


def collective_wire(kind: str, rbytes: float, g: int) -> float:
    """Ring-algorithm wire bytes one rank moves (``hlocost``'s
    factors): ``rbytes`` is the collective's result size."""
    g = max(2, g)
    if kind == "all_gather_into_tensor":
        return rbytes * (g - 1) / g
    if kind == "all_reduce":
        return 2.0 * rbytes * (g - 1) / g
    if kind == "reduce_scatter_tensor":
        return rbytes * (g - 1)
    return rbytes


class OpCounter(TorchDispatchMode):
    """Counts every local op and collective run under it (see the module
    docstring); ``summary`` holds the totals.  ``register_arguments``
    marks tensors (DTensors: their shards) as the entry point's
    arguments before the trace: their storages are not counted as
    live."""

    def __init__(self, debug: bool = False):
        super().__init__()
        self.summary = CostSummary(detail=[] if debug else None)
        self._args = set()
        self._live = {}
        self._live_bytes = 0
        self._sink = None

    # -- memory -----------------------------------------------------------
    def register_arguments(self, tree) -> int:
        """Marks every tensor leaf's storage as an argument; returns their
        local bytes (each storage once)."""
        total = 0
        for t in _local_leaves(tree):
            key = id(t.untyped_storage())
            if key not in self._args:
                self._args.add(key)
                total += t.untyped_storage().nbytes()
        return total

    def _track(self, outs) -> None:
        for t in outs:
            if not isinstance(t, torch.Tensor):
                continue
            st = t.untyped_storage()
            key = id(st)
            if key in self._args or key in self._live:
                continue
            n = st.nbytes()
            self._live[key] = (n, weakref.ref(st, self._freer(key, n)))
            self._live_bytes += n
            if self._live_bytes > self.summary.peak_live_bytes:
                self.summary.peak_live_bytes = self._live_bytes

    def _freer(self, key, n):
        def free(_ref):
            if self._live.pop(key, None) is not None:
                self._live_bytes -= n
        return free

    # -- counting ---------------------------------------------------------
    def _kernel(self, name, nbytes, flops, peak) -> None:
        s = self.summary
        s.flops += flops
        s.bytes_accessed += nbytes
        s.bytes_native += nbytes
        s.compute_s += flops / peak
        k = s.kernels.setdefault(name, {"calls": 0, "flops": 0.0,
                                        "bytes": 0.0})
        k["calls"] += 1
        k["flops"] += flops
        k["bytes"] += nbytes

    def __enter__(self):
        self._sink = cost.recording(self._kernel)
        self._sink.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        out = super().__exit__(*exc)
        self._sink.__exit__(*exc)
        return out

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        flat, _ = tree_flatten((args, kwargs))
        if any(isinstance(a, DTensor) for a in flat):
            return NotImplemented
        out = func(*args, **kwargs)
        outs, _ = tree_flatten(out)
        if any(isinstance(a, FakeTensor) for a in flat + outs):
            return out
        ins = [a for a in flat if isinstance(a, torch.Tensor)]
        res = [o for o in outs if isinstance(o, torch.Tensor)]
        self._count(func, args, kwargs, ins, res, out)
        self._track(res)
        return out

    def _count(self, func, args, kwargs, ins, res, out) -> None:
        s = self.summary
        ns = func.namespace
        name = func._schema.name.split("::")[-1]
        if ns == "_c10d_functional":
            if name in COLLECTIVES:
                g, ranks = _group(args[-1])
                rbytes = float(sum(_nbytes(t) for t in res))
                wire = collective_wire(name, rbytes, g)
                slot = s.collectives.setdefault(
                    name, {"count": 0, "bytes": 0.0, "wire": 0.0})
                slot["count"] += 1
                slot["bytes"] += rbytes
                slot["wire"] += wire
                s.wire_bytes += wire
                s.collective_s += wire / group_link_bw(ranks)
            return
        if name in _ALLOC or func.is_view or not res and not ins:
            if name in _ALLOC and name not in ("empty", "empty_like",
                                               "empty_strided", "new_empty",
                                               "new_empty_strided",
                                               "lift_fresh",
                                               "_local_scalar_dense"):
                s.bytes_accessed += sum(_nbytes(t) for t in res)
            return
        if name in ("detach", "alias", "_unsafe_view", "view",
                    "_reshape_alias", "t", "set_"):
            return
        if name in _SLICE_RESULT:
            nbytes = 2.0 * sum(_nbytes(t) for t in res)
        elif name in _SLICE_UPDATE:
            upd = ins[-1] if name.startswith(("index_put", "scatter",
                                              "index_copy")) else ins[1]
            nbytes = 2.0 * _nbytes(upd)
        else:
            nbytes = float(sum(_nbytes(t) for t in ins)
                           + sum(_nbytes(t) for t in res))
        s.bytes_accessed += nbytes
        s.bytes_native += nbytes
        packet = func._overloadpacket
        from torch.utils.flop_counter import flop_registry
        if packet in flop_registry:
            flops = float(flop_registry[packet](*args, **kwargs,
                                                out_val=out))
            s.matmul_flops += flops
        elif name in _MOVE:
            flops = 0.0
        else:
            flops = float(sum(t.numel() for t in res))
        s.flops += flops
        s.compute_s += flops / PEAK_FLOPS_BF16
        if s.detail is not None and nbytes > 1e8:
            s.detail.append((nbytes, str(func)))


def _local_leaves(tree):
    """Every tensor leaf of a nested structure, DTensors as their local
    shards."""
    from torch.distributed.tensor import DTensor
    leaves, _ = tree_flatten(tree)
    out = []
    for x in leaves:
        if isinstance(x, DTensor):
            out.append(x._local_tensor)
        elif isinstance(x, torch.Tensor):
            out.append(x)
    return out


def local_bytes(tree) -> int:
    """Local bytes of a tree's tensors, each storage once."""
    seen, total = set(), 0
    for t in _local_leaves(tree):
        key = id(t.untyped_storage())
        if key not in seen:
            seen.add(key)
            total += t.untyped_storage().nbytes()
    return total


def aliased_bytes(outputs, arguments) -> int:
    """Local bytes of the outputs whose storage is an argument's (the
    decode state, written in place)."""
    args = {id(t.untyped_storage()) for t in _local_leaves(arguments)}
    seen, total = set(), 0
    for t in _local_leaves(outputs):
        key = id(t.untyped_storage())
        if key in args and key not in seen:
            seen.add(key)
            total += t.untyped_storage().nbytes()
    return total
