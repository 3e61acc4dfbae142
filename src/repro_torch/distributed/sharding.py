"""Logical-axis sharding rules: DP / TP / SP / EP mapping onto the mesh,
as DTensor placements.

The port of the JAX package's ``distributed/sharding.py``.  The rule
tables are the JAX ones, copied as they are: each logical axis of a
parameter, activation or state (``PSpec.axes``) names the mesh axis or
axes it is split over.

    batch     -> ("pod", "data")      DP
    vocab     -> "model"              TP embedding / logits
    heads     -> "model"              TP attention (q heads)
    kv_heads  -> "model"              TP KV projections
    mlp       -> "model"              TP FFN
    inner     -> "model"              TP Mamba2 d_inner / SSM heads
    experts   -> None (weights)       per-expert hidden dim TP-sharded
    kv_seq    -> "model"              decode KV caches: sequence-sharded
    layers    -> None                 the layer axis, never sharded
    embed     -> None                 activations replicated over model

``long_500k`` (batch 1) overrides kv_seq -> ("data", "model") so one
sequence's state spreads over all GPUs.  ZeRO-1 (optimizer state
sharded over the data axis) goes on top of the param rules
(``zero1_spec``).

A rule gives a partition spec ``P``: one entry per tensor dimension
(a mesh axis, a tuple of them, or None), trailing Nones trimmed, as
``jax.sharding.PartitionSpec`` prints it.  ``to_placements`` turns it
into DTensor placements, one per mesh dimension: ``Shard(dim)`` where
the dimension's axis splits ``dim`` (a dimension spread over several
axes, batch over ("pod", "data"), is ``Shard(dim)`` on each, in order)
and ``Replicate()`` elsewhere.

The rule functions need only the mesh's axis names and sizes: they take
a ``DeviceMesh`` or a ``MeshShape``, which has no ranks behind it (the
counterpart of ``jax.sharding.AbstractMesh``), so the rules can be
checked at production sizes with no process group.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.models.common import tree_map

Rules = Dict[str, Any]

BASE_RULES: Rules = {
    "batch": ("pod", "data"),
    "vocab": "model",
    "heads": "model",
    "kv_heads": "model",
    "mlp": "model",
    "inner": "model",
    "experts": None,
    "kv_seq": "model",
    "moe_groups": ("pod", "data"),
    "seq": None,
    "layers": None,
    "embed": None,
    "embed_out": None,
    "latent": None,
    "int": None,
}

BASE_RULES["seq_res"] = None      # residual-stream seq dim (SP when set)

LONG_CONTEXT_RULES: Rules = dict(BASE_RULES, kv_seq=("data", "model"))

# Expert parallelism: experts sharded over the model axis (per-expert
# hidden dim whole per shard).  MoE cross-shard reductions then move
# token-space [G,t,d] tensors instead of slot-space [E,G*C,d] ones.
EP_RULES: Rules = dict(BASE_RULES, experts="model", mlp=None)

# Sequence parallelism: the residual stream between blocks is sharded on
# seq over the model axis, so remat-saved layer inputs shrink by the TP
# degree.
SP_RULES: Rules = dict(BASE_RULES, seq_res="model")

DATA_AXES = ("pod", "data")


class P(tuple):
    """A partition spec: per tensor dimension a mesh axis name, a tuple
    of names, or None; a one-name tuple is the name and an empty one
    None, and trailing Nones are trimmed, as ``PartitionSpec`` has
    them."""

    def __new__(cls, *parts):
        parts = [p[0] if isinstance(p, tuple) and len(p) == 1
                 else None if p == () else p for p in parts]
        while parts and parts[-1] is None:
            parts.pop()
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


@dataclass(frozen=True)
class MeshShape:
    """Axis sizes and names without ranks, the counterpart of
    ``jax.sharding.AbstractMesh``."""
    shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]

    def size(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n


def axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` or a ``MeshShape``."""
    if isinstance(mesh, MeshShape):
        return dict(zip(mesh.axis_names, mesh.shape))
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _filter_axes(rules: Rules, mesh) -> Rules:
    """Drop mesh axes that don't exist (e.g. 'pod' on the single-pod
    mesh, or everything on a 1-device test mesh)."""
    names = set(axis_sizes(mesh))
    out: Rules = {}
    for k, v in rules.items():
        if v is None:
            out[k] = None
        elif isinstance(v, tuple):
            kept = tuple(a for a in v if a in names)
            out[k] = kept if kept else None
        else:
            out[k] = v if v in names else None
    return out


def logical_to_pspec(axes: Tuple[Optional[str], ...], rules: Rules) -> P:
    return P(*(rules.get(a) if a is not None else None for a in axes))


def _evenly_shardable(pspec: P, shape: Tuple[int, ...], mesh) -> P:
    """Arguments need exact divisibility: replicate any dim that doesn't
    divide evenly."""
    sizes = axis_sizes(mesh)
    parts = list(pspec) + [None] * (len(shape) - len(pspec))
    out = []
    for p, s in zip(parts, shape):
        if p is None:
            out.append(None)
            continue
        n = 1
        for a in (p if isinstance(p, tuple) else (p,)):
            n *= sizes[a]
        out.append(p if (s % n == 0 and s >= n) else None)
    return P(*out)


def tree_pspecs(spec_tree: Any, rules: Rules) -> Any:
    return tree_map(lambda p: logical_to_pspec(p.axes, rules), spec_tree)


def to_placements(pspec: P, mesh) -> list:
    """One placement per mesh dimension: ``Shard(dim)`` where a tensor
    dimension's entry names that mesh axis, else ``Replicate()`` (also
    on an axis of size 1, where the two are one layout)."""
    from torch.distributed.tensor import Replicate, Shard
    sizes = axis_sizes(mesh)
    names = list(sizes)
    out = [Replicate() for _ in names]
    for dim, p in enumerate(pspec):
        for a in (() if p is None else p if isinstance(p, tuple) else (p,)):
            if sizes[a] > 1:
                out[names.index(a)] = Shard(dim)
    return out


def tree_shardings(spec_tree: Any, mesh, rules: Optional[Rules] = None):
    """Placement lists of a PSpec tree: the rule, then ``_evenly_
    shardable`` (arguments must divide)."""
    rules = _filter_axes(rules or BASE_RULES, mesh)
    return tree_map(lambda p: to_placements(_evenly_shardable(
        logical_to_pspec(p.axes, rules), p.shape, mesh), mesh), spec_tree)


def batch_pspec(shape: Tuple[int, ...], mesh,
                rules: Optional[Rules] = None) -> P:
    """The leading (batch) dim over the data axes, replicated when the
    batch doesn't divide them."""
    b_axes = _filter_axes(rules or BASE_RULES, mesh).get("batch")
    return _evenly_shardable(P(*((b_axes,) + (None,) * (len(shape) - 1))),
                             shape, mesh)


def batch_shardings(struct_tree: Any, mesh,
                    rules: Optional[Rules] = None) -> Any:
    """Placement lists sharding the leading dim of each tensor leaf (any
    object with ``.shape``)."""
    return tree_map(lambda s: to_placements(
        batch_pspec(tuple(s.shape), mesh, rules), mesh), struct_tree)


# ---------------------------------------------------------------------------
# ZeRO-1: optimizer state sharded over the data axis on top of TP
# ---------------------------------------------------------------------------
def zero1_spec(pspec: P, shape: Tuple[int, ...], mesh,
               axis: str = "data") -> P:
    """Additionally shard the largest currently-unsharded dim of an
    optimizer-state tensor over the data axis (divisibility required)."""
    sizes = axis_sizes(mesh)
    if axis not in sizes:
        return pspec
    n = sizes[axis]
    parts = list(pspec) + [None] * (len(shape) - len(pspec))
    best, best_size = None, 0
    for i, (p, s) in enumerate(zip(parts, shape)):
        if p is None and s % n == 0 and s >= n and s > best_size:
            best, best_size = i, s
    if best is None:
        return pspec
    parts[best] = axis
    return P(*parts)


def zero1_pspecs(spec_tree: Any, mesh, rules: Optional[Rules] = None):
    rules = _filter_axes(rules or BASE_RULES, mesh)
    return tree_map(lambda p: zero1_spec(_evenly_shardable(
        logical_to_pspec(p.axes, rules), p.shape, mesh), p.shape, mesh),
        spec_tree)


def zero1_shardings(spec_tree: Any, mesh, rules: Optional[Rules] = None):
    return tree_map(lambda ps: to_placements(ps, mesh),
                    zero1_pspecs(spec_tree, mesh, rules))


# ---------------------------------------------------------------------------
# placing tensors
# ---------------------------------------------------------------------------
def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def place(x: torch.Tensor, mesh, placements) -> torch.Tensor:
    """The DTensor whose global value is ``x`` (each rank keeps its
    shard)."""
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(x, mesh, placements)


def place_abstract(shape, dtype, mesh, placements) -> torch.Tensor:
    """A meta DTensor of global ``shape``: each rank's empty local shard
    under ``placements`` (uneven shards as ``torch.chunk`` cuts them)."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    local, _ = compute_local_shape_and_global_offset(tuple(shape), mesh,
                                                     placements)
    return DTensor.from_local(
        torch.empty(local, dtype=dtype, device="meta"), mesh, placements,
        run_check=False, shape=torch.Size(shape),
        stride=torch.empty(shape, device="meta").stride())


def per_shard(fn, args, dims, out_dims):
    """``fn`` on each rank's shards of its DTensor ``args`` (``local_map``),
    for a computation independent across batch rows and heads: ``dims``
    gives each argument's (batch dim, head dim), either None, and
    ``out_dims`` each output's.  The batch stays split over the data
    axes that split the first argument's; heads go over ``model`` where
    the first argument's divide it; every other dim is whole.  A
    non-tensor argument takes dims None.  An argument whole along an
    axis that splits the computation (a weight beside batch-split rows,
    a row input shared by split heads) gets a partial-sum gradient
    there: each rank's shard adds its own share."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    ref = args[0]
    mesh = ref.device_mesh
    names = list(mesh.mesh_dim_names)
    b0, h0 = dims[0]
    batch_axes = {i for i, p in enumerate(ref.placements)
                  if names[i] in DATA_AXES and isinstance(p, Shard)
                  and p.dim == b0}
    model = names.index("model") if "model" in names else None
    heads = (model is not None and h0 is not None and mesh.size(model) > 1
             and ref.shape[h0] % mesh.size(model) == 0)

    def pl(d):
        if d is None:
            return None
        bd, hd = d
        return [Shard(bd) if i in batch_axes and bd is not None else
                Shard(hd) if i == model and heads and hd is not None else
                Replicate() for i in range(mesh.ndim)]

    split = batch_axes | ({model} if heads else set())

    def grad_pl(d):
        return None if d is None else [
            Partial() if i in split and isinstance(p, Replicate) else p
            for i, p in enumerate(pl(d))]

    outs = tuple(pl(d) for d in out_dims)
    return local_map(fn, out_placements=outs if len(outs) > 1 else outs[0],
                     in_placements=tuple(pl(d) for d in dims),
                     in_grad_placements=tuple(grad_pl(d) for d in dims),
                     device_mesh=mesh, redistribute_inputs=True)(*args)


# ---------------------------------------------------------------------------
# activation sharding hook (passed into models as `shd`)
# ---------------------------------------------------------------------------
class _Constrain(torch.autograd.Function):
    """A sharding constraint on a DTensor and on its gradient, as
    ``jax.lax.with_sharding_constraint`` constrains the primal and the
    cotangent: the forward redistributes x to ``placements``, the
    backward its gradient (so a partial-sum gradient is all-reduced
    where the activation was, not gathered later)."""

    @staticmethod
    def forward(ctx, x, mesh, placements):
        ctx.mesh, ctx.placements = mesh, placements
        if tuple(x.placements) == placements:
            return x.view_as(x)
        return x.redistribute(mesh, placements)

    @staticmethod
    def backward(ctx, g):
        if tuple(g.placements) != ctx.placements:
            g = g.redistribute(ctx.mesh, ctx.placements)
        return g, None, None


class _GradLayout(torch.autograd.Function):
    """Identity forward; the backward redistributes the gradient."""

    @staticmethod
    def forward(ctx, x, mesh, placements):
        ctx.mesh, ctx.placements = mesh, placements
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if tuple(g.placements) != ctx.placements:
            g = g.redistribute(ctx.mesh, ctx.placements)
        return g, None, None


class MeshSharding:
    """Callable applied to activations inside model code:
    ``shd(x, "batch", "seq", "heads", None)`` redistributes a DTensor
    to the rule's placements, and its gradient with it; a plain tensor,
    or any tensor on a one-device mesh, passes unchanged.

    A dimension the rule's axes do not divide stays whole, as an
    argument's does (``_evenly_shardable``): GSPMD pads such a split
    (40 heads over 16 shards as 48), DTensor cannot shard past an
    uneven split's views, so the port keeps it whole, and the dry run
    prices that (``--pad-heads`` pads the heads instead)."""

    def __init__(self, mesh, rules: Optional[Rules] = None):
        self.mesh = mesh
        self.rules = _filter_axes(rules or BASE_RULES, mesh)
        self.active = mesh.size() > 1

    def __call__(self, x, *axes):
        if not self.active or not is_dtensor(x):
            return x
        want = to_placements(_evenly_shardable(
            self.pspec(tuple(axes[:x.ndim])), tuple(x.shape), self.mesh),
            self.mesh)
        return _Constrain.apply(x, self.mesh, tuple(want))

    def grad_layout(self, x, *axes):
        """x unchanged, its gradient redistributed to the rule's
        placements: a row-parallel product's output, whose gradient
        arrives split as the residual stream is (over the sequence under
        SP_RULES) and must enter the product's backward whole."""
        if not self.active or not is_dtensor(x):
            return x
        want = to_placements(_evenly_shardable(
            self.pspec(tuple(axes[:x.ndim])), tuple(x.shape), self.mesh),
            self.mesh)
        return _GradLayout.apply(x, self.mesh, tuple(want))

    def dp_size(self) -> int:
        sizes = axis_sizes(self.mesh)
        n = 1
        for a in DATA_AXES:
            n *= sizes.get(a, 1)
        return n

    def pspec(self, axes: Tuple[Optional[str], ...]) -> P:
        return logical_to_pspec(axes, self.rules)

    def named(self, *axes) -> list:
        """The placements of a tensor with logical ``axes``."""
        return to_placements(self.pspec(tuple(axes)), self.mesh)

    def _vocab_split(self, x, dim: int):
        """The mesh dim splitting ``x``'s dim ``dim`` over the vocab axis
        evenly, or None."""
        from torch.distributed.tensor import Shard
        v_axis = self.rules.get("vocab")
        if not self.active or not is_dtensor(x) or v_axis is None:
            return None
        vdim = list(self.mesh.mesh_dim_names).index(v_axis)
        pl = x.placements[vdim]
        if (not isinstance(pl, Shard) or pl.dim != dim % x.dim()
                or x.shape[dim] % self.mesh.shape[vdim]):
            return None
        return vdim

    def vocab_gather(self, x, labels):
        """x [..., V] at ``labels`` [...] -> [...], each rank on its own
        rows (``local_map``: a gather's gradient is then a rank's rows,
        never the whole batch's logits).  Against vocab-sharded x each
        shard gathers the labels it holds (others masked to zero) and an
        all-reduce over the vocab axis sums them."""
        from torch.distributed.tensor import Partial, Replicate, Shard
        from torch.distributed.tensor.experimental import local_map
        if not self.active or not is_dtensor(x):
            return x.gather(-1, labels.long()[..., None])[..., 0]
        vdim = self._vocab_split(x, -1)
        last = x.dim() - 1
        lab_pl = [Replicate() if isinstance(p, Shard) and p.dim == last
                  else Replicate() if isinstance(p, Partial) else p
                  for p in x.placements]
        x_pl = list(lab_pl)
        out_pl = list(lab_pl)
        if vdim is not None:
            x_pl[vdim], out_pl[vdim] = Shard(last), Partial()
        vshard = x.shape[-1] // (1 if vdim is None
                                 else self.mesh.shape[vdim])
        lo = 0 if vdim is None else self.mesh.get_local_rank(vdim) * vshard

        def gather(xl, lab):
            lab = lab.long() - lo
            mine = (lab >= 0) & (lab < vshard)
            g = xl.gather(-1, lab.clamp(0, vshard - 1)[..., None])[..., 0]
            return torch.where(mine, g, torch.zeros_like(g))

        out = local_map(gather, out_placements=out_pl,
                        in_placements=(x_pl, lab_pl), device_mesh=self.mesh,
                        redistribute_inputs=True)(x, labels)
        return out if vdim is None else out.redistribute(self.mesh, lab_pl)

    # -- embedding lookup against a vocab-sharded table -----------------
    def embed_lookup(self, emb, tokens):
        """Embedding gather against a vocab-sharded table: each vocab
        shard gathers its own rows (others masked to zero), then an
        all-reduce over the vocab axis sums them — O(B*D) wire instead of
        gathering the table.  A table that is not split (or does not
        divide) is an ordinary lookup."""
        import torch.nn.functional as F
        from torch.distributed.tensor import Partial, Replicate, Shard
        from torch.distributed.tensor.experimental import local_map
        vdim = self._vocab_split(emb, 0)
        if vdim is None:
            return F.embedding(tokens.long(), emb)
        emb_pl = [Replicate()] * self.mesh.ndim
        emb_pl[vdim] = emb.placements[vdim]
        tok_pl = to_placements(batch_pspec(tuple(tokens.shape), self.mesh,
                                           self.rules), self.mesh)
        out_pl = [Partial() if i == vdim else p for i, p in enumerate(tok_pl)]
        # each data shard looks up its own rows: the table's gradient is
        # their partial sum
        grad_pl = [Partial() if isinstance(p, Shard) else emb_pl[i]
                   for i, p in enumerate(tok_pl)]
        vshard = emb.shape[0] // self.mesh.shape[vdim]
        lo = self.mesh.get_local_rank(vdim) * vshard

        def lookup(e, tok):
            tok = tok.long() - lo
            mask = ((tok >= 0) & (tok < vshard))[..., None]
            x = F.embedding(tok.clamp(0, vshard - 1), e)
            return torch.where(mask, x, torch.zeros_like(x))

        out = local_map(lookup, out_placements=out_pl,
                        in_placements=(emb_pl, tok_pl),
                        in_grad_placements=(grad_pl, tok_pl),
                        device_mesh=self.mesh,
                        redistribute_inputs=True)(emb, tokens)
        return out.redistribute(self.mesh, tok_pl)
