"""The train step: microbatched gradient accumulation, mixed precision,
optional int8 gradient compression.

The port of the JAX package's ``training/train.py`` on one device:
``make_train_step(model, ...)`` returns ``train_step(params, opt_state,
batch) -> (params, opt_state, metrics)`` with the same three ways to
accumulate microbatch gradients.  Gradients come from autograd over
``model.train_loss`` (its layers under ``remat``, causal attention
through ``FlashCausal``); bf16 param grads are cast to float32 before
the update, as JAX casts them.

Over a device mesh the params, optimizer state and batch are DTensors
placed by ``train_shardings`` (the rules of ``distributed/sharding.py``,
the optimizer state ZeRO-1 sharded over the data axis): the step is the
same code, each rank holding its shards.  A microbatch is the same
slice of every rank's batch shard, as a data-parallel trainer cuts it.
``abstract_opt_state`` gives the state's meta stand-ins for the dry run.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.config import ModelConfig, ShapeConfig
from repro_torch.distributed import sharding as shlib
from repro_torch.models.common import tree_leaves, tree_map
from repro_torch.models.model import Model, remat
from repro_torch.training import optimizer as opt_mod
from repro_torch.training.optimizer import AdamWConfig, AdamWState


def pick_n_microbatches(cfg: ModelConfig, shape: ShapeConfig,
                        n_data_shards: int, *, sp_degree: int = 1) -> int:
    """Bound the remat-saved activation footprint: with every layer
    under ``remat``, each layer saves its input [micro_bs, S, D] bf16, so
    the per-device saved-activation total is micro_bs * S * D * 2B * L.
    Target <= ~1.5 GB, leaving memory for params, grads and score
    buffers."""
    per_shard = max(1, shape.global_batch // max(1, n_data_shards))
    budget = int(1.5e9)
    per_seq_bytes = shape.seq_len * cfg.d_model * 2 * max(1, cfg.n_layers) \
        // max(1, sp_degree)      # SP: saved residuals are seq-sharded
    max_micro_bs = max(1, budget // max(1, per_seq_bytes))
    n_micro = 1
    while per_shard // n_micro > max_micro_bs and n_micro < per_shard:
        n_micro *= 2
    while per_shard % n_micro != 0:
        n_micro //= 2
    return max(1, n_micro)


# ---------------------------------------------------------------------------
# int8 gradient compression (off by default)
# ---------------------------------------------------------------------------
def compress_int8(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """g -> (int8 values, float32 scale): ``round`` is half to even, as
    ``jnp.round``."""
    scale = torch.clamp(torch.max(torch.abs(g)) / 127.0, min=1e-12)
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def decompress_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------
def _micro(v: torch.Tensor, n_micro: int, i: int) -> torch.Tensor:
    """Microbatch ``i`` of ``n_micro`` of one batch leaf: the i-th equal
    cut of its leading dim; of a DTensor, the i-th cut of every rank's
    shard."""
    if not shlib.is_dtensor(v):
        return v.reshape((n_micro, v.shape[0] // n_micro) + v.shape[1:])[i]
    from torch.distributed.tensor import DTensor
    loc = v.to_local()
    n = loc.shape[0] // n_micro
    return DTensor.from_local(loc[i * n:(i + 1) * n], v.device_mesh,
                              v.placements, run_check=False)


def _split(batch: Dict, n_micro: int) -> List[Dict]:
    """The batch's leading dim cut into ``n_micro`` equal microbatches."""
    return [{k: _micro(v, n_micro, i) for k, v in batch.items()}
            for i in range(n_micro)]


def _mean_metrics(metricses: List[Dict]) -> Dict:
    return {k: torch.stack([m[k].detach().float() for m in metricses]).mean()
            for k in metricses[0]}


def _with_grad(params: Any) -> Tuple[Any, List[torch.Tensor]]:
    """A copy of the tree whose leaves are detached views that require
    grad, and those leaves in ``tree_leaves`` order."""
    tree = tree_map(lambda p: p.detach().requires_grad_(True), params)
    return tree, tree_leaves(tree)


def _grads(loss: torch.Tensor, leaves: List[torch.Tensor],
           like: Any) -> Any:
    """d loss / d leaves as a tree shaped like ``like``; every leaf must
    get a gradient (a leaf without one means a path autograd cannot see,
    such as a kernel without a backward)."""
    gs = torch.autograd.grad(loss, leaves, allow_unused=True)
    missing = [i for i, g in enumerate(gs) if g is None]
    if missing:
        raise RuntimeError(f"no gradient reached {len(missing)} param "
                           f"leaves (first: leaf {missing[0]})")
    it = iter(gs)
    return tree_map(lambda _: next(it), like)


def compute_grads(model: Model, params: Any, batch: Dict, *,
                  n_micro: int = 1, defer_grad_sync: bool = False,
                  bf16_grad_sync: bool = False,
                  backend=None) -> Tuple[Any, Dict]:
    """The float32 gradient of ``model.train_loss`` over ``batch`` (a
    tree shaped like ``params``) and the loss metrics,
    accumulated over ``n_micro`` microbatches as ``make_train_step``
    describes.  ``backend`` goes to the model's kernels (``"torch"``: the
    plain versions on the card)."""
    def loss_fn(tree, mb):
        return model.train_loss(tree, mb, backend=backend)

    if n_micro > 1 and defer_grad_sync:
        tree, leaves = _with_grad(params)
        total, metricses = 0.0, []
        for mb in _split(batch, n_micro):
            loss, metrics = remat(loss_fn, tree, mb)
            total = total + loss
            metricses.append(metrics)
        grads = tree_map(lambda g: g.float(),
                         _grads(total / n_micro, leaves, params))
        return grads, _mean_metrics(metricses)
    if n_micro > 1:
        acc_dt = torch.bfloat16 if bf16_grad_sync else torch.float32
        acc = tree_map(lambda p: torch.zeros_like(p, dtype=acc_dt), params)
        metricses = []
        for mb in _split(batch, n_micro):
            tree, leaves = _with_grad(params)
            loss, metrics = loss_fn(tree, mb)
            acc = tree_map(lambda a, g: a + g.to(acc_dt), acc,
                           _grads(loss, leaves, params))
            metricses.append(metrics)
        return (tree_map(lambda g: g.float() / n_micro, acc),
                _mean_metrics(metricses))
    tree, leaves = _with_grad(params)
    loss, metrics = loss_fn(tree, batch)
    return (tree_map(lambda g: g.float(), _grads(loss, leaves, params)),
            {k: v.detach() for k, v in metrics.items()})


def make_train_step(model: Model, *, adamw: AdamWConfig = AdamWConfig(),
                    n_micro: int = 1, grad_compress: bool = False,
                    defer_grad_sync: bool = False,
                    bf16_grad_sync: bool = False,
                    backend=None) -> Callable:
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics).  ``batch`` leading dim = per-call global batch.

    n_micro > 1: the batch is cut into ``n_micro`` microbatches whose
    gradients are accumulated (float32, or bf16 with ``bf16_grad_sync``)
    and averaged.  defer_grad_sync: differentiate the mean of the
    microbatches' losses, each under ``remat``, once, instead of each
    microbatch's loss (the JAX package's single-all-reduce form; on one
    device it trades an extra rematerialized forward for one backward).
    grad_compress: each gradient through an int8 round trip before the
    update."""

    def train_step(params, opt_state: AdamWState, batch):
        grads, metrics = compute_grads(
            model, params, batch, n_micro=n_micro,
            defer_grad_sync=defer_grad_sync, bf16_grad_sync=bf16_grad_sync,
            backend=backend)
        if grad_compress:
            grads = tree_map(lambda g: decompress_int8(*compress_int8(g)),
                             grads)
        new_params, new_opt, om = opt_mod.apply_updates(
            adamw, params, grads, opt_state)
        return new_params, new_opt, {**metrics, **om}

    return train_step


# ---------------------------------------------------------------------------
# sharding assembly for the distributed step
# ---------------------------------------------------------------------------
@dataclass
class TrainShardings:
    params: Any
    opt: Any
    batch: Any
    rules: Dict


def train_shardings(model: Model, mesh, batch_spec: Dict[str, Any],
                    *, zero1: bool = True,
                    rules: Optional[Dict] = None) -> TrainShardings:
    """Placement lists of the params (the rules), the optimizer state
    (ZeRO-1 over the data axis on top, unless ``zero1=False``; the step
    replicated) and the batch (leading dim over the data axes)."""
    rules = rules or shlib.BASE_RULES
    p_sh = shlib.tree_shardings(model.specs, mesh, rules)
    state_sh = (shlib.zero1_shardings(model.specs, mesh, rules) if zero1
                else p_sh)
    opt_sh = AdamWState(step=shlib.to_placements(shlib.P(), mesh),
                        master=state_sh, m=state_sh, v=state_sh)
    b_axes = shlib._filter_axes(rules, mesh).get("batch")
    batch_sh = tree_map(lambda s: shlib.to_placements(
        shlib.P(*((b_axes,) + (None,) * (len(s.shape) - 1))), mesh),
        batch_spec)
    return TrainShardings(p_sh, opt_sh, batch_sh, rules)


def abstract_opt_state(model: Model) -> AdamWState:
    """Meta stand-ins of the optimizer state: float32 master, m and v of
    the params' shapes and an int32 step."""
    f32 = lambda p: torch.empty(p.shape, dtype=torch.float32,  # noqa: E731
                                device="meta")
    return AdamWState(step=torch.empty((), dtype=torch.int32, device="meta"),
                      master=tree_map(f32, model.specs),
                      m=tree_map(f32, model.specs),
                      v=tree_map(f32, model.specs))
