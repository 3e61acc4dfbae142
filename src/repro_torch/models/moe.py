"""Mixture-of-Experts FFN with top-k routing (granite-moe archs).

The port of the JAX package's ``models/moe.py``: GShard-style
capacity-bounded dispatch, decision for decision.  Tokens are cut into
``_n_groups`` groups of about ``GROUP`` tokens; each group routes on its
own.  The router product is rounded to the activation dtype, then a
float32 softmax; padded layout experts (``internal_pad_experts``) get
``-1e9``; the top-k probabilities are renormalised.  The k slots take
capacity SEQUENTIALLY: every token's slot-0 choice is placed (in token
order) before any token's slot-1 choice, so a token's output depends on
every other token of its group, padding and inactive batch rows
included.  An assignment whose position in its expert reaches
``capacity`` is dropped.

Where the JAX package builds dense one-hot ``[G,t,E,C]`` dispatch and
combine tensors and contracts them, this computes the same kept
(token, expert, slot) set with integer positions, scatters the kept
tokens into an ``[E, G*C, D]`` expert batch, runs the experts as three
batched products (``torch.bmm``: every expert every call, as the GShard
einsums do) and gathers each token's kept outputs back, weighted by its
renormalised probability rounded to the activation dtype and summed in
float32 (the products of the combine einsum, rounded once).  Top-k ties
break to the lower expert index, as ``jax.lax.top_k`` does: a stable
descending sort, since ``torch.topk`` does not promise an order.
Nothing here reads a device value on the host (no boolean-mask
indexing, no ``one_hot`` bounds check), so a decode step queues its MoE
layers without waiting for the card.

No Pallas kernel computes the MoE FFN in the JAX package (XLA runs its
einsums), so the products stay ``torch.bmm`` here.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.distributed.sharding import is_dtensor
from repro_torch.models.common import NOSHARD, PSpec

GROUP = 256          # tokens per dispatch group


def moe_pspecs(cfg: ModelConfig) -> Dict[str, PSpec]:
    d, e, f = cfg.d_model, cfg.layout_n_experts, cfg.moe_ff
    return {
        "router": PSpec((d, e), ("embed", None)),
        "w_gate": PSpec((e, d, f), ("experts", "embed", "mlp")),
        "w_up": PSpec((e, d, f), ("experts", "embed", "mlp")),
        "w_down": PSpec((e, f, d), ("experts", "mlp", "embed"),
                        scale=0.02 / math.sqrt(2 * max(cfg.n_layers, 1))),
    }


def _n_groups(t: int, dp: int = 1) -> int:
    """Group count: a multiple of the dp degree (so groups shard evenly)
    with ~GROUP tokens per group."""
    if t % dp != 0:
        dp = 1
    per_shard = t // dp
    g = dp * max(1, per_shard // GROUP)
    while t % g != 0:
        g -= 1
    return max(1, g)


def capacity(group: int, cfg: ModelConfig) -> int:
    """Assignments one expert takes from one group."""
    return max(4, int(math.ceil(group * cfg.top_k / cfg.n_experts
                                * cfg.capacity_factor)))


def route(p: Dict, xg: torch.Tensor, cfg: ModelConfig):
    """xg [G,t,D] -> (probs [G,t,E] float32, top_p [G,t,k] renormalised,
    top_i [G,t,k], pos [G,t,k] each assignment's position in its
    expert's capacity, keep [G,t,k] bool)."""
    ng, group, _ = xg.shape
    e, k = cfg.layout_n_experts, cfg.top_k
    cap = capacity(group, cfg)
    logits = torch.matmul(xg, p["router"]).float()
    if e != cfg.n_experts:
        # padded experts (expert-parallel layout): never routable
        logits[..., cfg.n_experts:] += -1e9
    probs = torch.softmax(logits, dim=-1)
    top_p, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_i = top_p[..., :k], top_i[..., :k]
    top_p = top_p / top_p.sum(dim=-1, keepdim=True)
    # the JAX k-loop's positions, all slots at once: slot j of a token
    # lands at (kept assignments of slots < j in its expert, which is
    # min(capacity, their total)) + (earlier tokens choosing the expert
    # in slot j)
    oh = (top_i[..., None] == torch.arange(e, device=xg.device)).long()
    n = oh.sum(dim=1)                                 # [G,k,E]
    before = (torch.cumsum(n, dim=1) - n).clamp_max(cap)
    at = before[:, None] + torch.cumsum(oh, dim=1) - oh   # [G,t,k,E]
    pos = at.gather(-1, top_i[..., None])[..., 0]
    return probs, top_p, top_i, pos, pos < cap


def _dispatch(router: torch.Tensor, xg: torch.Tensor, cfg: ModelConfig):
    """Route the groups xg [G,t,D] and scatter the kept assignments into
    the expert batch.  Returns (xin [E, G*C, D], top_i [G,t,k], the row
    of y.view(E*G*C, D) that holds each assignment's output [G,t,k]
    (dropped ones clamped to a kept slot), its combine weight [G,t,k]
    float32 (zero when dropped), probs [G,t,E])."""
    ng, group, d = xg.shape
    e, k = cfg.layout_n_experts, cfg.top_k
    cap = capacity(group, cfg)
    probs, top_p, top_i, pos, keep = route({"router": router}, xg, cfg)
    # kept assignment (g, t, j) -> row e*G*C + g*C + pos of the expert
    # batch; dropped ones write a spare last row
    g_idx = torch.arange(ng, device=xg.device)[:, None, None]
    rows = (top_i * ng + g_idx) * cap + pos.clamp_max(cap - 1)
    n = e * ng * cap
    xin = xg.new_zeros((n + 1, d))
    xin.index_copy_(0, torch.where(keep, rows, n).reshape(-1),
                    xg[:, :, None, :].expand(ng, group, k, d).reshape(-1, d))
    w = (top_p * keep).to(xg.dtype).float()            # [G,t,k]
    return xin[:n].view(e, ng * cap, d), top_i, rows, w, probs


def _sharded_moe(p, xg, cfg, shd, dtype):
    """The FFN over DTensor groups: routing, dispatch and combine run per
    data shard of the groups (``local_map``: a group never crosses
    shards), the expert products on the DTensors, so their split over
    ``model`` (the hidden dim, or the experts under EP) is the rule's.
    The combine is linear in y, so a y that is a partial sum over
    ``model`` (hidden dim split) or split by expert (EP) gives a partial
    sum of tokens, summed by one all-reduce in token space."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = xg.device_mesh
    g_pl = [Shard(0) if isinstance(pl, Shard) and pl.dim == 0
            else Replicate() for pl in xg.placements]
    slot_pl = [Shard(1) if isinstance(pl, Shard) else pl for pl in g_pl]
    rep = [Replicate()] * mesh.ndim
    # each data shard routes its own groups: the router's gradient is
    # their partial sum
    router_grad = [Partial() if isinstance(pl, Shard) else Replicate()
                   for pl in g_pl]
    xin, top_i, rows, w, probs = local_map(
        lambda r, x: _dispatch(r, x, cfg),
        out_placements=(slot_pl, g_pl, g_pl, g_pl, g_pl),
        in_placements=(rep, g_pl), in_grad_placements=(router_grad, g_pl),
        device_mesh=mesh, redistribute_inputs=True)(p["router"], xg)
    xin = shd(xin, "experts", "moe_groups", None)
    h = F.silu(torch.bmm(xin, p["w_gate"]).float()).to(dtype)
    h = shd(h * torch.bmm(xin, p["w_up"]), "experts", "moe_groups", "mlp")
    y = torch.bmm(h, p["w_down"])
    y_pl, out_pl = [], []
    for i, pl in enumerate(y.placements):
        if isinstance(g_pl[i], Shard):             # a data axis: groups
            y_pl.append(slot_pl[i])
            out_pl.append(g_pl[i])
        elif isinstance(pl, Partial) or (isinstance(pl, Shard)
                                         and pl.dim == 0):
            y_pl.append(pl)                        # hidden dim or experts
            out_pl.append(Partial())
        else:
            y_pl.append(Replicate())
            out_pl.append(Replicate())
    e_loc = y.shape[0] // math.prod(
        mesh.shape[i] for i, pl in enumerate(y_pl)
        if isinstance(pl, Shard) and pl.dim == 0)

    def combine(y, rows, w):
        # y holds experts e_lo .. e_lo + E' - 1: rows of other experts'
        # assignments fall outside it and add nothing
        e_lo = 0
        for i, pl in enumerate(y_pl):
            if isinstance(pl, Shard) and pl.dim == 0:
                e_lo = mesh.get_local_rank(i) * e_loc
        n, d = y.shape[0] * y.shape[1], y.shape[2]
        local = rows - e_lo * y.shape[1]
        mine = (local >= 0) & (local < n)
        yr = y.reshape(n, d)[local.clamp(0, n - 1)].float()
        return ((w * mine)[..., None] * yr).sum(dim=2).to(dtype)

    # where y is a partial sum (or split by expert), every rank's share
    # gets the whole upstream gradient, and the weights' gradient is a
    # partial sum of the shares'
    y_grad = [Replicate() if isinstance(pl, Partial) else pl for pl in y_pl]
    w_grad = [Partial() if isinstance(o, Partial) else g
              for o, g in zip(out_pl, g_pl)]
    out = local_map(combine, out_placements=out_pl,
                    in_placements=(y_pl, g_pl, g_pl),
                    in_grad_placements=(y_grad, g_pl, w_grad),
                    device_mesh=mesh, redistribute_inputs=True)(y, rows, w)
    return out, top_i, probs


def moe_ffn(p: Dict, x: torch.Tensor, cfg: ModelConfig,
            shd=NOSHARD) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B,S,D] -> (out [B,S,D], aux loss)."""
    b, s, d = x.shape
    t = b * s
    e, k = cfg.layout_n_experts, cfg.top_k
    ng = _n_groups(t, shd.dp_size())
    xg = shd(x.reshape(ng, t // ng, d), "moe_groups", None, None)
    if shd.active and is_dtensor(xg):
        out, top_i, probs = _sharded_moe(p, xg, cfg, shd, x.dtype)
    else:
        xin, top_i, rows, w, probs = _dispatch(p["router"], xg, cfg)
        h = F.silu(torch.bmm(xin, p["w_gate"]).float()).to(x.dtype)
        h = h * torch.bmm(xin, p["w_up"])
        y = torch.bmm(h, p["w_down"]).view(-1, d)
        out = (w[..., None] * y[rows].float()).sum(dim=2).to(x.dtype)
    # load-balance auxiliary loss (Switch eq. 4)
    if shd.active and is_dtensor(xg):
        counts, prob_sums = _sharded_load_sums(top_i, probs, e)
        frac_tokens, frac_probs = counts / t, prob_sums / t
    else:
        frac_tokens = (top_i[..., None] == torch.arange(e, device=x.device)
                       ).float().sum(dim=2).mean(dim=(0, 1))
        frac_probs = probs.mean(dim=(0, 1))
    aux = e * torch.sum(frac_tokens * frac_probs) / k
    return out.reshape(b, s, d), aux


def _sharded_load_sums(top_i, probs, e: int):
    """Each expert's top-k choices and its summed probability, [E]
    float32 each, per data shard of the groups: partial sums over the
    data axes, which the aux loss's product all-reduces.  Each shard's
    probabilities take their gradient locally, in their own placement
    (the gradient of a partial sum is whole on every rank), where a
    global mean's backward makes the [G,t,E] gradient a partial sum to
    reduce-scatter."""
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map
    g_pl = list(probs.placements)
    sum_pl = [Partial() if pl.is_shard() else Replicate() for pl in g_pl]

    def sums(top_i, probs):
        counts = (top_i[..., None] == torch.arange(e, device=top_i.device)
                  ).float().sum(dim=(0, 1, 2))
        return counts, probs.sum(dim=(0, 1))
    return local_map(sums, out_placements=(sum_pl, sum_pl),
                     in_placements=(g_pl, g_pl),
                     in_grad_placements=(g_pl, g_pl),
                     device_mesh=probs.device_mesh,
                     redistribute_inputs=True)(top_i, probs)
