"""The kernels on meta tensors and on DTensors: the dry run's path.

On a meta tensor (``resolve_backend`` -> ``"abstract"``) each kernel
wrapper calls its counterpart here, which allocates what the wrapper
allocates (the outputs, and the backward's float32 scratch) as empty
meta tensors of the kernel's shapes and dtypes, and records the call's
cost with ``kernels/cost.py``'s formulas.  Nothing runs.

On a DTensor (any device) the wrapper runs on each rank's shards
through ``local_map`` (``sharded_flash``): batch over the data axes it
is already split on, heads over ``model``, the sequence whole; each
shard then resolves its backend by its device, so a meta shard records
the cost of the shard its rank holds.
Causal attention gets its K/V repeated to the query heads before
(``models/attention.causal_attention``), as the JAX package orders it,
so every head shard is a whole group.

A decode over a sequence-sharded slot cache (the ``kv_seq`` rule) is a
split decode: each rank runs kernel 1 over its own slice of every
row's keys with the slice's log-sum-exp as a second output, and the
slices' outputs are merged by their log-sum-exps (``split_decode``):
two all-reduces of [B, Hq(, hd)] floats over the sequence axes
(``merge_slices``).  Kernels 1 and 8 write that output on the card, the
plain versions on the CPU, and the dry run prices it (its [B, Hq]
float32 written once).
"""
from __future__ import annotations

import math

import torch

from repro_torch.distributed.sharding import DATA_AXES, is_dtensor
from repro_torch.kernels import cost


def _kernel_layout(x, batch_dim: int, head_dim: int):
    """A DTensor's placements in the kernel's layout: its batch split over
    whichever data axes split it now, heads over ``model`` where they
    divide it, everything else whole."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    mesh = x.device_mesh
    for i, (name, p) in enumerate(zip(mesh.mesh_dim_names, x.placements)):
        if (name == "model" and mesh.size(i) > 1
                and x.shape[head_dim] % mesh.size(i) == 0):
            out.append(Shard(head_dim))
        elif (name in DATA_AXES and isinstance(p, Shard)
              and p.dim == batch_dim):
            out.append(Shard(batch_dim))
        else:
            out.append(Replicate())
    return out


def _moved(placements, dims):
    """``placements`` with each ``Shard(d)`` moved to ``Shard(dims[d])``."""
    from torch.distributed.tensor import Shard
    return [Shard(dims[p.dim]) if isinstance(p, Shard) else p
            for p in placements]


def _local_map(fn, out_placements, in_placements, mesh, *args):
    from torch.distributed.tensor.experimental import local_map
    return local_map(fn, out_placements=out_placements,
                     in_placements=in_placements, device_mesh=mesh,
                     redistribute_inputs=True)(*args)


# ---------------------------------------------------------------------------
# kernel 7: causal flash prefill, and its backward (row 7b)
# ---------------------------------------------------------------------------
def sharded_flash(wrapper, q, k, v, backend, with_lse: bool):
    """``wrapper`` (the forward kernel's) on each rank's shards of DTensor
    q, k, v [B,S,H,d]: batch as split, heads over ``model``."""
    lay = _kernel_layout(q, 0, 2)
    outs = (lay, _moved(lay, {0: 0, 2: 1})) if with_lse else lay
    return _local_map(
        lambda a, b, c: wrapper(a, b, c, backend=backend, with_lse=with_lse),
        outs, (lay, lay, lay), q.device_mesh, q, k, v)


def sharded_flash_bwd(wrapper, q, k, v, o, do, lse, backend):
    """The backward kernel's ``wrapper`` on each rank's shards."""
    lay = _kernel_layout(q, 0, 2)
    lse_lay = None if lse is None else _moved(lay, {0: 0, 2: 1})
    return _local_map(
        lambda *a: wrapper(*a, backend=backend), (lay, lay, lay),
        (lay, lay, lay, lay, lay, lse_lay), q.device_mesh, q, k, v, o, do,
        lse)


def flash_prefill(q, k, v, with_lse: bool = False):
    b, s, hq, dk = q.shape
    out = q.new_empty((b, s, hq, v.shape[3]))
    lse = (q.new_empty((b, hq, s), dtype=torch.float32) if with_lse
           else None)
    nbytes, flops = cost.flash_cost({"q": q, "k": k, "v": v})
    if with_lse:
        nbytes += lse.numel() * 4
    cost.record("flash_prefill", nbytes, flops)
    return (out, lse) if with_lse else out


def flash_prefill_bwd(q, k, v, o, do, lse):
    from repro_torch.kernels import flash_prefill as fp
    b, s, hq, hd = q.shape
    hkv = k.shape[2]
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    delta = q.new_empty((b, hq, s), dtype=torch.float32)
    code = int(q.dtype == torch.bfloat16)
    parts = fp.bwd_kv_parts(b, s, hq, hkv,
                            fp.bwd_kv_tile(hd, v.shape[3], code),
                            fp.bwd_per_sm(hd, v.shape[3], code))
    tensor_core = (q.dtype == torch.bfloat16
                   and (hd, v.shape[3]) in fp.BWD_WIDTHS)
    part = (q.new_empty((parts * (k.numel() + v.numel()),),
                        dtype=torch.float32)
            if parts > 1 and tensor_core else None)
    nbytes, flops, peak = cost.bwd_cost({"q": q, "k": k, "v": v, "o": o,
                                         "lse": lse})
    cost.record("flash_prefill_bwd", nbytes, flops, peak)
    del delta, part               # freed when the call returns
    return dq, dk, dv


# ---------------------------------------------------------------------------
# kernels 1 and 8: paged decode (bf16 and int8 pages)
# ---------------------------------------------------------------------------
def _window(k_pages, block_tables) -> int:
    """Tokens a row's table covers: the decode cost of a row at a full
    cache."""
    return block_tables.shape[1] * k_pages.shape[1]


def _no_dtensor(name, x):
    if is_dtensor(x):
        raise NotImplementedError(
            f"{name}: the paged pool is a one-card structure; a sharded "
            f"decode runs over the dense slot cache (split_decode)")


def _with_lse(q, nbytes, with_lse: bool):
    """The decode's outputs, and its bytes with the log-sum-exp
    [B,Hq] float32 written once when asked for."""
    if not with_lse:
        return torch.empty_like(q), nbytes
    lse = q.new_empty(q.shape[:2], dtype=torch.float32)
    return (torch.empty_like(q), lse), nbytes + lse.numel() * 4


def paged_decode(q, k_pages, v_pages, block_tables, lengths,
                 with_lse: bool = False):
    _no_dtensor("paged_decode", q)
    a = {"q": q, "k_pages": k_pages, "block_tables": block_tables}
    nbytes, flops = cost.decode_cost(
        a, q.shape[0] * _window(k_pages, block_tables))
    out, nbytes = _with_lse(q, nbytes, with_lse)
    cost.record("paged_decode", nbytes, flops)
    return out


def paged_decode_int8(q, k_pages, v_pages, k_scales, v_scales, block_tables,
                      lengths, with_lse: bool = False):
    _no_dtensor("paged_decode_int8", q)
    a = {"q": q, "k_pages": k_pages, "k_scales": k_scales,
         "block_tables": block_tables}
    nbytes, flops = cost.int8_decode_cost(
        a, q.shape[0] * _window(k_pages, block_tables))
    out, nbytes = _with_lse(q, nbytes, with_lse)
    cost.record("paged_decode_int8", nbytes, flops)
    return out


# ---------------------------------------------------------------------------
# kernels 2-6: the engine's paged prefill and MLA kernels (one card)
# ---------------------------------------------------------------------------
def paged_prefill(name, q, k_chunk, k_pages, block_tables):
    """Chunk or segment prefill over a full table window: every query
    attends the row's whole window and its causal chunk keys."""
    _no_dtensor(name, q)
    b, c = q.shape[:2]
    pool = b * _window(k_pages, block_tables)
    a = {"q": q, "k_chunk": k_chunk, "k_pages": k_pages,
         "block_tables": block_tables}
    cost.record(name, *cost.prefill_cost(
        a, pool, b * (c * pool // b + c * (c + 1) // 2)))
    return torch.empty_like(q)


def mla(name, q_lat, q_rope, latent_pages, block_tables, ints,
        lat_chunk=None):
    """An MLA call over full table windows (decode: one query a row;
    prefill: each chunk query attends the window and its causal chunk
    keys) -> the context [.., Hq, dl] in q's dtype."""
    _no_dtensor(name, q_lat)
    window = _window(latent_pages, block_tables)
    rows = block_tables.shape[0]
    a = {"q_lat": q_lat, "q_rope": q_rope, "latent_pages": latent_pages,
         "block_tables": block_tables, "lengths": ints}
    if lat_chunk is None:
        pairs = rows * window
    else:
        a["lat_chunk"] = lat_chunk
        c = q_lat.shape[1]
        pairs = rows * (c * window + c * (c + 1) // 2)
    cost.record(name, *cost.mla_cost(a, rows * window, pairs))
    return torch.empty_like(q_lat)


# ---------------------------------------------------------------------------
# the split decode over a sequence-sharded slot cache
# ---------------------------------------------------------------------------
def _seq_split(cache):
    """The mesh dims that split a DTensor cache [B,S,...]'s sequence
    (dim 1), in mesh order."""
    from torch.distributed.tensor import Shard
    return [i for i, p in enumerate(cache.placements)
            if isinstance(p, Shard) and p.dim == 1]


def split_decode(q, k_cache, v_cache, lengths, k_scale=None, v_scale=None,
                 attend=None):
    """q [B,1,Hq,hd] over DTensor slot caches [B,S,Hkv,hd] whose sequence
    may be split over some mesh axes (unsplit: ``attend`` on each rank's
    rows, nothing to merge).  ``attend(q1, k, v, lengths, *scales,
    with_lse=...)`` runs the decode kernel over one slice (local
    tensors) -> [B,Hq,hd], or with ``with_lse`` (out, lse [B,Hq]).
    Each rank attends its slice (lengths shifted by the slice's start)
    and the slices merge by their log-sum-exps (``merge_slices``).
    Returns [B,1,Hq,hd] in q's dtype."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = k_cache.device_mesh
    split = _seq_split(k_cache)
    s_loc = k_cache.shape[1] // math.prod(mesh.shape[i] for i in split)
    cache_pl = [p if i in split or (isinstance(p, Shard) and p.dim == 0)
                else Replicate() for i, p in enumerate(k_cache.placements)]
    row_pl = [Shard(0) if isinstance(p, Shard) and p.dim == 0
              else Replicate() for p in cache_pl]
    out_pl = [Shard(0) if i in split else _moved([p], {0: 1})[0]
              for i, p in enumerate(row_pl)]

    def local(q, k, v, lengths, *scales):
        idx = 0
        for i in split:
            idx = idx * mesh.shape[i] + mesh.get_local_rank(i)
        n = (lengths - idx * s_loc).clamp(0, s_loc).to(torch.int32)
        o, lse = attend(q[:, 0].contiguous(), k, v, n, *scales,
                        with_lse=True)
        return o.float()[None], lse[None]

    scales = () if k_scale is None else (k_scale, v_scale)
    in_pl = (row_pl, cache_pl, cache_pl, row_pl) + (cache_pl,) * len(scales)
    if not split:                 # each rank holds its rows' whole keys
        return _local_map(
            lambda q, k, v, n, *sc: attend(q[:, 0].contiguous(), k, v, n,
                                           *sc)[:, None],
            row_pl, in_pl, mesh, q, k_cache, v_cache, lengths, *scales)
    o, lse = _local_map(local, (out_pl, out_pl),
                        in_pl, mesh, q, k_cache, v_cache, lengths, *scales)
    return merge_slices(o, lse).to(q.dtype)[:, None]


def merge_slices(o, lse):
    """One decode's slices merged by their log-sum-exps: o [n,B,Hq,hd]
    float32 and lse [n,B,Hq] (slice i over its own keys) -> [B,Hq,hd]
    float32, o = sum_i exp(lse_i - m) o_i / sum_i exp(lse_i - m),
    m = max_i lse_i.  A slice with no key (lse -1e30) weighs nothing
    beside one that has; if no slice has one, all weigh alike and the
    zeros they hold come out."""
    m = lse.amax(dim=0)
    w = torch.exp(lse - m)
    return (w[..., None] * o).sum(dim=0) / w.sum(dim=0)[..., None]


def cache_write(cache, new, pos):
    """The dense decode's in-place write of one token per row at ``pos``
    [B] into a DTensor slot cache [B,S,...]: each rank writes the rows
    whose position falls in its slice of the sequence (the others
    rewrite the slot they hold), so no shard moves."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = cache.device_mesh
    split = _seq_split(cache)
    s_loc = cache.shape[1] // math.prod(mesh.shape[i] for i in split)
    cache_pl = list(cache.placements)
    row_pl = [Shard(0) if isinstance(p, Shard) and p.dim == 0
              else Replicate() for p in cache_pl]
    new_pl = [Shard(p.dim) if isinstance(p, Shard) and p.dim >= 2
              else row_pl[i] for i, p in enumerate(cache_pl)]

    def local(c, n, pos):
        idx = 0
        for i in split:
            idx = idx * mesh.shape[i] + mesh.get_local_rank(i)
        lp = pos - idx * s_loc
        inside = (lp >= 0) & (lp < s_loc)
        lp = lp.clamp(0, s_loc - 1)
        rows = torch.arange(c.shape[0], device=c.device)
        mask = inside.reshape((-1,) + (1,) * (c.dim() - 2))
        c[rows, lp] = torch.where(mask, n[:, 0].to(c.dtype), c[rows, lp])
        return c

    return _local_map(local, cache_pl, (cache_pl, new_pl, row_pl), mesh,
                      cache, new, pos)
