"""Content-addressed, delta-encoded checkpoints of tensor trees.

The port of the JAX package's ``training/checkpoint.py``, with the same
files:

  * every leaf is saved whole with a JSON manifest, so a checkpoint does
    not depend on where the state lived when it was written;
  * every leaf is SHA-256 content-addressed into a shared blob store
    (``blobs/<hash>.npy``) and the manifest references blobs by hash, so
    step-over-step checkpoints write only the leaves that changed;
  * writes are atomic (temporary file + rename), so a crash while
    writing never corrupts the latest valid checkpoint;
  * old manifests beyond ``keep`` are dropped and unreferenced blobs
    removed.

Trees are nested dicts, tuples and ``NamedTuple``s (``AdamWState``) of
tensors, or of DTensors over a process group's mesh: ``save`` gathers
each leaf whole (every rank takes part), rank 0 alone writes the blobs
and the manifest, and every rank returns once they are written, so the
files are a one-process run's; ``restore`` loads the whole arrays on
every rank and places each leaf as ``tree_like``'s leaf is placed.
Leaf keys are spelled as JAX's ``tree_flatten_with_path`` spells them
(dict keys sorted, a tuple index as ``0``, a ``NamedTuple`` field as
``.master``: ``1/.master/layers/wq``), bf16 is stored as its
``uint16`` bits with ``tag: "bfloat16"``, and the hash covers the numpy
dtype, shape and bytes as JAX's does.  So a checkpoint the JAX package
wrote restores here, and the same state gives the same manifest.
"""
from __future__ import annotations

import hashlib
import json
import os
import tempfile
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.distributed.sharding import is_dtensor


def _is_namedtuple(x: Any) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _leaf_paths(tree: Any, prefix: Tuple[str, ...] = ()
                ) -> List[Tuple[str, Any]]:
    """(key, leaf) in JAX's flattening order and spelling."""
    if isinstance(tree, dict):
        parts = [(str(k), tree[k]) for k in sorted(tree)]
    elif _is_namedtuple(tree):
        parts = [(f".{f}", getattr(tree, f)) for f in tree._fields]
    elif isinstance(tree, (tuple, list)):
        parts = [(str(i), t) for i, t in enumerate(tree)]
    else:
        return [("/".join(prefix), tree)]
    return [kv for key, sub in parts for kv in _leaf_paths(sub, prefix
                                                           + (key,))]


def _unflatten(tree: Any, leaves) -> Any:
    """A tree shaped like ``tree`` with its leaves taken in order from
    the iterator ``leaves``."""
    if isinstance(tree, dict):
        out = {k: _unflatten(tree[k], leaves) for k in sorted(tree)}
        return {k: out[k] for k in tree}
    if _is_namedtuple(tree):
        return type(tree)(*(_unflatten(getattr(tree, f), leaves)
                            for f in tree._fields))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_unflatten(t, leaves) for t in tree)
    return next(leaves)


def _to_numpy(leaf: torch.Tensor) -> Tuple[np.ndarray, Optional[str]]:
    """A tensor's bytes as numpy (a DTensor's whole value); bf16 (no
    numpy dtype) as uint16 + tag."""
    t = leaf.detach()
    if is_dtensor(t):
        t = t.full_tensor()
    t = t.cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    return t.numpy(), None


def _writer(tree: Any) -> Tuple[bool, Any]:
    """(whether this process writes, the group to wait on): with DTensor
    leaves, rank 0 of the process group writes and the others wait for
    it; otherwise this process writes alone."""
    if any(is_dtensor(leaf) for _, leaf in _leaf_paths(tree)):
        import torch.distributed as dist
        return dist.get_rank() == 0, dist.group.WORLD
    return True, None


def _hash_array(arr: np.ndarray) -> str:
    h = hashlib.sha256()
    h.update(str(arr.dtype).encode())
    h.update(str(arr.shape).encode())
    h.update(memoryview(np.ascontiguousarray(arr)).cast("B"))
    return h.hexdigest()


def _write_blob(blob_dir: str, blob: str, arr: np.ndarray) -> None:
    fd, tmp = tempfile.mkstemp(dir=blob_dir)
    with os.fdopen(fd, "wb") as f:
        np.save(f, arr, allow_pickle=False)
    os.replace(tmp, blob)


# leaves hashed and written at once by a save (and read by a restore):
# hashlib, the file writes and reads release the interpreter lock, so a
# checkpoint's leaves go through the host's cores side by side; at most
# twice as many leaves' host copies are held as there are threads
IO_THREADS = min(8, os.cpu_count() or 1)


def _as_leaf(meta: Dict, arr: np.ndarray, like: torch.Tensor
             ) -> torch.Tensor:
    """A loaded array as a leaf like ``like``: its dtype, and its device
    or, for a DTensor, its mesh and placements."""
    t = torch.from_numpy(arr.view(np.int16) if meta.get("tag")
                         == "bfloat16" else arr)
    if meta.get("tag") == "bfloat16":
        t = t.view(torch.bfloat16)
    if is_dtensor(like):
        from torch.distributed.tensor import distribute_tensor
        return distribute_tensor(
            t.to(device=like.device_mesh.device_type, dtype=like.dtype),
            like.device_mesh, like.placements)
    return t.to(device=like.device, dtype=like.dtype)


class CheckpointManager:
    def __init__(self, directory: str, *, keep: int = 3):
        self.dir = directory
        self.blob_dir = os.path.join(directory, "blobs")
        self.keep = keep
        os.makedirs(self.blob_dir, exist_ok=True)

    # ------------------------------------------------------------------
    def save(self, step: int, tree: Any, extra: Optional[Dict] = None
             ) -> Dict[str, Any]:
        manifest: Dict[str, Any] = {"step": step, "leaves": {},
                                    "extra": extra or {}}
        writes, group = _writer(tree)
        delta = {"new_bytes": 0, "reused_bytes": 0}
        pending, writing, written = [], [], set()

        def settle(key, arr, tag, hashed):
            # in leaf order: a blob this save already wrote, or one that
            # was there, is reused
            h = hashed.result()
            blob = os.path.join(self.blob_dir, h + ".npy")
            if h in written or os.path.exists(blob):
                delta["reused_bytes"] += arr.nbytes
            else:
                written.add(h)
                writing.append(pool.submit(_write_blob, self.blob_dir, blob,
                                           arr))
                delta["new_bytes"] += arr.nbytes
            manifest["leaves"][key] = {"hash": h, "dtype": str(arr.dtype),
                                       "tag": tag, "shape": list(arr.shape)}

        with ThreadPoolExecutor(IO_THREADS) as pool:
            for key, leaf in _leaf_paths(tree):
                if not writes:
                    leaf.full_tensor()    # the gather needs every rank
                    continue
                arr, tag = _to_numpy(leaf)
                pending.append((key, arr, tag, pool.submit(_hash_array,
                                                           arr)))
                if len(pending) > IO_THREADS:
                    settle(*pending.pop(0))
                while len(writing) > IO_THREADS:
                    writing.pop(0).result()
            for item in pending:
                settle(*item)
            for w in writing:
                w.result()
        manifest["delta"] = delta
        if writes:
            path = os.path.join(self.dir, f"ckpt_{step:08d}.json")
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(manifest, f)
            os.replace(tmp, path)
            self._gc()
        if group is not None:
            import torch.distributed as dist
            dist.barrier(group)
            if not writes:            # rank 0's manifest, as written
                with open(os.path.join(self.dir,
                                       f"ckpt_{step:08d}.json")) as f:
                    manifest = json.load(f)
        return manifest

    # ------------------------------------------------------------------
    def latest_step(self) -> Optional[int]:
        steps = [int(f[5:13]) for f in os.listdir(self.dir)
                 if f.startswith("ckpt_") and f.endswith(".json")]
        return max(steps) if steps else None

    def restore(self, tree_like: Any, step: Optional[int] = None
                ) -> Tuple[Any, Dict]:
        """The checkpoint at ``step`` (the latest by default) as a tree
        shaped like ``tree_like``, each leaf in its dtype and on its
        device."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError("no checkpoint found")
        with open(os.path.join(self.dir, f"ckpt_{step:08d}.json")) as f:
            manifest = json.load(f)
        leaves = _leaf_paths(tree_like)
        out, loading = [], []
        with ThreadPoolExecutor(IO_THREADS) as pool:
            for i, (key, leaf) in enumerate(leaves + [(None, None)] *
                                            IO_THREADS):
                if i >= IO_THREADS:       # in leaf order, a window behind
                    meta, like, arr = loading.pop(0)
                    out.append(_as_leaf(meta, arr.result(), like))
                if key is not None:
                    meta = manifest["leaves"][key]
                    loading.append((meta, leaf, pool.submit(
                        np.load, os.path.join(self.blob_dir,
                                              meta["hash"] + ".npy"))))
        return _unflatten(tree_like, iter(out)), manifest

    # ------------------------------------------------------------------
    def _gc(self) -> None:
        """Drop old manifests; keep blobs referenced by surviving ones."""
        files = sorted(f for f in os.listdir(self.dir)
                       if f.startswith("ckpt_") and f.endswith(".json"))
        for f in files[:-self.keep]:
            os.remove(os.path.join(self.dir, f))
        live = set()
        for f in os.listdir(self.dir):
            if f.startswith("ckpt_") and f.endswith(".json"):
                with open(os.path.join(self.dir, f)) as fh:
                    m = json.load(fh)
                live.update(v["hash"] for v in m["leaves"].values())
        for blob in os.listdir(self.blob_dir):
            if blob.endswith(".npy") and blob[:-4] not in live:
                os.remove(os.path.join(self.blob_dir, blob))
