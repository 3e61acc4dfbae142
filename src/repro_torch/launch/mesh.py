"""Production mesh construction and the H100 constants of the roofline.

The port of the JAX package's ``launch/mesh.py``.  Same shapes and axis
names, which the rule tables of ``distributed/sharding.py`` depend on:

    single pod:  (16, 16)     = 256 GPUs, axes ("data", "model")
    multi-pod:   (2, 16, 16)  = 512 GPUs, axes ("pod", "data", "model")

"pod" is outer data parallelism.  Meshes are ``DeviceMesh`` objects over
the ranks of the process group that exists; both builders are functions
(never module constants), so importing this module touches no process
group and no device.  ``make_production_mesh`` needs a group of 256 or
512 ranks: the dry run (``launch/dryrun.py``) makes one with the fake
backend and places meta tensors on it.

The roofline prices one H100 SXM (data sheet numbers, per GPU):

* ``PEAK_FLOPS_BF16``: 989e12 dense bf16 tensor-core flop/s;
* ``PEAK_FLOPS_F32``: 67e12 float32 flop/s outside the tensor cores;
* ``HBM_BW``: 3.35e12 B/s of HBM3;
* ``NVLINK_BW``: 450e9 B/s per direction over NVLink 4 (900 GB/s
  bidirectional) between the 8 GPUs of one HGX node;
* ``NODE_LINK_BW``: 50e9 B/s per GPU between nodes, one 400 Gb/s NDR
  InfiniBand adapter per GPU.

Ranks fill nodes of ``GPUS_PER_NODE`` = 8 in order, and the ``model``
axis is innermost, so a collective group along ``model`` (16 ranks)
spans two nodes and one along ``data`` or ``pod`` spans 16 or 2 nodes.
A group whose ranks span more than one node is priced at the cross-node
rate (``group_link_bw``); only a group inside one node gets NVLink's.
"""
from __future__ import annotations

from typing import Sequence

PEAK_FLOPS_BF16 = 989e12     # H100 SXM data sheet: dense BF16 tensor core
PEAK_FLOPS_F32 = 67e12       # H100 SXM data sheet: FP32 (CUDA cores)
HBM_BW = 3.35e12             # H100 SXM data sheet: HBM3 bytes/s
NVLINK_BW = 450e9            # H100 SXM data sheet: NVLink 4, 900 GB/s
#                              bidirectional, per direction
NODE_LINK_BW = 50e9          # one 400 Gb/s NDR InfiniBand adapter per GPU
GPUS_PER_NODE = 8            # HGX H100: 8 GPUs a node on NVLink

PRODUCTION_SHAPES = {False: ((16, 16), ("data", "model")),
                     True: ((2, 16, 16), ("pod", "data", "model"))}


def group_link_bw(ranks: Sequence[int]) -> float:
    """Bytes/s one GPU moves in a collective over ``ranks``: NVLink when
    every rank lies in one node of ``GPUS_PER_NODE``, else the
    cross-node rate."""
    nodes = {r // GPUS_PER_NODE for r in ranks}
    return NVLINK_BW if len(nodes) <= 1 else NODE_LINK_BW


def make_production_mesh(*, multi_pod: bool = False, device_type="cpu"):
    """The (16, 16) or (2, 16, 16) mesh over the default process group,
    which must have 256 or 512 ranks."""
    from torch.distributed.device_mesh import init_device_mesh
    shape, names = PRODUCTION_SHAPES[multi_pod]
    return init_device_mesh(device_type, shape, mesh_dim_names=names)


def make_host_mesh(model: int = 1, device_type="cuda"):
    """A ("data", "model") mesh over the ranks of the process group that
    exists (one on a single card): ``model`` ranks on the inner axis (at
    most the group's size), the rest on ``data``."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    n = dist.get_world_size()
    model = min(model, n)
    return init_device_mesh(device_type, (n // model, model),
                            mesh_dim_names=("data", "model"))
