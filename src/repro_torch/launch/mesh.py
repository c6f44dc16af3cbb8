"""Meshes and hardware constants of the card (the JAX module's per-chip
constants).

`make_host_mesh` is the counterpart of `repro.launch.mesh.make_host_mesh`:
a `torch.distributed` device mesh over the process group that is already
running (one process a card; on one card its world size is 1).
``make_production_mesh``, ``PEAK_FLOPS_BF16`` and ``HBM_BYTES`` wait for
the roofline and multi-card slices (ROADMAP.md); the TPU constants of
`repro.launch.mesh` do not carry over.
"""

from __future__ import annotations

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

__all__ = ["make_host_mesh", "HBM_BW", "ICI_BW_PER_LINK"]


def make_host_mesh(model: int = 1) -> DeviceMesh:
    """A ``(world // model, model)`` mesh with dims ``("data", "model")``
    over the running default process group: on CUDA devices for an NCCL
    group, on the CPU for gloo.  Raises if no group is running."""
    if not dist.is_initialized():
        raise RuntimeError("make_host_mesh: no process group is running "
                           "(torch.distributed.init_process_group first)")
    n = dist.get_world_size()
    data = max(1, n // model)
    device = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device, (data, model),
                            mesh_dim_names=("data", "model"))


# NVIDIA H100 SXM5 80 GB: HBM3 at 3.35 TB/s (NVIDIA's H100 datasheet), in
# bytes/s.  A card set below its 700 W power limit may reach less.
HBM_BW = 3.35e12
# NVLink 4 on the same card: 900 GB/s over its 18 links, counted both ways
# (NVIDIA's H100 datasheet), so 50 GB/s a link both ways and 25 GB/s a link
# each way.  This is the one-way rate, in bytes/s: a ring hop sends one way.
ICI_BW_PER_LINK = 25e9
