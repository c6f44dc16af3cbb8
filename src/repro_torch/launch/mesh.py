"""Meshes and hardware constants of the card (the JAX module's per-chip
constants, for an NVIDIA H100 SXM5 80 GB at its 700 W power limit; the
TPU constants of `repro.launch.mesh` do not carry over).

Both meshes are `torch.distributed` device meshes over the process group
that is already running, one process a card:
  * `make_host_mesh` — ``(world // model, model)`` over whatever ranks
    run (tests, examples; on one card its world size is 1),
  * `make_production_mesh` — ``(16, 16)`` ("data", "model") = 256 ranks,
    or ``(2, 16, 16)`` ("pod", "data", "model") = 512, on the device the
    caller names (the dry run's fake group runs either); any other world
    size raises, with no smaller fallback.
"""

from __future__ import annotations

import math

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

__all__ = ["make_production_mesh", "make_host_mesh", "PEAK_FLOPS_BF16",
           "HBM_BW", "ICI_BW_PER_LINK", "HBM_BYTES"]


def _running_group(what: str) -> str:
    """The device type of the running default group ("cuda" for NCCL,
    "cpu" for gloo); raises if none runs."""
    if not dist.is_initialized():
        raise RuntimeError(f"{what}: no process group is running "
                           f"(torch.distributed.init_process_group first)")
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_production_mesh(*, multi_pod: bool = False,
                         device: str = "cuda") -> DeviceMesh:
    """The production mesh over the running default group: ``(16, 16)``
    with dims ("data", "model"), or ``(2, 16, 16)`` with ("pod", "data",
    "model") for ``multi_pod``, on ``device`` ("cuda" unless the caller
    asks for "cpu"; nothing infers it).  Raises ``RuntimeError``
    naming the world size when the group does not have exactly 256 (512)
    ranks, or when no group runs."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    _running_group("make_production_mesh")
    need = math.prod(shape)
    world = dist.get_world_size()
    if world != need:
        raise RuntimeError(f"make_production_mesh: the {shape} mesh needs "
                           f"{need} ranks, the running group has world "
                           f"size {world}")
    return init_device_mesh(device, shape, mesh_dim_names=axes)


def make_host_mesh(model: int = 1) -> DeviceMesh:
    """A ``(world // model, model)`` mesh with dims ``("data", "model")``
    over the running default process group: on CUDA devices for an NCCL
    group, on the CPU for gloo.  Raises if no group is running."""
    device = _running_group("make_host_mesh")
    n = dist.get_world_size()
    data = max(1, n // model)
    return init_device_mesh(device, (data, model),
                            mesh_dim_names=("data", "model"))


# NVIDIA H100 SXM5 80 GB: dense bf16 on the tensor cores, 989 TFLOP/s
# without sparsity (NVIDIA's H100 datasheet), in FLOP/s.
PEAK_FLOPS_BF16 = 989e12
# The same card: HBM3 at 3.35 TB/s (NVIDIA's H100 datasheet), in
# bytes/s.  A card set below its 700 W power limit may reach less.
HBM_BW = 3.35e12
# NVLink 4 on the same card: 900 GB/s over its 18 links, counted both ways
# (NVIDIA's H100 datasheet), so 50 GB/s a link both ways and 25 GB/s a link
# each way.  This is the one-way rate, in bytes/s: a ring hop sends one way.
ICI_BW_PER_LINK = 25e9
# The same card's 80 GB of HBM3 (NVIDIA's H100 datasheet): five stacks of
# 16 GiB, in bytes.  What CUDA reports as the card's total memory
# (`torch.cuda.get_device_properties(0).total_memory`) is this less what
# the system reserves, so never above it.
HBM_BYTES = 80 * (1 << 30)
