"""Workers of the port's multi-process gloo tests.  They import neither
JAX nor the JAX package, so a spawned rank starts in the time torch
takes to import."""

import torch.distributed as dist

from repro_torch.configs import base as tbase
from repro_torch.distributed import elastic, sharding
from repro_torch.launch import mesh as tmesh
from repro_torch._tree import tree_flatten_with_path
from repro_torch.train import train_step as ts


def restore_worker(rank, world, store, ckpt_root, step, jobs, out):
    """One rank of a ``(world // 2, 2)`` ("data", "model") gloo mesh: each
    reduced ``(arch, compress_cross_pod)`` checkpoint of ``jobs`` under
    ``ckpt_root/arch`` restored onto it, put on ``out`` as ``(rank,
    {"coords": ..., arch: {path: (type, device, placements, local)}})``,
    or ``(rank, repr(error))``."""
    try:
        dist.init_process_group("gloo", init_method=f"file://{store}",
                                world_size=world, rank=rank)
        mesh = tmesh.make_host_mesh(model=2)
        res = {"coords": list(mesh.get_coordinate())}
        for arch, compress in jobs:
            cfg = tbase.reduced_config(tbase.get_config(arch))
            state = elastic.restore_on_mesh(
                f"{ckpt_root}/{arch}", step, cfg,
                ts.TrainHyper(compress_cross_pod=compress), mesh)
            res[arch] = {
                sharding.path_str(p): (type(x).__name__, x.device.type,
                                       list(x.placements),
                                       x.to_local().numpy())
                for p, x in tree_flatten_with_path(state)}
        dist.destroy_process_group()
        out.put((rank, res))
    except Exception as e:  # report to the parent, which fails the test
        out.put((rank, repr(e)))
