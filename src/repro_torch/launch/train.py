"""Training launcher CLI of the port.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \\
        [--reduced] [--steps 20] [--ckpt DIR] [--monitor] [--device cuda]
    PYTHONPATH=src torchrun --nproc-per-node N -m repro_torch.launch.train \\
        --arch qwen1.5-0.5b [--production-mesh] ...

Runs the fault-tolerant trainer.  Alone it trains on one device:
``--device`` defaults to the CUDA card, ``--device cpu`` runs the plain
PyTorch path.  Under ``torchrun`` it joins the process group torchrun
describes (NCCL on cards, gloo on the CPU; one card a rank) and trains
the sharded step on `make_host_mesh()` over every rank, or on the
``(16, 16)`` production mesh with ``--production-mesh``, which raises
unless 256 ranks run.  Restart-safe: re-running the same command resumes
from the latest checkpoint.  ``--monitor`` adds the monitor with the JAX
CLI's `SimClock` (four devices, no contention).
"""

from __future__ import annotations

import argparse
import os
import tempfile

import torch
import torch.distributed as dist

from repro_torch.configs.base import ShapeSpec, get_config, reduced_config
from repro_torch.data.pipeline import DataConfig
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.tpuprobe.monitor import PodMonitor, SimClock
from repro_torch.train import train_step as ts
from repro_torch.train.trainer import Trainer, TrainerConfig

__all__ = ["main"]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--reduced", action="store_true",
                    help="smoke-scale config of the same family")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--microbatches", type=int, default=2)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "repro_torch_launch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--production-mesh", action="store_true",
                    help="the (16, 16) production mesh (256 ranks under "
                         "torchrun)")
    ap.add_argument("--monitor", action="store_true",
                    help="enable the CacheX monitor + rebalancer")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default: the CUDA card)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced_config(cfg)
    shape = ShapeSpec("cli", args.seq, args.batch, "train")
    hyper = ts.TrainHyper(microbatches=args.microbatches, remat="none")
    monitor = PodMonitor(4, clock=SimClock(lambda d, t: 1.0)) \
        if args.monitor else None
    device = torch.device(args.device)
    joined = _join_torchrun_group(device)
    mesh = None
    if args.production_mesh:
        mesh = make_production_mesh()
    elif dist.is_initialized():
        mesh = make_host_mesh()
    first = not dist.is_initialized() or dist.get_rank() == 0
    try:
        tr = Trainer(cfg, shape, hyper,
                     TrainerConfig(ckpt_dir=args.ckpt,
                                   ckpt_every=args.ckpt_every,
                                   data=DataConfig(seed=args.seed)),
                     monitor=monitor, device=device, mesh=mesh)
        log = tr.run(args.steps, seed=args.seed)
    finally:
        if joined:
            dist.destroy_process_group()
    if first:
        for r in log[-5:]:
            print(f"step {r['step']} loss {r['loss']:.4f} "
                  f"({r['wall_s']:.2f}s)")
    return log


def _join_torchrun_group(device: torch.device) -> bool:
    """Under ``torchrun`` (its environment names the rank and the world),
    join its process group: NCCL with this rank's card for a CUDA
    ``device``, gloo for the CPU.  Returns whether it joined one."""
    if dist.is_initialized() or "TORCHELASTIC_RUN_ID" not in os.environ:
        return False
    if device.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo")
    return True


if __name__ == "__main__":
    main()
