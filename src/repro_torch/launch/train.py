"""Training launcher CLI of the port.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \\
        [--reduced] [--steps 20] [--ckpt DIR] [--monitor] [--device cuda]

Runs the fault-tolerant trainer on one device: ``--device`` defaults to
the CUDA card, ``--device cpu`` runs the plain PyTorch path.
Restart-safe: re-running the same command resumes from the latest
checkpoint.  ``--monitor`` adds the monitor with the JAX CLI's
`SimClock` (four devices, no contention).  The JAX CLI's
``--production-mesh`` waits for the multi-card slice.
"""

from __future__ import annotations

import argparse
import os
import tempfile

import torch

from repro_torch.configs.base import ShapeSpec, get_config, reduced_config
from repro_torch.data.pipeline import DataConfig
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
    tr = Trainer(cfg, shape, hyper,
                 TrainerConfig(ckpt_dir=args.ckpt,
                               ckpt_every=args.ckpt_every,
                               data=DataConfig(seed=args.seed)),
                 monitor=monitor, device=torch.device(args.device))
    log = tr.run(args.steps, seed=args.seed)
    for r in log[-5:]:
        print(f"step {r['step']} loss {r['loss']:.4f} "
              f"({r['wall_s']:.2f}s)")
    return log


if __name__ == "__main__":
    main()
