"""Fault-tolerant training loop on one card.  The port of
`repro.train.trainer`.

Wires together: the data pipeline (stateless-resumable), the train step,
async checkpointing, the CacheX monitor (probe between steps — the
paper's pause-the-world window becomes the step boundary), the straggler
mitigator, and restart-from-latest semantics.

The loop is restart-oriented: `Trainer.run()` can be killed at any step
and re-invoked; it resumes from the latest complete checkpoint with an
identical data stream (batches are a pure function of (seed, step)).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import torch

import repro_torch
from repro_torch.checkpoint import ckpt
from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.data.pipeline import DataConfig, make_batch
from repro_torch.distributed.rebalance import StragglerMitigator
from repro_torch.tpuprobe.monitor import PodMonitor
from repro_torch.train import train_step as ts

__all__ = ["TrainerConfig", "Trainer"]


@dataclasses.dataclass
class TrainerConfig:
    ckpt_dir: str
    ckpt_every: int = 50
    keep: int = 3
    monitor_every: int = 1
    data: DataConfig = dataclasses.field(default_factory=DataConfig)


class Trainer:
    """``device`` None means the card.  One card: the mitigator plans
    ``hyper.microbatches`` microbatches over one device (the JAX trainer's
    data axis has one device here)."""

    def __init__(self, cfg: ArchConfig, shape: ShapeSpec,
                 hyper: ts.TrainHyper, tcfg: TrainerConfig,
                 monitor: Optional[PodMonitor] = None, device=None):
        self.cfg, self.shape = cfg, shape
        self.hyper, self.tcfg = hyper, tcfg
        self.monitor = monitor
        self.device = repro_torch.resolve_device(device)
        self.mitigator = StragglerMitigator(
            n_devices=1, total_microbatches=hyper.microbatches)
        self.checkpointer = ckpt.AsyncCheckpointer(tcfg.ckpt_dir,
                                                   keep=tcfg.keep)
        self.metrics_log: List[Dict] = []
        self._step = ts.build_train_step(cfg, hyper)

    # -- state management -------------------------------------------------------
    def init_or_restore(self, seed: int = 0):
        latest = ckpt.latest_step(self.tcfg.ckpt_dir)
        if latest is not None:
            abstract = ts.abstract_train_state(self.cfg, self.hyper,
                                               self.device)
            return ckpt.restore(self.tcfg.ckpt_dir, latest, abstract,
                                self.device), latest
        gen = torch.Generator(device=self.device).manual_seed(seed)
        return ts.make_train_state(self.cfg, self.hyper, gen,
                                   self.device), 0

    def _device_batch(self, step: int):
        """The step's batch on the device: every entry of the family's
        batch, the frame and patch embeddings cast to bf16 as the JAX
        trainer casts them."""
        host = make_batch(self.tcfg.data, self.cfg, self.shape, step)
        return {k: torch.as_tensor(v, device=self.device,
                                   dtype=(torch.bfloat16
                                          if k in ("frames", "patch_embeds")
                                          else None))
                for k, v in host.items()}

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- the loop -----------------------------------------------------------------
    def run(self, n_steps: int, seed: int = 0) -> List[Dict]:
        state, start = self.init_or_restore(seed)
        for step in range(start, n_steps):
            batch = self._device_batch(step)
            t0 = time.perf_counter()
            state, metrics = self._step(state, batch)
            self._sync()          # the step's time, not its enqueue time
            rec = {"step": step + 1, "loss": float(metrics["loss"]),
                   "grad_norm": float(metrics["grad_norm"]),
                   "lr": float(metrics["lr"]),
                   "wall_s": time.perf_counter() - t0}
            # CacheX monitoring between steps (probe window)
            if self.monitor and (step % self.tcfg.monitor_every == 0):
                self.monitor.probe_once()
                plan = self.mitigator.update(
                    self.monitor.per_device_slowdown()[
                        :self.mitigator.n_devices])
                rec["mb_plan"] = plan.tolist()
            self.metrics_log.append(rec)
            if (step + 1) % self.tcfg.ckpt_every == 0 or \
                    step + 1 == n_steps:
                self.checkpointer.save_async(step + 1, state)
        self.checkpointer.wait()
        return self.metrics_log
