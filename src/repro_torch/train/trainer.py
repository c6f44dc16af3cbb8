"""Fault-tolerant training loop, on one card or on a mesh.  The port of
`repro.train.trainer`.

Wires together: the data pipeline (stateless-resumable), the train step,
async checkpointing, the CacheX monitor (probe between steps — the
paper's pause-the-world window becomes the step boundary), the straggler
mitigator, and restart-from-latest semantics.

The loop is restart-oriented: `Trainer.run()` can be killed at any step
and re-invoked; it resumes from the latest complete checkpoint with an
identical data stream (batches are a pure function of (seed, step)).

With a ``mesh`` (a `torch.distributed` ``DeviceMesh`` over the running
group, one process a card) every rank runs the same loop:
`train_step.jit_train_step`'s step on DTensors, the fresh state placed
by `state_shardings`, a restore through `elastic.restore_on_mesh`.  A
checkpoint is the same mesh-agnostic full-tensor layout as on one card:
every rank gathers the state to full tensors (a collective), rank 0
writes them, and the others wait for the write at the end of the run.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import torch
import torch.distributed as dist

import repro_torch
from repro_torch.checkpoint import ckpt
from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.data.pipeline import DataConfig, make_batch
from repro_torch.distributed import elastic
from repro_torch.distributed import sharding as shd
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
    """``device`` None means the card.  Without a mesh the mitigator plans
    ``hyper.microbatches`` microbatches over one device; with one it
    counts the mesh's data ways as the JAX trainer does: ``size //
    model`` devices and ``microbatches * data`` microbatches, and the
    device is the mesh's."""

    def __init__(self, cfg: ArchConfig, shape: ShapeSpec,
                 hyper: ts.TrainHyper, tcfg: TrainerConfig,
                 monitor: Optional[PodMonitor] = None, device=None,
                 mesh=None):
        self.cfg, self.shape = cfg, shape
        self.hyper, self.tcfg = hyper, tcfg
        self.monitor = monitor
        self.mesh = mesh
        self.metrics_log: List[Dict] = []
        if mesh is None:
            self.device = repro_torch.resolve_device(device)
            n_dev, n_mb = 1, hyper.microbatches
            self._step = ts.build_train_step(cfg, hyper)
        else:
            sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
            self.device = ts._mesh_device(mesh)
            n_dev = mesh.size() // max(1, sizes.get("model", 1))
            n_mb = hyper.microbatches * max(1, sizes.get("data", 1))
            self._step, self._astate, self._st_shard, self._bshard = \
                ts.jit_train_step(cfg, mesh, hyper, shape)
        self.mitigator = StragglerMitigator(n_devices=n_dev,
                                            total_microbatches=n_mb)
        self.checkpointer = ckpt.AsyncCheckpointer(tcfg.ckpt_dir,
                                                   keep=tcfg.keep)

    # -- state management -------------------------------------------------------
    def init_or_restore(self, seed: int = 0):
        latest = ckpt.latest_step(self.tcfg.ckpt_dir)
        if latest is not None:
            if self.mesh is not None:
                return elastic.restore_on_mesh(
                    self.tcfg.ckpt_dir, latest, self.cfg, self.hyper,
                    self.mesh), latest
            abstract = ts.abstract_train_state(self.cfg, self.hyper,
                                               self.device)
            return ckpt.restore(self.tcfg.ckpt_dir, latest, abstract,
                                self.device), latest
        # every rank draws the same full state from the seed, then keeps
        # its own blocks
        gen = torch.Generator(device=self.device).manual_seed(seed)
        state = ts.make_train_state(self.cfg, self.hyper, gen, self.device)
        if self.mesh is not None:
            state = shd.distribute_tree(state, self.mesh, self._st_shard)
        return state, 0

    def _save(self, step: int, state) -> None:
        """Queue the checkpoint of ``step``: on a mesh, the state gathered
        to full tensors on every rank and written by rank 0."""
        if self.mesh is None:
            self.checkpointer.save_async(step, state)
            return
        full = shd.gather_tree(state)
        if dist.get_rank() == 0:
            self.checkpointer.save_async(step, full)

    def _wait(self) -> None:
        self.checkpointer.wait()
        if self.mesh is not None:
            dist.barrier()    # the others wait for rank 0's write

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
                self._save(step + 1, state)
        self._wait()
        return self.metrics_log
