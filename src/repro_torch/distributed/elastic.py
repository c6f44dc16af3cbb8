"""Elastic scaling: restore checkpointed state onto a different mesh.  The
port of `repro.distributed.elastic`.

Because checkpoints are mesh-agnostic (full logical arrays, see
checkpoint/ckpt.py) and shardings are derived from parameter *paths*,
scaling from N to M cards is: build the target mesh, derive the target
placements, restore against them.  A failed-pod restart is the same
operation with the surviving single-pod mesh.

`replan_batch` keeps the global batch size constant across mesh changes by
re-splitting microbatches (gradient-accumulation count absorbs the change
in data-parallel ways), so training curves are unaffected by elasticity.
"""

from __future__ import annotations

from repro_torch.checkpoint import ckpt
from repro_torch.configs.base import ArchConfig
from repro_torch.distributed import sharding as shd
from repro_torch.train import train_step as ts

__all__ = ["replan_batch", "restore_on_mesh"]


def replan_batch(global_batch: int, old_dp: int, new_dp: int,
                 old_microbatches: int) -> int:
    """New grad-accum count that keeps global batch identical."""
    per_step = global_batch // old_dp // old_microbatches  # per-device mb
    if per_step < 1:     # the JAX function's assert, kept under -O
        raise AssertionError(f"global_batch={global_batch} gives no row a "
                             f"microbatch over dp={old_dp} x "
                             f"{old_microbatches}")
    new_mb = max(1, global_batch // new_dp // per_step)
    # exactness check: global must factor
    while new_dp * new_mb * per_step != global_batch and new_mb > 1:
        new_mb -= 1
    if new_dp * new_mb * per_step != global_batch:
        raise ValueError(
            f"global_batch={global_batch} does not factor over dp={new_dp}")
    return new_mb


def restore_on_mesh(ckpt_dir: str, step: int, cfg: ArchConfig,
                    hyper: ts.TrainHyper, mesh) -> ts.TrainState:
    """Cross-mesh (elastic) restore of a TrainState checkpoint: every rank
    reads the full leaves onto its own device of the mesh's type and keeps
    the shard `ts.state_shardings` names for its coordinates, as a
    ``DTensor`` on ``mesh`` (a ``DeviceMesh`` over the running group)."""
    astate = ts.abstract_train_state(cfg, hyper)
    shard = ts.state_shardings(cfg, mesh, astate)
    full = ckpt.restore(ckpt_dir, step, astate, ts._mesh_device(mesh))
    return shd.distribute_tree(full, mesh, shard)
