"""`launch.roofline.count_collectives`, the port's counterpart of the JAX
module's HLO collective parser, on the CPU: its constants and
`CollectiveStats` against the JAX module's, a step without a mesh (no
collective), and the sharded train step on a gloo world of one rank (the
card's 1 x 1 mesh in miniature).  The count on four ranks, on the same
ranks as the sharded step, is `test_count_collectives_of_the_train_step_
on_four_ranks` in `tests/test_torch_sharded_step.py`.
"""

import dataclasses
import json

import pytest
import torch
import torch.distributed as dist

from repro.launch import roofline as jroofline
from repro_torch._tree import tree_flatten_with_path, tree_leaves
from repro_torch.configs import base as tbase
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import roofline
from repro_torch.train import train_step as ts
from tests.torch_goldens import DATA, SHARDED_CASES, path_of

SEQ, BATCH = 16, 4


def _inputs(arch="qwen1p5_0p5b", seed=0):
    cfg = tbase.reduced_config(tbase.get_config(arch))
    g = torch.Generator().manual_seed(seed + 1)
    batch = {k: torch.randint(0, cfg.vocab, (BATCH, SEQ), generator=g,
                              dtype=torch.int32)
             for k in ("tokens", "targets")}
    return cfg, batch


def test_constants_and_stats_fields_equal_jax():
    assert roofline.COLLECTIVES == jroofline.COLLECTIVES
    assert roofline.DTYPE_BYTES == jroofline.DTYPE_BYTES
    names = [f.name for f in dataclasses.fields(roofline.CollectiveStats)]
    jnames = [f.name for f in dataclasses.fields(jroofline.CollectiveStats)]
    assert names[:len(jnames)] == jnames


def test_count_collectives_of_a_plain_step_counts_nothing():
    """The step without a mesh on plain CPU tensors: no collective, and
    the same result as without the counter."""
    cfg, batch = _inputs()
    hyper = ts.TrainHyper(microbatches=2, remat="none",
                          compute_dtype=torch.float32)
    state = ts.make_train_state(cfg, hyper, 0, device="cpu")
    step = ts.build_train_step(cfg, hyper)
    (new, m), stats = roofline.count_collectives(step, state, batch)
    assert stats == roofline.CollectiveStats(
        total_bytes=0, by_kind={k: 0 for k in roofline.COLLECTIVES},
        by_group_size={}, ops=0, tpu_corrected_bytes=0, calls=[])
    new2, m2 = step(state, batch)
    assert float(m["loss"]) == float(m2["loss"])
    for a, b in zip(tree_leaves(new), tree_leaves(new2)):
        assert torch.equal(a, b)


@pytest.fixture
def gloo_world_of_one(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    yield
    dist.destroy_process_group()


@pytest.mark.parametrize("nm,sp", [(1, False), (2, True)])
def test_sharded_step_on_a_world_of_one_moves_no_byte(gloo_world_of_one,
                                                      nm, sp):
    """`jit_train_step` on a 1 x 1 mesh (what the card runs): the same loss,
    grad norm and state as the step without a mesh, bit for bit, every
    leaf a DTensor with `state_shardings`' placements, and no byte moved
    (a mesh of one rank splits nothing: every placement is `Replicate`)."""
    cfg, batch = _inputs()
    mesh = tmesh.make_host_mesh()
    hyper = ts.TrainHyper(microbatches=nm, sequence_parallel=sp,
                          remat="none", compute_dtype=torch.float32)
    state = ts.make_train_state(cfg, hyper, 0, device="cpu")
    step, _, st_shard, bshard = ts.jit_train_step(
        cfg, mesh, hyper, tbase.ShapeSpec("s", SEQ, BATCH, "train"))
    (new, m), stats = roofline.count_collectives(step, state, batch)
    assert stats.total_bytes == 0, stats.calls
    want, wm = ts.build_train_step(cfg, hyper)(state, batch)
    assert float(m["loss"]) == float(wm["loss"])
    assert float(m["grad_norm"]) == float(wm["grad_norm"])
    placed = dict(tree_flatten_with_path(st_shard))
    for (path, got), ref in zip(tree_flatten_with_path(new),
                                tree_leaves(want)):
        assert type(got).__name__ == "DTensor", path
        assert list(got.placements) == list(placed[path]), path
        assert torch.equal(got.full_tensor(), ref), path
    assert sorted(bshard) == ["targets", "tokens"]


def test_golden_holds_jax_collectives_for_every_case():
    """The ``sharded_steps`` golden keeps JAX's ``parse_collectives``
    bytes by kind beside its losses, for every case (information beside
    the port's count: XLA and DTensor choose different collectives)."""
    golden = json.loads(path_of("sharded_steps", DATA).read_text())
    assert sorted(golden) == sorted(f"{a}_{m}" for a, m in SHARDED_CASES)
    for case in golden.values():
        for k, v in case.items():
            if k in ("prefill", "decode_blend"):   # not train steps
                continue
            assert sorted(v["collectives_by_kind"]) == sorted(
                jroofline.COLLECTIVES)
            assert v["collectives_by_kind"]["all-gather"] > 0
