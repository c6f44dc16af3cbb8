"""The analytic cost model against the JAX package on the CPU:
`launch.roofline` (parameter and cache counts, the model FLOPs, every
field of `analytic_costs` over the ten configs, the four shapes, 256 and
512 chips, 1 and 4 microbatches and both remats), `roofline_terms` with
the card's constants, and `configs.base`'s shapes, properties and
`input_specs`.  Every number is a Python float or int computed in the JAX
order, so parity is exact (``==``).

The port's counterpart of the XLA cost-analysis check
(tests/test_roofline.py::test_analytic_flops_vs_cost_analysis_depth1):
`torch.utils.flop_counter.FlopCounterMode` over the port's `lm.loss_fn`
on "meta" tensors at depth 1 and full width, within that test's window
(0.5-2.0) of the analytic count.
"""

import dataclasses
import math

import jax.numpy as jnp
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro.configs import base as jbase
from repro.launch import mesh as jmesh
from repro.launch import roofline as jrl
from repro_torch.configs import base as tbase
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import roofline as trl
from repro_torch.models import lm

ARCHS = jbase.ARCH_IDS


def _cfgs(arch):
    return jbase.get_config(arch), tbase.get_config(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_counts_equal_jax(arch):
    jc, tc = _cfgs(arch)
    for padded in (True, False):
        assert trl.count_params(tc, padded) == \
            jrl.count_params(jc, padded)
    assert trl.active_params(tc) == jrl.active_params(jc)
    assert trl.model_flops_per_token(tc) == jrl.model_flops_per_token(jc)
    for B, S in ((2, 2048), (128, 32768)):
        assert trl.cache_bytes(tc, B, S) == jrl.cache_bytes(jc, B, S)


@pytest.mark.parametrize("arch", ARCHS)
def test_analytic_costs_equal_jax(arch):
    jc, tc = _cfgs(arch)
    n = 0
    for shape in jbase.SHAPES:
        tshape = tbase.SHAPE_BY_NAME[shape.name]
        for n_chips in (256, 512):
            for mb in (1, 4):
                for remat in ("full", "none"):
                    got = trl.analytic_costs(tc, tshape, n_chips, mb, remat)
                    want = jrl.analytic_costs(jc, shape, n_chips, mb, remat)
                    assert dataclasses.asdict(got) == \
                        dataclasses.asdict(want), (shape.name, n_chips, mb,
                                                   remat)
                    n += 1
    assert n == 32


def test_analytic_costs_below_tp_divides_by_zero_as_jax():
    """Fewer chips than the model axis and no ``dp_shards``: no data
    shards, so both packages divide by zero."""
    jc, tc = _cfgs("qwen1p5_0p5b")
    shape = jbase.SHAPE_BY_NAME["train_4k"]
    with pytest.raises(ZeroDivisionError):
        jrl.analytic_costs(jc, shape, 8)
    with pytest.raises(ZeroDivisionError):
        trl.analytic_costs(tc, tbase.SHAPE_BY_NAME["train_4k"], 8)


def _terms(flops, hbm, coll, model, peak, bw, link):
    compute, memory, collective = flops / peak, hbm / bw, coll / link
    bound = max(compute, memory, collective)
    return {"compute_s": compute, "memory_s": memory,
            "collective_s": collective,
            "dominant": ("compute_s", "memory_s", "collective_s")[
                [compute, memory, collective].index(bound)],
            "step_lower_bound_s": bound,
            "roofline_fraction": (model / peak) / bound if bound > 0 else 0.0}


# tests/test_roofline.py::test_roofline_terms_fraction's inputs, and a zero
@pytest.mark.parametrize("inputs", [(1e12, 1e9, 1e8, 5e11),
                                    (1e12, 1e9, 1e10, 5e11),
                                    (2e11, 9e10, 1e6, None),
                                    (0.0, 0.0, 0.0, None)])
def test_roofline_terms_use_the_cards_constants(inputs):
    flops, hbm, coll, model = inputs
    useful = flops if model is None else model
    assert trl.roofline_terms(flops, hbm, coll, model_flops_dev=model) == \
        _terms(flops, hbm, coll, useful, tmesh.PEAK_FLOPS_BF16,
               tmesh.HBM_BW, tmesh.ICI_BW_PER_LINK)
    # the same formula with the TPU's constants is the JAX function
    assert jrl.roofline_terms(flops, hbm, coll, model_flops_dev=model) == \
        _terms(flops, hbm, coll, useful, jmesh.PEAK_FLOPS_BF16,
               jmesh.HBM_BW, jmesh.ICI_BW_PER_LINK)


def test_the_cards_constants():
    """An H100 SXM5: 989 TFLOP/s dense bf16, 80 GiB of HBM3 at 3.35 TB/s
    (none of them the TPU's)."""
    assert tmesh.PEAK_FLOPS_BF16 == 989e12
    assert tmesh.HBM_BYTES == 80 * (1 << 30)
    assert tmesh.HBM_BW == 3.35e12
    assert (tmesh.PEAK_FLOPS_BF16, tmesh.HBM_BYTES) != \
        (jmesh.PEAK_FLOPS_BF16, jmesh.HBM_BYTES)


# tests/test_roofline.py:60-75's cases: parameter counts in the advertised
# ballpark and the model FLOPs twice the count (dense), the MoE's active
# parameters below a third of its total and about 2.7 B
BALLPARK = {"qwen2p5_14b": 14e9, "yi_6b": 6e9, "mamba2_2p7b": 2.7e9,
            "qwen2_moe_a2p7b": None}


@pytest.mark.parametrize("arch", sorted(BALLPARK))
def test_ballpark_cases(arch):
    cfg = tbase.get_config(arch)
    n = trl.count_params(cfg, padded=False)
    expected = BALLPARK[arch]
    if expected is None:
        assert trl.active_params(cfg) < 0.35 * n
        assert 1.8e9 < trl.active_params(cfg) < 4e9
        return
    assert 0.7 * expected < n < 1.4 * expected, (arch, n)
    assert trl.model_flops_per_token(cfg) == pytest.approx(2 * n)


def test_shapes_and_properties_equal_jax():
    assert list(tbase.SHAPE_BY_NAME) == list(jbase.SHAPE_BY_NAME)
    for name, s in jbase.SHAPE_BY_NAME.items():
        assert dataclasses.asdict(tbase.SHAPE_BY_NAME[name]) == \
            dataclasses.asdict(s)
    for arch in ARCHS:
        jc, tc = _cfgs(arch)
        for prop in ("kv_sharded", "sharding_overrides", "subquadratic"):
            assert getattr(tc, prop) == getattr(jc, prop), (arch, prop)
        # force_kv_replicate turns the KV sharding off in both
        assert dataclasses.replace(tc, force_kv_replicate=True)\
            .sharding_overrides == dataclasses.replace(
                jc, force_kv_replicate=True).sharding_overrides


DTYPES = {jnp.int32: torch.int32, jnp.bfloat16: torch.bfloat16}


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_equal_jax(arch):
    jc, tc = _cfgs(arch)
    for shape in jbase.SHAPES:
        got = tbase.input_specs(tc, tbase.SHAPE_BY_NAME[shape.name])
        want = jbase.input_specs(jc, shape)
        assert list(got) == list(want), (shape.name, list(got))
        for k, v in want.items():
            assert got[k].device.type == "meta"
            assert tuple(got[k].shape) == v.shape, (shape.name, k)
            assert got[k].dtype == DTYPES[jnp.dtype(v.dtype).type], k


# -- the program's own count: FlopCounterMode over lm.loss_fn ---------------------

def _depth1(arch):
    cfg = tbase.get_config(arch)
    # the hybrid's one group: hybrid_every mamba layers and one shared block
    return dataclasses.replace(cfg, n_layers=cfg.hybrid_every or 1)


def _counted_flops(cfg, B, S):
    params = lm.abstract_params(cfg)
    tokens = torch.zeros((B, S), dtype=torch.int32, device="meta")
    batch = {"tokens": tokens, "targets": tokens}
    with FlopCounterMode(display=False) as fc:
        lm.loss_fn(cfg, params, batch, compute_dtype=torch.float32,
                   impl="ref", remat="none")
    return fc.get_total_flops()


# depth 1, 2 x 512 tokens in f32: the ratio counted / analytic, which
# PERF.md records.  The MoE's is the lowest: the analytic model's GShard
# dispatch and combine einsums run on every device of the model axis, so
# the per-device count x 16 holds them 16 times (3.44e11 FLOPs here), where
# one device runs them once (2.15e10)
FLOP_RATIOS = {"qwen1p5_0p5b": 1.0031, "zamba2_2p7b": 0.9967,
               "qwen2_moe_a2p7b": 0.7258}


@pytest.mark.parametrize("arch", sorted(FLOP_RATIOS))
def test_counted_flops_within_the_window_of_analytic(arch):
    cfg = _depth1(arch)
    B, S = 2, 512
    counted = _counted_flops(cfg, B, S)
    shape = tbase.ShapeSpec("p", S, B, "prefill")
    analytic = trl.analytic_costs(cfg, shape, 16, dp_shards=1)\
        .flops_per_device * 16
    assert analytic == jrl.analytic_costs(
        dataclasses.replace(jbase.get_config(arch), n_layers=cfg.n_layers),
        jbase.ShapeSpec("p", S, B, "prefill"), 16,
        dp_shards=1).flops_per_device * 16
    ratio = counted / analytic
    assert 0.5 < ratio < 2.0, ratio
    assert math.isclose(ratio, FLOP_RATIOS[arch], abs_tol=5e-4), ratio
