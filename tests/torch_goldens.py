"""Golden reports the PyTorch port is held to, written by the JAX package.

Run from the repository root, in a process of its own (the JAX package
on the CPU; the process-wide shape, tune and shard caches start empty
before each golden):

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/torch_goldens.py \\
        [--out DIR] [name ...]

With no names it writes every golden into ``tests/data`` (or ``DIR``) as
``torch_golden_<name>.json``.  Each report golden holds every report field
but ``wall_s`` and ``guests_per_sec``.  The goldens:

  run_cachex_<platform>        ``run_cachex(platform)``, all six platforms
  run_cachex_skylake_sp_tuned  ``run_cachex("skylake_sp", tune=True)``
                               (the model-only tuner, under the JAX cost
                               constants)
  fleet_matrix                 ``run_fleet_matrix()`` at its defaults: six
                               platforms x ``DEFAULT_COMBOS``, seed 0,
                               lockstep
  fleet_attack                 ``FleetSim("skylake_sp", attack=True,
                               with_poisoner=False, n_intervals=18).run()``
  tune                         model-only ``tune_lowering`` (synthetic plan,
                               1, 4 and 8 guests) and ``choose_shard`` (8,
                               64 and 256 guests) on every platform, under
                               the JAX cost constants
  sharded_steps                JAX's sharded steps on a (2, 2) ("data",
                               "model") mesh with ``Auto`` axes, in a
                               process of its own with four host
                               devices: ``jit_train_step`` losses, grad
                               norms and ``parse_collectives(...).by_kind``
                               for each `SHARDED_CASES` case (1
                               microbatch of 2 rows; 2 of 2 with
                               ``sequence_parallel``), and
                               ``jit_prefill``'s logits sums (4 rows)
  sharded_variants             the same mesh and process for each
                               `SHARDED_VARIANTS` case: the train step's
                               loss, grad norm and collectives by kind,
                               or the prefill's logits sums and the
                               decode steps' logits sums
  dryrun                       the JAX dry run and hillclimb driver, in a
                               process of their own with 512 host devices
                               and ``make_production_mesh`` replaced by an
                               ``Auto``-axes mesh in their namespaces
                               (`golden_dryrun`): ``skip_reason``,
                               ``default_microbatches`` and ``hyper_for``
                               over every arch, shape, mesh and variant;
                               ``compile_cell`` records of `DRYRUN_CELLS`
                               (reduced) and `DRYRUN_FULL` (full width);
                               ``run_cell`` of `DRYRUN_SKIPS`;
                               ``hillclimb.run`` of `HILLCLIMB_ROWS`
                               (reduced) and `HILLCLIMB_FULL` (full
                               width), with each compiled step's memory
                               analysis
  pod_loop                     the pod backend's closed loop:
                               ``run_pod_loop("on")`` and ``("off")`` at
                               seed 0, ``PodFleetSim(intervals=12,
                               warmup=6).run()``, and the ``export()`` of
                               ``PodSession.attach(SimPod().slice(),
                               eager=True)``

`tests/test_torch_fleet.py::test_goldens_are_current` (slow) reruns this
script into a scratch directory and compares every file.

The golden format (`report_fields`) and the comparison of a fleet report
with its golden (`fleet_mismatches`) are defined here once, for the CPU
tests and for ``chip_smoke.py``'s card run.  The module imports the JAX
package only inside the functions that write goldens.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

DATA = Path(__file__).resolve().parent / "data"
WALL_FIELDS = ("wall_s", "guests_per_sec")
# The fleet report fields that pass through `fleet_interval_progress`'s f32
# sums are held at tests/test_fleet.py:52's rel 1e-5 (torch and XLA may
# sum in another order); every other field exactly, but `WALL_FIELDS`.
FLEET_FLOAT_FIELDS = ("throughput", "per_workload", "serve_p50_ms",
                      "serve_p99_ms")
FLEET_RTOL = 1e-5
# the sharded-step cases: (arch, moe dispatch), each run at (microbatches,
# sequence_parallel) in SHARDED_STEPS with f32 compute and no remat, from
# `make_train_state(PRNGKey(0))` and `make_batch(DataConfig(seed=1), step
# 0)` at SHARDED_SHAPE (seq, batch); a step of nm microbatches takes the
# batch's first `nm * SHARDED_MICRO` rows, so both steps run microbatches
# of one shape (one compiled reference, one DTensor rule cache)
SHARDED_CASES = (("qwen1p5_0p5b", "gshard"), ("qwen2_moe_a2p7b", "gshard"),
                 ("qwen2_moe_a2p7b", "sorted"), ("zamba2_2p7b", "gshard"))
SHARDED_STEPS = ((1, False), (2, True))
SHARDED_SHAPE = (16, 4)
# the decode steps the sharded cases take from empty caches, token i of
# the batch's rows at position i
SHARDED_DECODE_STEPS = 2
SHARDED_MICRO = 2
# The hillclimb variants that change the sharded step's function or its
# placements, each on the same (2, 2) mesh from its own config's
# `sharded_inputs` (f32, no remat but where named): (arch, variant, what
# runs).  "dots_remat": the train step (1 microbatch) under remat "dots";
# "moegroup": the train step with the MoE routed in groups of
# `SHARDED_GROUP` tokens, shorter than the sequence, so `moe_block`'s group
# reshape runs; "replparams": the prefill and `SHARDED_DECODE_STEPS` "dus"
# decode steps with the parameters replicated over "data"; "kvrep": the
# decode steps on the 16-kv-head config (`KV16`) with its kv heads
# replicated over "model" (``force_kv_replicate``).
SHARDED_VARIANTS = (("qwen1p5_0p5b", "dots_remat", "train"),
                    ("qwen2_moe_a2p7b", "moegroup", "train"),
                    ("qwen1p5_0p5b", "replparams", "serve"),
                    ("zamba2_2p7b", "replparams", "serve"),
                    ("qwen1p5_0p5b", "kvrep", "decode"))
SHARDED_GROUP = 8
# 16 query and 16 kv heads: as many kv heads as `TP_DEGREE`, so that
# ``force_kv_replicate`` changes their placement (at 4 it changes nothing)
KV16 = (("n_heads", 16), ("n_kv_heads", 16))


def sharded_variant_config(cfg, variant: str):
    """Either package's reduced ``cfg`` as a `SHARDED_VARIANTS` case
    changes it (the configs are dataclasses with the same fields)."""
    if variant == "moegroup":
        return dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, group_size=SHARDED_GROUP))
    if variant == "kvrep":
        return dataclasses.replace(cfg, force_kv_replicate=True,
                                   **dict(KV16))
    return cfg


def sharded_rows(data: dict, nm: int) -> dict:
    """The rows of ``data`` a step of ``nm`` microbatches takes."""
    return {k: v[:nm * SHARDED_MICRO] for k, v in data.items()}
# The dry run's reduced cells: (arch, (shape name, seq, batch, kind),
# multi_pod, microbatches, moe dispatch), each on `reduced_config(arch,
# d_model=DRYRUN_D_MODEL.get(arch, 128))`; train cells with TrainHyper(
# microbatches, compress_cross_pod=multi_pod, moe_impl).  Reduced zamba2
# takes d_model 256 for 16 SSM heads: XLA refuses to split its 8 heads at
# d_model 128 over the 16 "model" devices; reduced pixtral-12b takes
# d_model 160, where its d_ff (2.8 x d_model) is a multiple of 16 (358 at
# d_model 128 is not).  The single-pod train shape gives the hillclimb's
# default 2 microbatches the dry run's rows (so its baseline repeats the
# dry run's ops); the 2 x 16 x 16 mesh needs twice the batch for 2
# microbatches.  The full-width cells: (arch, shape name, multi_pod,
# microbatches, moe dispatch), None for `compile_cell`'s default (8 for
# train_4k, 16 for the moe family); `chip_smoke.py` runs the train cells
# at 2 microbatches, a quarter of the host time of 8, and holds their
# argument bytes (which the microbatches do not change) to both.
DRYRUN_TRAIN = ("dry_train", 64, 32, "train")
DRYRUN_PREFILL = ("dry_prefill", 64, 32, "prefill")
DRYRUN_CELLS = (("qwen1p5_0p5b", DRYRUN_TRAIN, False, 2, "gshard"),
                ("qwen1p5_0p5b", ("dry_train_pods", 64, 64, "train"), True,
                 2, "gshard"),
                ("qwen1p5_0p5b", DRYRUN_PREFILL, False, 1, "gshard"),
                ("qwen1p5_0p5b", ("dry_decode", 64, 32, "decode"), False, 1,
                 "gshard"),
                ("qwen2_moe_a2p7b", DRYRUN_TRAIN, False, 1, "gshard"),
                ("zamba2_2p7b", DRYRUN_PREFILL, False, 1, "gshard"),
                ("qwen2_moe_a2p7b", DRYRUN_TRAIN, False, 1, "sorted"),
                ("llama4_scout_17b_a16e", DRYRUN_TRAIN, False, 1, "gshard"),
                ("hubert_xlarge", DRYRUN_TRAIN, False, 2, "gshard"),
                ("pixtral_12b", DRYRUN_PREFILL, False, 1, "gshard"))
DRYRUN_D_MODEL = {"zamba2_2p7b": 256, "pixtral_12b": 160}
DRYRUN_FULL = (("qwen2.5-14b", "train_4k", False, None, "gshard"),
               ("qwen2.5-14b", "train_4k", True, None, "gshard"),
               ("qwen2.5-14b", "train_4k", False, 2, "gshard"),
               ("qwen2.5-14b", "train_4k", True, 2, "gshard"),
               ("qwen2.5-14b", "decode_32k", False, None, "gshard"),
               ("zamba2-2.7b", "prefill_32k", False, None, "gshard"),
               ("qwen2-moe-a2.7b", "train_4k", False, None, "gshard"),
               ("qwen2-moe-a2.7b", "train_4k", False, 2, "gshard"),
               ("qwen2-moe-a2.7b", "train_4k", False, None, "sorted"),
               ("qwen2-moe-a2.7b", "train_4k", False, 2, "sorted"),
               ("llama4-scout-17b-a16e", "train_4k", False, None, "gshard"),
               ("llama4-scout-17b-a16e", "train_4k", False, 2, "gshard"),
               ("hubert-xlarge", "prefill_32k", False, None, "gshard"),
               ("pixtral-12b", "prefill_32k", False, None, "gshard"))
# The hillclimb's variants, each on the cell it changes, single pod.
# Reduced (`HILLCLIMB_ROWS`): (variant, arch, shape spec, config fields
# replaced), each on `reduced_config(arch, d_model=DRYRUN_D_MODEL.get(arch,
# 128))` with those fields; the train variants at DRYRUN_TRAIN but
# "moegroup", whose group of 512 tokens must be shorter than the sequence
# (DRYRUN_TRAIN_GROUP), and "mb4", whose 4 microbatches need 4 rows a data
# rank (DRYRUN_TRAIN_B64; the port refuses a microbatch of less than a row
# a rank, XLA pads it); "kvrep" on 16 kv heads (`KV16`).  Full width
# (`HILLCLIMB_FULL`, what `tools/hillclimb_variants.py` runs on the card):
# (variant, arch, shape name); "+mb2" keeps a train step's host time at
# path (ix)'s, but "dots_remat" runs at the dry run's default 8: at 2 the
# saved products outgrow the card (XLA's step needs 180.01 GiB a device
# there, 47.24 at 8).  "kvrep" runs qwen1.5-0.5b, whose 16 kv heads it
# moves from split over "model" to replicated: qwen1.5-4b's 20 kv heads,
# replicated, cannot serve its 32 padded query heads (JAX's decode fails
# to trace, a (B, 1, 32, D) query grouped as 20 x 1).  The golden holds
# JAX's ``hillclimb.run`` record of each row under `hillclimb_row_name`
# ("hillclimb", "hillclimb_full") and its compiled step's memory analysis
# ("hillclimb_memory").
DRYRUN_DECODE = ("dry_decode", 64, 32, "decode")
DRYRUN_TRAIN_GROUP = ("dry_train_group", 1024, 32, "train")
DRYRUN_TRAIN_B64 = ("dry_train_b64", 64, 64, "train")
HILLCLIMB_ROWS = (
    ("baseline", "qwen1p5_0p5b", DRYRUN_TRAIN, ()),
    ("seqpar", "qwen1p5_0p5b", DRYRUN_TRAIN, ()),
    ("bf16_cast+mb2", "qwen1p5_0p5b", DRYRUN_TRAIN, ()),
    ("seqpar+bf16+mb2", "qwen1p5_0p5b", DRYRUN_TRAIN, ()),
    ("dots_remat+mb2", "qwen1p5_0p5b", DRYRUN_TRAIN, ()),
    ("mb4", "qwen1p5_0p5b", DRYRUN_TRAIN_B64, ()),
    ("sorted_moe+mb2", "qwen2_moe_a2p7b", DRYRUN_TRAIN, ()),
    ("sorted_moe+bf16+mb2", "qwen2_moe_a2p7b", DRYRUN_TRAIN, ()),
    ("moegroup+mb2", "qwen2_moe_a2p7b", DRYRUN_TRAIN_GROUP, ()),
    ("cf1+mb2", "qwen2_moe_a2p7b", DRYRUN_TRAIN, ()),
    ("kvrep", "qwen1p5_0p5b", DRYRUN_DECODE, KV16),
    ("blend", "qwen1p5_0p5b", DRYRUN_DECODE, ()),
    ("replparams", "zamba2_2p7b", DRYRUN_PREFILL, ()),
    ("replparams", "qwen1p5_0p5b", DRYRUN_DECODE, ()))
HILLCLIMB_FULL = (("seqpar+mb2", "qwen2.5-14b", "train_4k"),
                  ("bf16_cast+mb2", "qwen2.5-14b", "train_4k"),
                  ("seqpar+bf16+mb2", "qwen2.5-14b", "train_4k"),
                  ("dots_remat", "qwen2.5-14b", "train_4k"),
                  ("mb4", "qwen2.5-14b", "train_4k"),
                  ("sorted_moe+mb2", "qwen2-moe-a2.7b", "train_4k"),
                  ("sorted_moe+bf16+mb2", "qwen2-moe-a2.7b", "train_4k"),
                  ("moegroup+mb2", "qwen2-moe-a2.7b", "train_4k"),
                  ("cf1+mb2", "qwen2-moe-a2.7b", "train_4k"),
                  ("kvrep", "qwen1.5-0.5b", "decode_32k"),
                  ("blend", "qwen2.5-14b", "decode_32k"),
                  ("replparams", "zamba2-2.7b", "prefill_32k"),
                  ("replparams", "qwen2.5-14b", "decode_32k"))
# cells the dry run skips: long_500k on a pure-attention arch, a decode
# on the encoder
DRYRUN_SKIPS = (("qwen2.5-14b", "long_500k", False),
                ("hubert-xlarge", "decode_32k", True))
# the TrainHyper fields `hyper_for` sets (the AdamW config and the compute
# dtype are each package's own objects)
HYPER_FIELDS = ("microbatches", "remat", "compress_cross_pod", "impl",
                "cast_params_once", "sequence_parallel", "moe_impl")


def dryrun_cell_name(arch: str, shape_name: str, multi_pod: bool,
                     microbatches=None, moe_impl: str = "gshard") -> str:
    mb = f"_mb{microbatches}" if microbatches else ""
    impl = "" if moe_impl == "gshard" else f"_{moe_impl}"
    return (f"{arch}_{shape_name}{mb}{impl}_"
            f"{'multi' if multi_pod else 'single'}")


def hillclimb_row_name(variant: str, arch: str, shape_name: str,
                      replaced=()) -> str:
    fields = "".join(f"_{k}{v}" for k, v in replaced)
    return f"{arch}{fields}_{shape_name}_{variant}"


def hillclimb_config(reduced_config, get_config, arch: str, replaced=()):
    """A reduced hillclimb row's config, built by either package's
    ``reduced_config`` and ``get_config``."""
    return dataclasses.replace(reduced_config(
        get_config(arch), d_model=DRYRUN_D_MODEL.get(arch, 128)),
        **dict(replaced))


SHARD_GUESTS = (8, 64, 256)
TUNE_GUESTS = (1, 4, 8)


def report_fields(report) -> dict:
    """A report as the goldens keep it: every field but the wall-clock
    ones, through JSON (dict keys become strings)."""
    d = dataclasses.asdict(report)
    for f in WALL_FIELDS:
        d.pop(f, None)
    return json.loads(json.dumps(d, sort_keys=True))


def fleet_mismatches(got: dict, want: dict) -> list:
    """The fields where fleet report ``got`` differs from ``want`` (both
    as `report_fields` gives them): `FLEET_FLOAT_FIELDS` beyond rel
    `FLEET_RTOL` of ``want``, any other field at all."""
    bad = []
    for k in sorted(set(got) | set(want)):
        g, w = got.get(k), want.get(k)
        if k in FLEET_FLOAT_FIELDS:
            gs, ws = (x if isinstance(x, dict) else {"": x} for x in (g, w))
            if gs.keys() != ws.keys() or any(
                    not abs(gs[i] - ws[i]) <= FLEET_RTOL * abs(ws[i])
                    for i in ws):
                bad.append(f"{k}: {g!r} != {w!r} (rel {FLEET_RTOL})")
        elif g != w:
            bad.append(f"{k}: {g!r} != {w!r}")
    return bad


def tune_fields(report) -> dict:
    """A TuneReport as the golden keeps it (``cached`` dropped)."""
    d = dataclasses.asdict(report)
    d.pop("cached")
    return json.loads(json.dumps(d, sort_keys=True))


def shard_fields(choice) -> dict:
    d = dataclasses.asdict(choice)
    d.pop("cached")
    return json.loads(json.dumps(d, sort_keys=True))


def _fresh_caches() -> None:
    from repro.core.fleetshard import clear_shard_cache
    from repro.core.plancost import SHAPE_CACHE, clear_tune_cache
    SHAPE_CACHE.clear()
    clear_tune_cache()
    clear_shard_cache()


def golden_run_cachex(platform: str, tune: bool = False) -> dict:
    from repro.core.runner import run_cachex
    return report_fields(run_cachex(platform, tune=tune))


def golden_fleet_matrix() -> list:
    from repro.core.fleet import run_fleet_matrix
    return [report_fields(r) for r in run_fleet_matrix()]


def golden_fleet_attack() -> dict:
    from repro.core.fleet import FleetSim
    return report_fields(FleetSim("skylake_sp", attack=True,
                                  with_poisoner=False, n_intervals=18).run())


def golden_tune() -> dict:
    from repro.core.fleetshard import choose_shard
    from repro.core.plancost import tune_lowering
    from repro.core.platforms import get_platform, list_platforms
    out = {}
    for name in list_platforms():
        plat = get_platform(name)
        row = {"tune": {}, "shard": {}}
        for n in TUNE_GUESTS:
            _fresh_caches()
            row["tune"][str(n)] = tune_fields(
                tune_lowering(plat, None, n_guests=n, measure=False))
        for n in SHARD_GUESTS:
            _fresh_caches()
            row["shard"][str(n)] = shard_fields(choose_shard(plat,
                                                             n_guests=n))
        out[name] = row
    return out


def golden_pod_loop() -> dict:
    from repro.tpuprobe.pod_backend import (PodFleetSim, PodSession, SimPod,
                                            run_pod_loop)
    export = PodSession.attach(SimPod().slice(), eager=True).export()
    return {"on": report_fields(run_pod_loop("on", seed=0)),
            "off": report_fields(run_pod_loop("off", seed=0)),
            "fleet_12_6": report_fields(PodFleetSim(intervals=12,
                                                    warmup=6).run()),
            "export": json.loads(json.dumps(export, sort_keys=True))}


def sharded_inputs(arch: str, variant: str = ""):
    """(JAX config, JAX train state, numpy batch) of a sharded-step case
    (a `SHARDED_VARIANTS` case with ``variant``), as the golden and the
    tests build them."""
    import jax
    from repro.configs.base import ShapeSpec, get_config, reduced_config
    from repro.data import pipeline
    from repro.train import train_step as jts
    cfg = sharded_variant_config(reduced_config(get_config(arch)), variant)
    state = jax.jit(lambda k: jts.make_train_state(cfg, jts.TrainHyper(),
                                                   k))(jax.random.PRNGKey(0))
    seq, batch = SHARDED_SHAPE
    data = pipeline.make_batch(pipeline.DataConfig(seed=1), cfg,
                               ShapeSpec("sharded", seq, batch, "train"), 0)
    return cfg, state, data


def _sharded_steps() -> dict:
    """The golden's content; needs four JAX devices (see
    `golden_sharded_steps`)."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import AxisType
    from repro.configs.base import ShapeSpec
    from repro.launch.roofline import parse_collectives
    from repro.train import train_step as jts
    mesh = jax.make_mesh((2, 2), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    seq, batch = SHARDED_SHAPE
    out = {}
    for arch, moe_impl in SHARDED_CASES:
        cfg, state, data = sharded_inputs(arch)
        # numpy, so that each step gets buffers of its own to donate
        state = jax.tree_util.tree_map(np.asarray, state)
        case = {}
        for nm, sp in SHARDED_STEPS:
            hyper = jts.TrainHyper(microbatches=nm, sequence_parallel=sp,
                                   remat="none", compute_dtype=jnp.float32,
                                   moe_impl=moe_impl)
            shape = ShapeSpec("sharded", seq, nm * SHARDED_MICRO, "train")
            step, _, st_shard, bshard = jts.jit_train_step(cfg, mesh, hyper,
                                                           shape)
            placed = jax.device_put(state, st_shard)
            b = {k: jax.device_put(v, bshard[k])
                 for k, v in sharded_rows(data, nm).items() if k in bshard}
            coll = parse_collectives(step.lower(placed, b).compile()
                                     .as_text())
            _, metrics = step(placed, b)
            case[f"nm{nm}_sp{int(sp)}"] = {
                "loss": float(metrics["loss"]),
                "grad_norm": float(metrics["grad_norm"]),
                "collectives_by_kind": coll.by_kind}
        prefill, _, (pshard, bshard) = jts.jit_prefill(
            cfg, mesh, ShapeSpec("sharded", seq, batch, "prefill"),
            jnp.float32, "ref")
        logits = np.asarray(prefill(
            jax.device_put(state.params, pshard),
            {"tokens": jax.device_put(data["tokens"], bshard["tokens"])}))
        case["prefill"] = {"logits_sum": float(logits.sum()),
                           "logits_abs_sum": float(np.abs(logits).sum())}
        if moe_impl == "gshard":   # the decode dispatches gshard
            case["decode_blend"] = _sharded_decode(cfg, mesh, state.params,
                                                   data, "blend")
        out[f"{arch}_{moe_impl}"] = case
    return out


def _sharded_variants() -> dict:
    """The ``sharded_variants`` golden's content; needs four JAX devices
    (see `golden_sharded_steps`)."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import AxisType
    from repro.configs.base import ShapeSpec
    from repro.launch.roofline import parse_collectives
    from repro.train import train_step as jts
    mesh = jax.make_mesh((2, 2), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    seq, batch = SHARDED_SHAPE
    out = {}
    for arch, variant, what in SHARDED_VARIANTS:
        cfg, state, data = sharded_inputs(arch, variant)
        state = jax.tree_util.tree_map(np.asarray, state)
        case = {}
        if what == "train":
            hyper = jts.TrainHyper(
                microbatches=1, compute_dtype=jnp.float32,
                remat="dots" if variant == "dots_remat" else "none")
            shape = ShapeSpec("sharded", seq, SHARDED_MICRO, "train")
            step, _, st_shard, bshard = jts.jit_train_step(cfg, mesh, hyper,
                                                           shape)
            placed = jax.device_put(state, st_shard)
            b = {k: jax.device_put(v, bshard[k])
                 for k, v in sharded_rows(data, 1).items() if k in bshard}
            coll = parse_collectives(step.lower(placed, b).compile()
                                     .as_text())
            _, metrics = step(placed, b)
            case["train"] = {"loss": float(metrics["loss"]),
                             "grad_norm": float(metrics["grad_norm"]),
                             "collectives_by_kind": coll.by_kind}
        if what == "serve":
            prefill, _, (pshard, bshard) = jts.jit_prefill(
                cfg, mesh, ShapeSpec("sharded", seq, batch, "prefill"),
                jnp.float32, "ref", replicate_params_over_data=True)
            logits = np.asarray(prefill(
                jax.device_put(state.params, pshard),
                {"tokens": jax.device_put(data["tokens"],
                                          bshard["tokens"])}))
            case["prefill"] = {"logits_sum": float(logits.sum()),
                               "logits_abs_sum": float(np.abs(logits).sum())}
        if what in ("serve", "decode"):
            case["decode"] = _sharded_decode(
                cfg, mesh, state.params, data, "dus",
                replicate_params_over_data=variant == "replparams")
        out[f"{arch}_{variant}"] = case
    return out


def _sharded_decode(cfg, mesh, params, data, cache_update: str,
                    replicate_params_over_data: bool = False) -> dict:
    """`SHARDED_DECODE_STEPS` of JAX's ``jit_decode_step`` on ``mesh``
    from empty caches (f32): each token's logits' sum and absolute sum."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from repro.configs.base import ShapeSpec
    from repro.models import lm
    from repro.train import train_step as jts
    seq, batch = SHARDED_SHAPE
    step, _, _, (pshard, cshard, bshard) = jts.jit_decode_step(
        cfg, mesh, ShapeSpec("sharded", seq, batch, "decode"), jnp.float32,
        cache_update=cache_update,
        replicate_params_over_data=replicate_params_over_data)
    placed = jax.device_put(params, pshard)
    caches = jax.device_put(lm.init_caches(cfg, batch, seq, jnp.float32),
                            cshard)
    sums, abs_sums = [], []
    for pos in range(SHARDED_DECODE_STEPS):
        tokens = jax.device_put(data["tokens"][:, pos:pos + 1],
                                bshard["tokens"])
        logits, caches = step(placed, caches, tokens,
                              jax.device_put(jnp.int32(pos), bshard["pos"]))
        logits = np.asarray(logits)
        sums.append(float(logits.sum()))
        abs_sums.append(float(np.abs(logits).sum()))
    return {"logits_sums": sums, "logits_abs_sums": abs_sums}


def golden_sharded_steps(child: str = "--sharded-child") -> dict:
    """Runs `_sharded_steps` (or with ``child`` "--sharded-variants-child"
    `_sharded_variants`) in a process of its own that sets
    ``XLA_FLAGS=--xla_force_host_platform_device_count=4`` before JAX is
    imported."""
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=4"}
    proc = subprocess.run([sys.executable, __file__, child],
                          env=env, capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(proc.stderr[-4000:])
    return json.loads(proc.stdout.splitlines()[-1])


def _auto_mesh(*, multi_pod: bool = False):
    """The production mesh with ``Auto`` axes (the JAX default,
    ``Explicit``, is refused by the step's ``with_sharding_constraint``
    calls; ROADMAP §3)."""
    import jax
    from jax.sharding import AxisType
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return jax.make_mesh(shape, axes, axis_types=(AxisType.Auto,) *
                         len(shape))


def _jsonable(x):
    return json.loads(json.dumps(x, default=float))


def _dryrun() -> dict:
    """The golden's content; needs 512 JAX devices (see
    `golden_dryrun`)."""
    from repro.configs.base import (ARCH_IDS, SHAPE_BY_NAME, SHAPES,
                                    ShapeSpec, get_config, reduced_config)
    from repro.launch import dryrun, hillclimb
    from repro.train import train_step as jts
    dryrun.make_production_mesh = _auto_mesh
    hillclimb.make_production_mesh = _auto_mesh
    out = {"skip_reason": {}, "default_microbatches": {}, "hyper_for": {},
           "cells": {}, "full": {}, "hillclimb": {}}
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        for shape in SHAPES:
            key = f"{arch}/{shape.name}"
            out["skip_reason"][key] = dryrun.skip_reason(cfg, shape)
            for mp in (False, True):
                mkey = f"{key}/{'multi' if mp else 'single'}"
                out["default_microbatches"][mkey] = \
                    dryrun.default_microbatches(cfg, shape, mp)
                for variant in hillclimb.VARIANTS:
                    h = hillclimb.hyper_for(variant, cfg, shape, mp)
                    out["hyper_for"][f"{mkey}/{variant}"] = {
                        f: getattr(h, f) for f in HYPER_FIELDS}
    for arch, spec, mp, nm, impl in DRYRUN_CELLS:
        cfg = reduced_config(get_config(arch),
                             d_model=DRYRUN_D_MODEL.get(arch, 128))
        shape = ShapeSpec(*spec)
        hyper = (jts.TrainHyper(microbatches=nm, compress_cross_pod=mp,
                                moe_impl=impl)
                 if shape.kind == "train" else None)
        rec = dryrun.compile_cell(cfg, shape, mp, hyper)
        rec["collectives"].pop("ops")
        out["cells"][dryrun_cell_name(arch, shape.name, mp, moe_impl=impl)] \
            = _jsonable(rec)
    for arch, shape_name, mp, nm, impl in DRYRUN_FULL:
        cfg, shape = get_config(arch), SHAPE_BY_NAME[shape_name]
        if nm is None and impl == "gshard":
            rec = dryrun.run_cell(arch, shape_name, mp)
        else:
            rec = dryrun.compile_cell(cfg, shape, mp, jts.TrainHyper(
                microbatches=nm or dryrun.default_microbatches(cfg, shape,
                                                               mp),
                compress_cross_pod=mp, moe_impl=impl))
        if rec["status"] != "ok":
            raise RuntimeError(f"{arch} {shape_name}: {rec}")
        rec["collectives"].pop("ops")
        out["full"][dryrun_cell_name(arch, shape_name, mp, nm, impl)] = \
            _jsonable(rec)
    out["skips"] = {dryrun_cell_name(arch, shape_name, mp):
                    dryrun.run_cell(arch, shape_name, mp)
                    for arch, shape_name, mp in DRYRUN_SKIPS}
    out["hillclimb_full"], out["hillclimb_memory"] = {}, {}
    for variant, arch, shape_name in HILLCLIMB_FULL:
        name = hillclimb_row_name(variant, arch, shape_name)
        out["hillclimb_full"][name], out["hillclimb_memory"][name] = \
            _hillclimb_row(hillclimb, arch, shape_name, variant)
    configs = hillclimb.get_config
    for variant, arch, spec, replaced in HILLCLIMB_ROWS:
        shape = ShapeSpec(*spec)
        cfg = hillclimb_config(reduced_config, configs, arch, replaced)
        hillclimb.get_config = lambda _, cfg=cfg: cfg
        hillclimb.SHAPE_BY_NAME = {**SHAPE_BY_NAME, shape.name: shape}
        name = hillclimb_row_name(variant, arch, shape.name, replaced)
        out["hillclimb"][name], out["hillclimb_memory"][name] = \
            _hillclimb_row(hillclimb, arch, shape.name, variant)
    return out


def _hillclimb_row(hillclimb, arch: str, shape_name: str, variant: str):
    """JAX's ``hillclimb.run`` record of a single-pod row and the memory
    analysis of the step it compiled (read where ``run`` reads it)."""
    import jax
    seen = []
    analysis = jax.stages.Compiled.memory_analysis

    def record(compiled):
        ma = analysis(compiled)
        seen.append(ma)
        return ma
    jax.stages.Compiled.memory_analysis = record
    try:
        rec = hillclimb.run(arch, shape_name, variant, False,
                            show_top=False)
    finally:
        jax.stages.Compiled.memory_analysis = analysis
    ma, = seen
    return _jsonable(rec), {
        "argument_bytes": int(ma.argument_size_in_bytes),
        "output_bytes": int(ma.output_size_in_bytes),
        "temp_bytes": int(ma.temp_size_in_bytes),
        "alias_bytes": int(ma.alias_size_in_bytes)}


def golden_dryrun() -> dict:
    """Runs `_dryrun` in a process of its own: importing the JAX dry run
    sets ``XLA_FLAGS`` to 512 host devices, which must precede JAX's
    first use."""
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    proc = subprocess.run([sys.executable, __file__, "--dryrun-child"],
                          env=env, capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(proc.stderr[-4000:])
    return json.loads(proc.stdout.splitlines()[-1])


def goldens() -> dict:
    """name -> thunk writing that golden's content."""
    from repro.core.platforms import list_platforms
    g = {f"run_cachex_{p}": (lambda p=p: golden_run_cachex(p))
         for p in list_platforms()}
    g["run_cachex_skylake_sp_tuned"] = lambda: golden_run_cachex(
        "skylake_sp", tune=True)
    g["fleet_matrix"] = golden_fleet_matrix
    g["fleet_attack"] = golden_fleet_attack
    g["tune"] = golden_tune
    g["pod_loop"] = golden_pod_loop
    g["sharded_steps"] = golden_sharded_steps
    g["sharded_variants"] = lambda: golden_sharded_steps(
        "--sharded-variants-child")
    g["dryrun"] = golden_dryrun
    return g


def path_of(name: str, out: Path = DATA) -> Path:
    return out / f"torch_golden_{name}.json"


def main(argv=None) -> int:
    if (argv if argv is not None else sys.argv[1:]) == ["--sharded-child"]:
        print(json.dumps(_sharded_steps(), sort_keys=True))
        return 0
    if (argv if argv is not None else sys.argv[1:]) == \
            ["--sharded-variants-child"]:
        print(json.dumps(_sharded_variants(), sort_keys=True))
        return 0
    if (argv if argv is not None else sys.argv[1:]) == ["--dryrun-child"]:
        print(json.dumps(_dryrun(), sort_keys=True))
        return 0
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", type=Path, default=DATA)
    ap.add_argument("names", nargs="*")
    args = ap.parse_args(argv)
    table = goldens()
    names = args.names or sorted(table)
    unknown = sorted(set(names) - set(table))
    if unknown:
        ap.error(f"unknown goldens {unknown}; known: {sorted(table)}")
    args.out.mkdir(parents=True, exist_ok=True)
    for name in names:
        _fresh_caches()
        content = table[name]()
        path_of(name, args.out).write_text(
            json.dumps(content, indent=1, sort_keys=True) + "\n")
        print(f"wrote {path_of(name, args.out)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
