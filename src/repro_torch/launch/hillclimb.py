"""Perf hillclimbing driver.  The port of `repro.launch.hillclimb`.

Runs one (arch x shape x mesh) cell's sharded step under a named
optimization variant as rank 0 of a fake 256- or 512-rank group (see
`launch.dryrun`) and reports the three roofline terms plus the top
collectives *with provenance*, the frame of the port's package that
issued each, so each hypothesis -> change -> measure iteration is grounded
in the step the ranks run rather than guesses.

    python -m repro_torch.launch.hillclimb --arch qwen2.5-14b \\
        --shape train_4k --variant baseline|bf16_cast|seqpar|seqpar+bf16 ...
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from collections import defaultdict

from repro_torch.configs.base import SHAPE_BY_NAME, ShapeSpec, get_config
from repro_torch.launch import roofline as rl
from repro_torch.launch.dryrun import _measure_cell, default_microbatches
# as JAX's module: its names are the port's
from repro_torch.launch.mesh import make_production_mesh  # noqa: F401
from repro_torch.train import train_step as ts

__all__ = ["VARIANTS", "hyper_for", "top_collectives", "run", "main"]

VARIANTS = ("baseline", "bf16_cast", "seqpar", "seqpar+bf16", "dots_remat",
            "sorted_moe", "sorted_moe+bf16", "kvrep", "mb4", "blend")

# HLO's names of the dtypes `top_collectives` prints
_HLO_DTYPE = {"float64": "f64", "float32": "f32", "float16": "f16",
              "bfloat16": "bf16", "int64": "s64", "int32": "s32",
              "int16": "s16", "int8": "s8", "uint8": "u8", "bool": "pred"}


def hyper_for(variant: str, cfg, shape, multi_pod: bool) -> ts.TrainHyper:
    nm = default_microbatches(cfg, shape, multi_pod)
    kw = dict(microbatches=nm, compress_cross_pod=multi_pod)
    if "mb4" in variant:
        kw["microbatches"] = 4
    if "mb2" in variant:
        kw["microbatches"] = 2
    if "dots_remat" in variant:
        kw["remat"] = "dots"
    kw["cast_params_once"] = "bf16" in variant
    kw["sequence_parallel"] = "seqpar" in variant
    kw["moe_impl"] = "sorted" if "sorted_moe" in variant else "gshard"
    return ts.TrainHyper(**kw)


def _shape_str(shape, dtype) -> str:
    name = str(dtype).replace("torch.", "")
    return f"{_HLO_DTYPE.get(name, name)}[{','.join(map(str, shape))}]"


def top_collectives(stats: rl.CollectiveStats, k: int = 12):
    """(kind, dtype+shape, site, bytes) rows, largest first: the
    collectives of ``stats`` summed by kind, result shape and the frame
    that issued them (``stats.sites``; "?" where `count_collectives` was
    not asked for sites).  An eager step counts each call as it runs, so
    no loop trip count multiplies a row, as the JAX module's HLO rows
    need."""
    sites = stats.sites or ["?"] * len(stats.calls)
    agg = defaultdict(float)
    for (kind, _, nbytes, shape, dtype), site in zip(stats.calls, sites):
        agg[(kind, _shape_str(shape, dtype), site)] += nbytes
    out = sorted(((k2[0], k2[1], k2[2], v) for k2, v in agg.items()),
                 key=lambda r: -r[3])
    return out[:k]


def _variant_config(cfg, variant: str):
    """``cfg`` as ``variant`` changes it (both packages read the names by
    substring): ``kvrep`` replicates the kv heads over "model"
    (``force_kv_replicate``), ``moegroup`` routes the MoE in groups of
    512 tokens, ``cf1`` sets the MoE capacity factor to 1.0."""
    if "kvrep" in variant:
        cfg = dataclasses.replace(cfg, force_kv_replicate=True)
    if "moegroup" in variant:
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, group_size=512))
    if "cf1" in variant:
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=1.0))
    return cfg


def _measure(cfg, shape: ShapeSpec, variant: str, multi_pod: bool,
             device: str = "cuda"):
    """``(record, stats)`` of the variant's cell: the dry run's record
    (`dryrun.compile_cell`) under the variant's config, hyper, cache
    write (``blend``) and parameter placement (``replparams``: replicated
    over "data"), and its `roofline.CollectiveStats` with sites."""
    cfg = _variant_config(cfg, variant)
    hyper = hyper_for(variant, cfg, shape, multi_pod)
    return _measure_cell(
        cfg, shape, multi_pod, hyper, device,
        cache_update="blend" if "blend" in variant else "dus",
        replicate_params_over_data="replparams" in variant)


def _result(variant: str, record, stats):
    """JAX's record of a run from the dry run's ``record`` and ``stats``:
    ``mem_dev`` the dry run's per-device bytes (arguments, temporaries
    and outputs less the alias; on the CPU the temporaries are not
    measured)."""
    return {"variant": variant, "terms": record["roofline"],
            "collective_bytes": stats.total_bytes,
            "tpu_corrected_bytes": stats.tpu_corrected_bytes,
            "mem_dev": int(record["memory_analysis"]["per_device_bytes"]),
            "by_kind": dict(stats.by_kind)}


def _run(cfg, shape: ShapeSpec, variant: str, multi_pod: bool,
         show_top: bool = True, device: str = "cuda"):
    """`run` on a config and shape given whole (a reduced one, in the
    CPU tests)."""
    t0 = time.time()
    rec, coll = _measure(cfg, shape, variant, multi_pod, device)
    res = _result(variant, rec, coll)
    mem, terms = res["mem_dev"], res["terms"]
    print(f"== {rec['arch']} x {shape.name} x {rec['mesh']} [{variant}] "
          f"(run {time.time()-t0:.0f}s on {device}) ==")
    print(f" terms(ms): compute={terms['compute_s']*1e3:.1f} "
          f"memory={terms['memory_s']*1e3:.1f} "
          f"collective={terms['collective_s']*1e3:.1f} "
          f"dominant={terms['dominant']} frac={terms['roofline_fraction']:.3f}")
    print(f" collectives: raw {coll.total_bytes/2**30:.1f} / "
          f"tpu-corrected {coll.tpu_corrected_bytes/2**30:.1f} GiB/dev "
          f"{ {k: round(v/2**30,1) for k,v in coll.by_kind.items() if v} } "
          f"mem/dev={mem/2**30:.2f} GiB")
    if show_top:
        for kind, shp, site, b in top_collectives(coll):
            print(f"   {b/2**30:6.3f} GiB  {kind:18s} {shp:26s} {site}")
    return res


def run(arch: str, shape_name: str, variant: str, multi_pod: bool,
        show_top: bool = True, device: str = "cuda"):
    return _run(get_config(arch), SHAPE_BY_NAME[shape_name], variant,
                multi_pod, show_top=show_top, device=device)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--variant", default="baseline")
    ap.add_argument("--multi", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda",
                    help="where the rank's blocks live (cuda or cpu)")
    args = ap.parse_args(argv)
    res = run(args.arch, args.shape, args.variant, args.multi,
              device=args.device)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1, default=float)


if __name__ == "__main__":
    main()
