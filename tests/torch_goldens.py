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
    return g


def path_of(name: str, out: Path = DATA) -> Path:
    return out / f"torch_golden_{name}.json"


def main(argv=None) -> int:
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
