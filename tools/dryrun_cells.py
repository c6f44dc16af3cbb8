"""Full-width dry-run cells on the card with the collectives that set
their bytes: each cell's record line, its top collectives by the frame of
the port that issued them (`launch.hillclimb.top_collectives`), and those
over the "pod" mesh dim alone (a group of 2 ranks).

    PYTHONPATH=src python tools/dryrun_cells.py ARCH:SHAPE:MESH:NM[:CACHE] ...

MESH is ``single`` or ``multi``; NM the train cells' microbatches (empty:
`launch.dryrun.default_microbatches`); CACHE the decode's cache write
(``dus``, the default, or ``blend``).  Each cell runs as rank 0 of a fake
256- or 512-rank group (`launch.dryrun`), on the card, and prints one
``CELL`` JSON line (argument bytes, the card's peak above what was
allocated before the call, collective bytes by kind, wall seconds), then
its top rows.  A cell that raises prints ``FAILED`` and its traceback, and
the next cell runs.  Put another tree's ``src`` first on ``PYTHONPATH`` to
run that tree's port.
"""

from __future__ import annotations

import json
import sys
import time
import traceback
from collections import defaultdict

import torch

from repro_torch.configs.base import SHAPE_BY_NAME, get_config
from repro_torch.launch import dryrun, hillclimb
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.train import train_step as ts


def run(arch: str, shape: str, multi_pod: bool, nm, cache_update="dus",
        top: int = 12) -> None:
    cfg, sh = get_config(arch), SHAPE_BY_NAME[shape]
    hyper = None
    if sh.kind == "train":
        hyper = ts.TrainHyper(microbatches=nm or dryrun.default_microbatches(
            cfg, sh, multi_pod), compress_cross_pod=multi_pod)
    t0 = time.time()
    with dryrun._fake_group(512 if multi_pod else 256):
        mesh = make_production_mesh(multi_pod=multi_pod)
        step, args = dryrun._cell_step(cfg, sh, mesh, hyper, "cuda",
                                       cache_update=cache_update)
        out, coll, _, _, peak = dryrun._run_measured(step, args, "cuda")
        arg_bytes = dryrun._arg_bytes(cfg, sh, args)
        del out, step, args
    rec = {"cell": f"{arch}/{shape}/{'multi' if multi_pod else 'single'}/"
                   f"{nm}/{cache_update}",
           "arg_bytes": arg_bytes, "peak_gib": peak / 2**30,
           "total": coll.total_bytes,
           "by_kind": {k: v for k, v in coll.by_kind.items() if v},
           "wall_s": time.time() - t0,
           "card": torch.cuda.get_device_name(0)}
    print("CELL", json.dumps(rec), flush=True)
    for row in hillclimb.top_collectives(coll, top):
        print("   ", row, flush=True)
    pod = defaultdict(int)
    for (kind, ranks, nbytes, shp, dtype), site in zip(coll.calls,
                                                       coll.sites):
        if multi_pod and len(ranks) == 2:
            pod[(kind, str(shp), str(dtype), site)] += nbytes
    for key, nbytes in sorted(pod.items(), key=lambda kv: -kv[1])[:top]:
        print("    POD", nbytes, key, flush=True)
    torch.cuda.empty_cache()


def main(argv=None) -> int:
    for spec in (argv if argv is not None else sys.argv[1:]):
        parts = spec.split(":")
        arch, shape, mesh, nm = parts[:4]
        try:
            run(arch, shape, mesh == "multi", int(nm) if nm else None,
                parts[4] if len(parts) > 4 else "dus")
        except Exception:  # report the cell and go on to the next
            print("FAILED", spec, traceback.format_exc()[-3000:], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
