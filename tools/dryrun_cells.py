"""Full-width dry-run cells on the card with the collectives that set
their bytes: each cell's record line, its top collectives by the frame of
the port that issued them (`launch.hillclimb.top_collectives`), and those
over the "pod" mesh dim alone (a group of 2 ranks).

    PYTHONPATH=src python tools/dryrun_cells.py ARCH:SHAPE:MESH:NM[:CACHE] ...

MESH is ``single`` or ``multi``; NM the train cells' microbatches (empty:
`launch.dryrun.default_microbatches`); CACHE the decode's cache write
(``dus``, the default, or ``blend``).  Each cell runs as rank 0 of a fake
256- or 512-rank group (`launch.dryrun._measure_cell`, the dry run's
record), on the card, and prints one ``CELL`` JSON line (argument and
alias bytes, the per-device bytes: the card's peak above what was
allocated before the call with the arguments, less the alias; collective
bytes by kind, wall seconds), then its top rows.  A cell that raises
prints ``FAILED`` and its traceback, and the next cell runs.  Put another tree's ``src`` first on ``PYTHONPATH`` to
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
from repro_torch.train import train_step as ts


def run(arch: str, shape: str, multi_pod: bool, nm, cache_update="dus",
        top: int = 12) -> None:
    cfg, sh = get_config(arch), SHAPE_BY_NAME[shape]
    hyper = None
    if sh.kind == "train" and nm:
        hyper = ts.TrainHyper(microbatches=nm, compress_cross_pod=multi_pod)
    t0 = time.time()
    rec, coll = dryrun._measure_cell(cfg, sh, multi_pod, hyper, "cuda",
                                     cache_update=cache_update)
    ma = rec["memory_analysis"]
    print("CELL", json.dumps({
        "cell": f"{arch}/{shape}/{rec['mesh']}/{nm}/{cache_update}",
        "arg_bytes": ma["argument_bytes"],
        "alias_bytes": ma["alias_bytes"],
        "per_device_bytes": ma["per_device_bytes"],
        "total": rec["collectives"]["total_bytes_per_device"],
        "by_kind": rec["collectives"]["by_kind"],
        "wall_s": time.time() - t0,
        "card": torch.cuda.get_device_name(0)}), flush=True)
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
