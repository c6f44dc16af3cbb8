"""The hillclimb's variants at full width on the card: each row of
`tests/torch_goldens.HILLCLIMB_FULL` once, the cell its variant changes
run as rank 0 of a fake 256-rank group (`launch.hillclimb`, single pod),
beside JAX's record of the same row and the memory analysis of the step
XLA compiled for it (the dry-run golden, `tests/data`).

    PYTHONPATH=src python tools/hillclimb_variants.py [--out FILE] [ROW ...]

ROW is ``VARIANT@ARCH:SHAPE`` (default: every row).  Each row prints one
``ROW`` JSON line: the variant, the wall, the per-device bytes (the
card's peak above what was allocated before the call, with the
arguments, less the alias) beside JAX's, the collective bytes by kind
beside JAX's raw bytes, the argument and alias bytes beside XLA's, and
the kernel launches and plain calls of the call; then its top collectives.
A row that raises prints ``FAILED`` and its traceback, and the next row
runs.  The exit code is 1 if any row failed, its argument or alias bytes
differ from XLA's, its peak is not under `launch.mesh.HBM_BYTES`, or a
prefill did not launch its kernels on the rank's block (one
flash_attention an attention layer, `LAUNCHES_PER_CALL` ssd_scan kernels a
Mamba2 layer) or called a plain version.  ``--out`` keeps the rows as JSON
(default ``build/hillclimb_variants.json``).
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
import time
import traceback
from pathlib import Path

import torch

from repro_torch.configs.base import SHAPE_BY_NAME, get_config
from repro_torch.kernels.ssd_scan.kernel import LAUNCHES_PER_CALL
from repro_torch.launch import hillclimb
from repro_torch.launch.mesh import HBM_BYTES


def _goldens():
    """tests/torch_goldens.py, loaded from its file (a ``tests`` package
    installed elsewhere would shadow the repository's, which has no
    ``__init__.py``)."""
    path = Path(__file__).resolve().parent.parent / "tests" / \
        "torch_goldens.py"
    spec = importlib.util.spec_from_file_location("torch_goldens", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


tg = _goldens()


def prefill_launches(cfg) -> dict:
    """The kernel launches of a prefill on the rank's block: one
    flash_attention an attention layer (a hybrid's shared block, once a
    group), `LAUNCHES_PER_CALL` ssd_scan kernels a Mamba2 layer."""
    if cfg.family == "hybrid":
        return {"flash_attention": cfg.n_layers // cfg.hybrid_every,
                "ssd_scan": cfg.n_layers * LAUNCHES_PER_CALL}
    if cfg.family == "ssm":
        return {"ssd_scan": cfg.n_layers * LAUNCHES_PER_CALL}
    return {"flash_attention": cfg.n_layers}


def run_row(variant: str, arch: str, shape_name: str, golden: dict,
            card: str) -> tuple:
    """``(row, faults)`` of one full-width row run once on the card."""
    name = tg.hillclimb_row_name(variant, arch, shape_name)
    want = golden["hillclimb_full"][name]
    jma = golden["hillclimb_memory"][name]
    shape = SHAPE_BY_NAME[shape_name]
    t0 = time.perf_counter()
    rec, coll = hillclimb._measure(get_config(arch), shape, variant, False)
    wall = time.perf_counter() - t0
    res = hillclimb._result(variant, rec, coll)
    ma = rec["memory_analysis"]
    row = {"row": name, "variant": variant, "arch": arch,
           "shape": shape_name, "wall_s": wall,
           "call_s": rec["compile_s"],
           "mem_dev": res["mem_dev"], "jax_mem_dev": want["mem_dev"],
           "peak_bytes": res["mem_dev"] - ma["argument_bytes"],
           "argument_bytes": ma["argument_bytes"],
           "jax_argument_bytes": jma["argument_bytes"],
           "alias_bytes": ma["alias_bytes"],
           "jax_alias_bytes": jma["alias_bytes"],
           "collective_bytes": res["collective_bytes"],
           "by_kind": {k: v for k, v in res["by_kind"].items() if v},
           "jax_collective_bytes": want["collective_bytes"],
           "jax_by_kind": {k: v for k, v in want["by_kind"].items() if v},
           "kernel_launches": rec["kernel_launches"],
           "plain_calls": rec["plain_calls"],
           "card": card}
    faults = []
    if ma["argument_bytes"] != jma["argument_bytes"]:
        faults.append("argument bytes")
    # JAX donates a train step's state; the port does not (yet)
    if shape.kind != "train" and ma["alias_bytes"] != jma["alias_bytes"]:
        faults.append("alias bytes")
    if not res["mem_dev"] < HBM_BYTES or ma["temp_bytes"] < 0:
        faults.append("peak")
    if shape.kind == "prefill" and (
            rec["kernel_launches"] != prefill_launches(get_config(arch))
            or rec["plain_calls"]):
        faults.append("launches")
    print("ROW", json.dumps({**row, "faults": faults}), flush=True)
    for kind, shp, site, nbytes in hillclimb.top_collectives(coll, 6):
        print(f"    {nbytes / 2**30:8.3f} GiB  {kind:15s} {shp:24s} {site}",
              flush=True)
    return row, faults


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        else torch.cuda.get_device_name(0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("rows", nargs="*", help="VARIANT@ARCH:SHAPE")
    ap.add_argument("--out", default="build/hillclimb_variants.json")
    args = ap.parse_args(argv)
    rows = tg.HILLCLIMB_FULL
    if args.rows:
        rows = [(r.split("@")[0],) + tuple(r.split("@")[1].split(":"))
                for r in args.rows]
    golden = json.loads(tg.path_of("dryrun").read_text())
    card = card_line()
    print(f"card: {card}", flush=True)
    out, bad = [], []
    for variant, arch, shape_name in rows:
        try:
            row, faults = run_row(variant, arch, shape_name, golden, card)
            out.append({**row, "faults": faults})
            if faults:
                bad.append((variant, arch, shape_name, faults))
        except Exception:  # report the row and go on to the next
            print("FAILED", variant, arch, shape_name,
                  traceback.format_exc()[-3000:], flush=True)
            bad.append((variant, arch, shape_name, "raised"))
        torch.cuda.empty_cache()
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps({"card": card, "rows": out},
                                         indent=1))
    print(f"{len(rows) - len(bad)} of {len(rows)} rows ok; faults: {bad}",
          flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
