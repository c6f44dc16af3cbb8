"""Time the port's two CPU engines on the calls the CPU paths issue.

On a CPU state the cache-simulator engine has two plain versions:
`cachesim.engine_py` (lane by lane in Python ints) and
`cachesim.engine_ref` (plain PyTorch, vectorized over lanes: the version
the CUDA kernel is held to).  This script runs on the CPU what the port's
CPU tests run on skylake_sp: `run_cachex`, one fleet, a lockstep matrix
of three guests with serving and an 8-guest `ShardedFleet`, the fleets at
the tests' reduced loop (`n_intervals=6, warmup=2, stream_len=64,
ws_pages=4`).  It keeps the first engine call of each (lanes = guests x
lanes, steps, commit) shape they issue, replays each kept call through
both engines on copies of its state, then replays the widest measuring
call with its lanes tiled 2, 4 and 8 times (wider than any of these
paths issues) to find where the engines cross.  It prints a JSON object:
per shape the number of calls seen (0 for a tiled one) and the median
seconds of each engine over ``--reps`` replays.  Both engines must return
the same latencies on every replay.

    PYTHONPATH=src python tools/cpu_engine_widths.py [--reps 3]
"""

from __future__ import annotations

import argparse
import collections
import json
import platform
import time

import numpy as np
import torch


def _clone(states):
    return {k: (tuple(x.clone() for x in v) if isinstance(v, tuple)
                else v.clone()) for k, v in states.items()}


def record():
    """(shape -> calls seen, shape -> one kept call) over the two paths."""
    from repro_torch.core import cachesim
    from repro_torch.core.fleet import (ShardedFleet, run_fleet,
                                        run_fleet_matrix)
    from repro_torch.core.runner import run_cachex

    seen, kept = collections.Counter(), {}
    inner = cachesim.engine

    def recording(states, geom, blocks, cores, cotenant, salts, commit):
        G, B, T = np.shape(blocks)
        key = (int(G * B), int(T), bool(commit))
        seen[key] += 1
        if key not in kept:
            kept[key] = (_clone(states), geom,
                         torch.as_tensor(blocks).clone(),
                         torch.as_tensor(cores).clone(),
                         torch.as_tensor(cotenant).clone(),
                         None if salts is None
                         else torch.as_tensor(salts).clone(), commit)
        return inner(states, geom, blocks, cores, cotenant, salts, commit)

    cachesim.engine = recording
    loop = dict(n_intervals=6, warmup=2, stream_len=64, ws_pages=4)
    try:
        run_cachex("skylake_sp", device="cpu")
        run_fleet("skylake_sp", device="cpu", **loop)
        run_fleet_matrix(["skylake_sp"], combos=(("eevdf", "on"),
                                                 ("cas", "on"),
                                                 ("cas", "off")),
                         serving=True, device="cpu", **loop)
        ShardedFleet("skylake_sp", 8, seed=0, device="cpu", **loop).run()
    finally:
        cachesim.engine = inner
    return seen, kept


def tiled(call, k):
    """A measuring call with each guest's lanes repeated ``k`` times."""
    states, geom, blocks, cores, cot, salts, commit = call
    return (states, geom, blocks.repeat(1, k, 1), cores.repeat(1, k),
            cot.repeat(1, k), salts, commit)


def time_engine(run, call, reps):
    states, geom, blocks, cores, cot, salts, commit = call
    out, secs = None, []
    for _ in range(reps):
        st = _clone(states)
        t0 = time.perf_counter()
        lat = run(st, geom, blocks, cores, cot, salts, commit)
        secs.append(time.perf_counter() - t0)
        out = lat
    return float(np.median(secs)), out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)
    from repro_torch.core import cachesim

    torch.manual_seed(0)
    seen, kept = record()
    widest = max((k for k in kept if not k[2]), key=lambda k: k[0] * k[1])
    cases = [(k, seen[k], kept[k]) for k in sorted(kept)]
    cases += [((widest[0] * m, widest[1], False), 0, tiled(kept[widest], m))
              for m in (2, 4, 8)]
    rows = []
    for key, calls, call in cases:
        py_s, py_lat = time_engine(cachesim.engine_py, call, args.reps)
        ref_s, ref_lat = time_engine(cachesim.engine_ref, call, args.reps)
        if not torch.equal(py_lat, ref_lat):
            raise SystemExit(f"engines disagree on {key}")
        rows.append({"lanes": key[0], "steps": key[1], "commit": key[2],
                     "calls": calls, "engine_py_s": py_s,
                     "engine_ref_s": ref_s})
    print(json.dumps({"cpu": platform.processor() or platform.machine(),
                      "torch_threads": torch.get_num_threads(),
                      "reps": args.reps, "shapes": rows}))


if __name__ == "__main__":
    main()
