#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (`src/repro_torch`) on one card.

    python3 chip_smoke.py [--out results.json]

Four phases, in order; any failure exits non-zero:

1. build   — compiles every CUDA source of the port with nvcc for sm_90a
             and prints the build seconds and the card's name and power
             limit;
2. kernels — holds each kernel bit for bit against its plain PyTorch
             version on the card: `lru_sets` and `prime_probe` at the
             shapes of tests/test_kernels.py, at the main path's shapes,
             and against the engine's batched lanes on a single-level
             geometry; the engine at all four entry points, under lru and
             random replacement, inclusive and non-inclusive hierarchies,
             on the skylake_sp geometry and the paper's Table 1 geometry;
3. main    — runs `run_cachex("skylake_sp")` on the card with the launch
             counters at 0: the report must equal
             tests/data/torch_golden_run_cachex_skylake_sp.json, the engine
             kernel must have launched once per engine call (361) and the
             plain engine never; then drives the two LRU kernels through
             their own entry points (`simulate_rows`, `probe_verdicts`) at
             the main path's shapes, counters reset before and read after;
4. times   — times each kernel with CUDA events at the main path's shapes
             beside its plain version and its bound, and prints one
             `{"kernels": [...]}` line.

The line before the last is `nvidia-smi`'s name and power limit of the
card; the last line is `{"ok": true, "device": {...}}`.  Without a CUDA
device the script exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
GOLDEN = ROOT / "tests" / "data" / "torch_golden_run_cachex_skylake_sp.json"
MAIN_PATH_ENGINE_CALLS = 361      # 308 access_streams_batched + 53 access_stream
# H100 SXM published peaks: HBM bytes/s, and
# the 32-bit rate outside the tensor cores, used for the integer compares.
HBM_BYTES_PER_S = 3.35e12
ALU_OPS_PER_S = 67e12

SOURCES = {
    "cachesim_engine": ("src/repro_torch/csrc/cachesim_engine.cu",
                        "src/repro/core/cachesim.py:294"),
    "lru_sets": ("src/repro_torch/csrc/cachesim_step.cu",
                 "src/repro/kernels/cachesim_step/kernel.py:44"),
    "prime_probe": ("src/repro_torch/csrc/cache_probe.cu",
                    "src/repro/kernels/cache_probe/kernel.py:80"),
}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0].strip()


class Smoke:
    def __init__(self):
        import torch
        self.torch = torch
        self.dev = torch.device("cuda")
        self._cycles_per_ms = None
        self.err = {k: 0 for k in SOURCES}   # max |kernel - plain| per kernel
        self.checks = {k: 0 for k in SOURCES}

    # -- helpers -------------------------------------------------------------
    def t(self, a, dtype=None):
        if isinstance(a, self.torch.Tensor):
            return a.to(device=self.dev, dtype=dtype).contiguous()
        return self.torch.as_tensor(np.asarray(a), device=self.dev,
                                    dtype=dtype)

    def agree(self, kernel: str, what: str, got, want) -> None:
        got = np.asarray(self.torch.as_tensor(got).cpu()).astype(np.int64)
        want = np.asarray(self.torch.as_tensor(want).cpu()).astype(np.int64)
        if got.shape != want.shape:
            raise AssertionError(f"{kernel} {what}: shape {got.shape} != "
                                 f"{want.shape}")
        err = int(np.abs(got - want).max()) if got.size else 0
        self.err[kernel] = max(self.err[kernel], err)
        self.checks[kernel] += 1
        if err != 0:
            bad = int((got != want).sum())
            raise AssertionError(f"{kernel} {what}: {bad} of {got.size} "
                                 f"values differ from the plain version "
                                 f"(max abs err {err})")

    def sync(self):
        self.torch.cuda.synchronize()

    def timeit(self, fn, reps: int, warmup: int = 1) -> float:
        """Milliseconds per call, host and device together: CUDA events
        around ``reps`` calls after ``warmup`` calls (for the plain
        versions, whose time is mostly host work and synchronizations)."""
        torch = self.torch
        for _ in range(warmup):
            fn()
        self.sync()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    def device_ms(self, fn, reps: int = 50) -> float:
        """Device milliseconds per launch of ``fn`` (one kernel launch, no
        synchronization inside).  A spin kernel keeps the stream busy while
        the host enqueues the start event, ``reps`` launches and the end
        event, so no host time falls between the events; the start event
        must still be pending once all is enqueued, else the spin is
        doubled and the measurement repeated."""
        torch = self.torch
        if self._cycles_per_ms is None:
            probe = 10_000_000
            self.sync()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            torch.cuda._sleep(probe)
            end.record()
            end.synchronize()
            self._cycles_per_ms = probe / start.elapsed_time(end)
        fn()
        self.sync()
        spin_ms = 20.0
        for _ in range(5):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(int(spin_ms * self._cycles_per_ms))
            start.record()
            for _ in range(reps):
                fn()
            end.record()
            hidden = not start.query()
            end.synchronize()
            if hidden:
                return start.elapsed_time(end) / reps
            spin_ms *= 2
        raise RuntimeError("device_ms: the host could not enqueue "
                           f"{reps} launches within a {spin_ms / 2:.0f} ms "
                           "spin")

    # -- phase 2a: lru_sets -------------------------------------------------------
    def check_lru_sets(self):
        from repro_torch.core import cachesim
        from repro_torch.kernels.cachesim_step import ops, ref
        cases = [(4, 4, 1, 0), (8, 8, 33, 1), (16, 4, 48, 2), (32, 8, 17, 3)]
        for rows, ways, T, seed in cases:          # test_kernels.py sweep
            rng = np.random.default_rng(seed)
            tags = np.full((rows, ways), -1, np.int32)
            tags[: rows // 2, : ways // 2] = rng.integers(
                0, 64, (rows // 2, ways // 2))
            age = np.zeros((rows, ways), np.int32)
            streams = rng.integers(-1, 64, size=(rows, T)).astype(np.int32)
            self._lru_pair(ops, ref, tags, age, streams, 1,
                           f"sweep {rows}x{ways}x{T}")
        rng = np.random.default_rng(11)
        for i in range(15):                        # the property test's space
            rows = int(rng.choice([4, 8, 16]))
            ways = int(rng.choice([4, 8]))
            T = int(rng.integers(1, 49))
            tags = np.full((rows, ways), -1, np.int32)
            age = np.zeros((rows, ways), np.int32)
            streams = rng.integers(-1, 32, size=(rows, T)).astype(np.int32)
            self._lru_pair(ops, ref, tags, age, streams, 1, f"property {i}")
        # main path's shape: the skylake_sp LLC rows (2 slices x 512 sets =
        # 1024 rows x 8 ways), warmed by the engine, 128 steps per row
        tags, age, streams, clock0 = self.llc_rows_workload(T=128)
        self._lru_pair(ops, ref, tags, age, streams, clock0, "llc rows")
        # against the engine's batched lanes on a single-level geometry
        R, W, T = 128, 8, 128
        geom, state, lanes, clock0 = self.single_level(R, W, T, seed=5)
        lats = cachesim.access_streams_batched(
            state, geom, self.t(lanes, self.torch.int32),
            self.t(np.zeros(R, np.int32)), self.t(np.ones(R, bool)), 0)
        _, _, hits = ops.simulate_rows(state["llc"][0][0, 0],
                                       state["llc"][1][0, 0],
                                       self.t(lanes, self.torch.int32),
                                       clock0=clock0)
        self.agree("lru_sets", "vs engine lanes", hits,
                   lats == cachesim.LAT_LLC)

    def _lru_pair(self, ops, ref, tags, age, streams, clock0, what):
        i32 = self.torch.int32
        args = (self.t(tags, i32), self.t(age, i32), self.t(streams, i32))
        k = ops.simulate_rows(*args, clock0=clock0)
        r = ref.lru_sets_ref(*args, clock0=clock0)
        for name, a, b in zip(("tags", "age", "hits"), k, r):
            self.agree("lru_sets", f"{what} {name}", a, b)

    def llc_rows_workload(self, T: int, seed: int = 3):
        """The skylake_sp LLC rows after a warming stream, and one
        (1024, T) stream of blocks per row (-1 padded)."""
        from repro_torch.core import cachesim
        from repro_torch.core.platforms import get_platform
        geom = get_platform("skylake_sp").machine()
        state = cachesim.init_machine(geom, self.dev)
        rng = np.random.default_rng(seed)
        warm = rng.integers(0, 1 << 16, 4096).astype(np.int32)
        cachesim.access_stream(state, geom, self.t(warm),
                               self.t(np.zeros(4096, np.int32)),
                               self.t(np.zeros(4096, bool)))
        tags = state["llc"][0].reshape(-1, geom.llc.n_ways)
        age = state["llc"][1].reshape(-1, geom.llc.n_ways)
        rows = tags.shape[0]
        streams = rng.integers(0, 1 << 16, (rows, T)).astype(np.int32)
        streams[rng.random((rows, T)) < 0.1] = -1
        clock0 = int(state["clock"]) + 1
        return tags.contiguous(), age.contiguous(), self.t(streams), clock0

    def single_level(self, R: int, W: int, T: int, seed: int):
        """A one-core, one-slice machine with R pre-populated LLC sets
        (ages below the clock) and one stream per set."""
        from repro_torch.core import cachesim
        rng = np.random.default_rng(seed)
        geom = cachesim.MachineGeometry(
            n_domains=1, cores_per_domain=1,
            l2=cachesim.CacheGeometry(n_sets=16, n_ways=4),
            llc=cachesim.CacheGeometry(n_sets=R, n_ways=W, n_slices=1))
        tags = np.full((R, W), -1, np.int32)
        fill = rng.integers(0, W + 1, R)
        for r in range(R):
            k = int(fill[r])
            tags[r, :k] = (rng.permutation(4 * W)[:k] * R + r)
        age = np.where(tags >= 0, rng.integers(1, 1000, (R, W)), 0)
        clock = 1000
        state = cachesim.state_from_numpy(
            {"l2": (np.full((1, 16, 4), -1, np.int32),
                    np.zeros((1, 16, 4), np.int32)),
             "llc": (tags[None, None], age[None, None].astype(np.int32)),
             "clock": np.int32(clock), "rng": np.uint32(0x12345678)},
            self.dev)
        lanes = (rng.integers(0, 3 * W, (R, T)) * R
                 + np.arange(R)[:, None]).astype(np.int32)
        lanes[rng.random((R, T)) < 0.1] = -1
        return geom, state, lanes, clock + 1

    # -- phase 2b: prime_probe ----------------------------------------------------
    def check_prime_probe(self):
        from repro_torch.core import cachesim
        from repro_torch.kernels.cache_probe import ops, ref
        i32 = self.torch.int32
        cases = [(8, 4, 24, 0), (16, 8, 40, 1), (64, 8, 40, 2),
                 (32, 16, 12, 3)]
        for lanes, ways, T, seed in cases:         # test_kernels.py sweep
            rng = np.random.default_rng(seed)
            tags = np.full((lanes, ways), -1, np.int32)
            tags[::2, : ways // 2] = rng.integers(100, 164,
                                                  (lanes // 2, ways // 2))
            age = np.zeros((lanes, ways), np.int32)
            streams = rng.integers(-1, 64, (lanes, T)).astype(np.int32)
            targets = rng.integers(0, 64, lanes).astype(np.int32)
            self._probe_pair(ops, ref, tags, age, streams, targets, 1,
                             f"sweep {lanes}x{ways}x{T}")
        # the LRU eviction law (test_kernels.py)
        rng = np.random.default_rng(7)
        lanes, ways, T = 32, 8, 48
        tags = np.full((lanes, ways), -1, np.int32)
        tags[::2, :4] = rng.integers(1000, 1064, (lanes // 2, 4))
        age = np.zeros((lanes, ways), np.int32)
        targets = rng.integers(0, 64, lanes).astype(np.int32)
        streams = rng.integers(-1, 64, (lanes, T)).astype(np.int32)
        streams[streams == targets[:, None]] = -1
        v = ops.probe_verdicts(self.t(tags, i32), self.t(age, i32),
                               self.t(streams, i32), self.t(targets, i32))
        law = [len(set(int(x) for x in streams[b] if x >= 0)) >= ways
               for b in range(lanes)]
        self.agree("prime_probe", "eviction law", v, np.array(law))
        # main path's shapes: VEV Vote dispatches (B lanes x 128 steps, 8 ways)
        for B in (16, 64, 128, 256):
            tags, age, streams, targets = self.vote_workload(B, 128, 8)
            self._probe_pair(ops, ref, tags, age, streams, targets, 1,
                             f"vote {B}x128")
        # against the engine's batched lanes on a single-level geometry:
        # lane b = [target, prime stream..., target] in set b
        R, W, T = 128, 8, 126
        geom, state, stream, clock0 = self.single_level(R, W, T, seed=9)
        rng = np.random.default_rng(9)
        targets = (rng.integers(0, 3 * W, R) * R + np.arange(R)).astype(
            np.int32)
        lanes = np.concatenate([targets[:, None], stream, targets[:, None]],
                               axis=1)
        lats = cachesim.access_streams_batched(
            state, geom, self.t(lanes, i32), self.t(np.zeros(R, np.int32)),
            self.t(np.ones(R, bool)), 0)
        v = ops.probe_verdicts(state["llc"][0][0, 0].contiguous(),
                               state["llc"][1][0, 0].contiguous(),
                               self.t(stream, i32), self.t(targets, i32),
                               clock0=clock0)
        self.agree("prime_probe", "vs engine lanes", v,
                   lats[:, -1] == cachesim.LAT_DRAM)

    def _probe_pair(self, ops, ref, tags, age, streams, targets, clock0,
                    what):
        i32 = self.torch.int32
        args = (self.t(tags, i32), self.t(age, i32), self.t(streams, i32),
                self.t(targets, i32))
        self.agree("prime_probe", what, ops.probe_verdicts(*args,
                                                           clock0=clock0),
                   ref.prime_probe_ref(*args, clock0=clock0))

    def vote_workload(self, B: int, T: int, W: int, seed: int = 1):
        rng = np.random.default_rng(seed + B)
        tags = np.full((B, W), -1, np.int32)
        tags[:, : W // 2] = rng.integers(1 << 20, 1 << 21, (B, W // 2))
        age = np.where(tags >= 0, rng.integers(0, 100, (B, W)), 0).astype(
            np.int32)
        targets = rng.integers(0, 1 << 16, B).astype(np.int32)
        # candidates: ~ways+1 distinct lines per lane, repeated, -1 padded
        cand = rng.integers(0, 1 << 16, (B, W + 1))
        streams = np.take_along_axis(cand, rng.integers(0, W + 1, (B, T)),
                                     axis=1).astype(np.int32)
        streams[:, T - T // 4:] = -1
        return tags, age, streams, targets

    # -- phase 2c: the engine ---------------------------------------------------------
    def geometries(self):
        from repro_torch.core import cachesim
        from repro_torch.core.platforms import get_platform
        return {"skylake_sp": get_platform("skylake_sp").machine(),
                "table1": cachesim.MachineGeometry(
                    l2=cachesim.SKYLAKE_L2, llc=cachesim.skylake_llc(20))}

    def engine_stream(self, geom, T: int, rng, lines: int):
        blocks = rng.integers(0, lines, T).astype(np.int32)
        blocks[rng.random(T) < 0.1] = -1
        cores = rng.integers(0, geom.n_cores, T).astype(np.int32)
        cot = rng.random(T) < 0.2
        return blocks, cores, cot

    def check_engine(self):
        from repro_torch.core import cachesim
        for gname, base in self.geometries().items():
            lines = 3 * base.llc.n_lines
            small = gname == "table1"
            for repl in ("lru", "random"):
                for incl in ("inclusive", "non_inclusive"):
                    geom = dataclasses.replace(base, replacement=repl,
                                               inclusion=incl)
                    tag = f"{gname} {repl} {incl}"
                    rng = np.random.default_rng(
                        len(tag) + 7 * (repl == "lru"))
                    self._engine_case(cachesim, geom, tag, rng, lines,
                                      B=8 if small else 128)

    def _states_agree(self, what, a, b):
        for key in ("l2", "llc"):
            for i, part in enumerate(("tags", "age")):
                self.agree("cachesim_engine", f"{what} {key} {part}",
                           a[key][i], b[key][i])
        self.agree("cachesim_engine", f"{what} clock", a["clock"],
                   b["clock"])
        self.agree("cachesim_engine", f"{what} rng", a["rng"], b["rng"])

    def _engine_case(self, cachesim, geom, tag, rng, lines, B):
        clone = lambda s: {k: (tuple(x.clone() for x in v)
                               if isinstance(v, tuple) else v.clone())
                           for k, v in s.items()}
        state = cachesim.init_machine(geom, self.dev)
        # warm the machine (kernel) and a copy (plain), then compare
        warm = clone(state)
        blocks, cores, cot = self.engine_stream(geom, 512, rng, lines)
        _, lk = cachesim.access_stream(state, geom, self.t(blocks),
                                       self.t(cores), self.t(cot))
        lp = cachesim.engine_ref(cachesim._single(warm), geom,
                                 self.t(blocks)[None, None],
                                 self.t(cores)[None], self.t(cot)[None],
                                 None, commit=True)[0, 0]
        self.agree("cachesim_engine", f"{tag} access_stream lat", lk, lp)
        self._states_agree(f"{tag} access_stream", state, warm)
        # committed: 3 guests from diverged copies
        guests = [clone(state) for _ in range(3)]
        for i, g in enumerate(guests[1:]):
            b, c, t = self.engine_stream(geom, 64 * (i + 1), rng, lines)
            cachesim.access_stream(g, geom, self.t(b), self.t(c), self.t(t))
        streams = [self.engine_stream(geom, 512, rng, lines)
                   for _ in range(3)]
        blocks = np.stack([s[0] for s in streams])
        cores = np.stack([s[1] for s in streams])
        cot = np.stack([s[2] for s in streams])
        sk = cachesim.stack_states(guests)
        sp = clone(sk)
        _, lk = cachesim.access_streams_committed(
            sk, geom, self.t(blocks), self.t(cores), self.t(cot))
        lp = cachesim.engine_ref(sp, geom, self.t(blocks)[:, None],
                                 self.t(cores), self.t(cot), None,
                                 commit=True)[:, 0]
        self.agree("cachesim_engine", f"{tag} committed lat", lk, lp)
        self._states_agree(f"{tag} committed", sk, sp)
        # batched: B lanes x 128 steps, salted; the state must not move
        before = clone(state)
        lanes = rng.integers(0, lines, (B, 128)).astype(np.int32)
        lanes[rng.random((B, 128)) < 0.1] = -1
        lcores = rng.integers(0, geom.n_cores, B).astype(np.int32)
        lcot = rng.random(B) < 0.25
        lk = cachesim.access_streams_batched(
            state, geom, self.t(lanes), self.t(lcores), self.t(lcot), 5)
        lp = cachesim.engine_ref(cachesim._single(state), geom,
                                 self.t(lanes)[None], self.t(lcores)[None],
                                 self.t(lcot)[None],
                                 self.t(np.array([5], np.int64)),
                                 commit=False)[0]
        self.agree("cachesim_engine", f"{tag} batched lat", lk, lp)
        self._states_agree(f"{tag} batched leaves state", state, before)
        # lane 0 with salt 0 replays access_stream bit for bit
        one = cachesim.access_streams_batched(
            state, geom, self.t(lanes[:1]), self.t(lcores[:1]),
            self.t(np.zeros(1, bool)), 0)
        seq = clone(state)
        _, ls = cachesim.access_stream(
            seq, geom, self.t(lanes[0]),
            self.t(np.full(128, lcores[0], np.int32)),
            self.t(np.zeros(128, bool)))
        self.agree("cachesim_engine", f"{tag} lane 0 == access_stream",
                   one[0], ls)
        # batched_multi: 3 guests x B lanes, per-guest salts
        mb = rng.integers(0, lines, (3, B, 128)).astype(np.int32)
        mb[rng.random((3, B, 128)) < 0.1] = -1
        mc = rng.integers(0, geom.n_cores, (3, B)).astype(np.int32)
        mt = rng.random((3, B)) < 0.25
        salts = np.array([0, 7, 0xFFFFFFFF], np.int64)
        sk = cachesim.stack_states(guests)
        lk = cachesim.access_streams_batched_multi(
            sk, geom, self.t(mb), self.t(mc), self.t(mt), salts)
        lp = cachesim.engine_ref(sk, geom, self.t(mb), self.t(mc),
                                 self.t(mt), self.t(salts), commit=False)
        self.agree("cachesim_engine", f"{tag} batched_multi lat", lk, lp)


def bound(nbytes: float, ops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ALU_OPS_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


def touched_rows(cachesim, geom, blocks, cores, cotenant):
    """The distinct L2 and LLC set rows of one guest's state that the valid
    accesses of ``blocks`` touch: (L2 row ids, LLC row ids).  ``blocks`` is
    (T,) with per-step ``cores``/``cotenant`` (commit mode) or (B, T) with
    per-lane ones (measure mode)."""
    import torch
    blk = blocks.cpu().numpy().astype(np.int64).reshape(-1, blocks.shape[-1])
    core = cores.cpu().numpy().astype(np.int64)
    cot = cotenant.cpu().numpy().astype(bool)
    if blocks.dim() == 1:
        core, cot = core[None, :], cot[None, :]
    else:
        core, cot = core[:, None], cot[:, None]
    core, cot = np.broadcast_to(core, blk.shape), np.broadcast_to(cot, blk.shape)
    valid = blk >= 0
    prober = valid & ~cot
    sb = np.where(valid, blk, 0)
    sl = cachesim.slice_hash(torch.as_tensor(sb), geom.llc.n_slices,
                             geom.slice_seed).numpy().astype(np.int64)
    l2 = core * geom.l2.n_sets + sb % geom.l2.n_sets
    llc = ((core // geom.cores_per_domain * geom.llc.n_slices + sl)
           * geom.llc.n_sets + sb % geom.llc.n_sets)
    return np.unique(l2[prober]), np.unique(llc[valid])


def engine_bytes(geom, l2_rows: int, llc_rows: int, steps: int, lanes: int,
                 commit: bool) -> int:
    """Bytes one engine call must move: each touched row of tags and ages
    read once (and, in commit mode, written back once), the blocks read and
    the latencies written, the cores and co-tenant flags read (per step in
    commit mode, per lane in measure mode), and the clock and rng (read,
    and written back in commit mode; the salts in measure mode)."""
    rows = l2_rows * 8 * geom.l2.n_ways + llc_rows * 8 * geom.llc.n_ways
    if commit:
        return 2 * rows + steps * (4 + 4 + 4 + 1) + 2 * 12
    return rows + steps * (4 + 4) + lanes * (4 + 1) + 12 + 8


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the full results as JSON here")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import _build
    from repro_torch.core import cachesim, runner
    from repro_torch.core.platforms import get_platform
    from repro_torch.kernels.cache_probe import ops as probe_ops
    from repro_torch.kernels.cache_probe import ref as probe_ref
    from repro_torch.kernels.cachesim_step import ops as sim_ops
    from repro_torch.kernels.cachesim_step import ref as sim_ref

    smoke = Smoke()
    out = {"phases": {}}
    t_all = time.perf_counter()

    # -- 1. build ---------------------------------------------------------------
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    build_s = _build.build()
    for name, log in _build.BUILD_LOG.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {name}: {line.strip()}")
    print(f"build: {build_s:.1f} s (nvcc, sm_90a, {len(_build.SOURCES)} "
          f"sources in parallel)")
    print(f"card: {card}")
    out["card"] = card
    out["phases"]["build_s"] = build_s

    # -- 2. kernels vs plain ------------------------------------------------------
    t0 = time.perf_counter()
    smoke.check_lru_sets()
    smoke.check_prime_probe()
    smoke.check_engine()
    smoke.sync()
    out["phases"]["kernels_s"] = time.perf_counter() - t0
    print(f"kernels: all bit-exact vs plain (checks {smoke.checks}, "
          f"launches {dict(_build.LAUNCHES)}) in "
          f"{out['phases']['kernels_s']:.1f} s")

    # -- 3. main path -----------------------------------------------------------------
    _build.reset_counters()
    t0 = time.perf_counter()
    report = runner.run_cachex("skylake_sp")
    smoke.sync()
    main_s = time.perf_counter() - t0
    main_launches = dict(_build.LAUNCHES)
    main_plain = dict(_build.PLAIN_CALLS)
    got = dataclasses.asdict(report)
    got.pop("wall_s")
    got = json.loads(json.dumps(got, sort_keys=True))
    want = json.loads(GOLDEN.read_text())
    if got != want:
        raise AssertionError(f"run_cachex(skylake_sp) report differs from "
                             f"{GOLDEN.name}: {got} != {want}")
    if main_launches.get("cachesim_engine", 0) != MAIN_PATH_ENGINE_CALLS \
            or main_plain.get("cachesim_engine", 0) != 0:
        raise AssertionError(f"main path launches {main_launches}, "
                             f"plain calls {main_plain}: expected "
                             f"{MAIN_PATH_ENGINE_CALLS} engine launches "
                             f"and no plain engine call")
    print(f"main: run_cachex(skylake_sp) on cuda matches the golden report "
          f"in {main_s:.3f} s; launches {main_launches}, plain calls "
          f"{main_plain}")
    out["phases"]["main_s"] = main_s
    out["main"] = {"report": got, "launches": main_launches,
                   "plain_calls": main_plain}
    # where the time goes: a second run with CUDA events around every
    # engine launch against the host clock (wall).  Each pair of events
    # also spans the host's enqueue of its launch, so the sum is an upper
    # bound on the engine's device time.
    events = []
    launch = cachesim._engine_cuda

    def timed_launch(*a, **kw):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        lat = launch(*a, **kw)
        end.record()
        events.append((start, end, a[2].shape))
        return lat

    cachesim._engine_cuda = timed_launch
    try:
        t0 = time.perf_counter()
        runner.run_cachex("skylake_sp")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        cachesim._engine_cuda = launch
    by_shape = {}
    for start, end, shape in events:
        key = "x".join(str(int(x)) for x in shape)
        n, ms = by_shape.get(key, (0, 0.0))
        by_shape[key] = (n + 1, ms + start.elapsed_time(end))
    device_ms = sum(ms for _, ms in by_shape.values())
    out["main"]["breakdown"] = {
        "wall_s": wall, "engine_device_ms": device_ms,
        "device_idle_share": 1.0 - device_ms / 1e3 / wall,
        "by_shape_GBT": {k: {"launches": n, "ms": ms}
                         for k, (n, ms) in sorted(by_shape.items())}}
    print(f"main breakdown: wall {wall:.3f} s with events (uninstrumented "
          f"run {main_s:.3f} s), engine device time at most "
          f"{device_ms:.1f} ms over {len(events)} launches, device idle at "
          f"least {100 * (1 - device_ms / 1e3 / wall):.1f}% on {card}")
    for k, (n, ms) in sorted(by_shape.items(), key=lambda kv: -kv[1][1]):
        print(f"  engine (G, B, T) = {k}: {n} launches, {ms:.2f} ms")

    # the LRU kernels' own entry points at the main path's shapes
    path_launches = {}
    rows_tags, rows_age, rows_streams, rows_clock0 = \
        smoke.llc_rows_workload(T=128)
    votes = {B: [smoke.t(x, torch.int32)
                 for x in smoke.vote_workload(B, 128, 8)]
             for B in (16, 64, 128, 256)}
    _build.reset_counters()
    sim_ops.simulate_rows(rows_tags, rows_age, rows_streams,
                          clock0=rows_clock0)
    smoke.sync()
    path_launches["lru_sets"] = _build.LAUNCHES["lru_sets"]
    _build.reset_counters()
    for B, args_ in votes.items():
        probe_ops.probe_verdicts(*args_)
    smoke.sync()
    path_launches["prime_probe"] = _build.LAUNCHES["prime_probe"]
    if path_launches["lru_sets"] != 1 \
            or path_launches["prime_probe"] != len(votes):
        raise AssertionError(f"kernel paths launched {path_launches}")
    print(f"paths: simulate_rows(1024x8x128) and probe_verdicts at B in "
          f"{list(votes)} launched {path_launches}")

    # -- 4. times -----------------------------------------------------------------
    # "ms" is device time per launch (Smoke.device_ms), "plain_ms" the
    # plain version's time per call, host included (Smoke.timeit).
    sky = get_platform("skylake_sp").machine()
    table1 = smoke.geometries()["table1"]
    rng = np.random.default_rng(0)
    rows = []

    def engine_case(geom, gname, shape):
        state = cachesim.init_machine(geom, smoke.dev)
        warm = rng.integers(0, 3 * geom.llc.n_lines, 4096).astype(np.int32)
        cachesim.access_stream(state, geom, smoke.t(warm),
                               smoke.t(np.zeros(4096, np.int32)),
                               smoke.t(np.zeros(4096, bool)))
        lines = 3 * geom.llc.n_lines
        single = cachesim._single(state)
        if len(shape) == 1:
            T = shape[0]
            b, c, t = (smoke.t(x) for x in
                       smoke.engine_stream(geom, T, rng, lines))
            args_ = (b[None, None], c[None], t[None], None, True)
            l2_before = state["l2"][0].clone()
            cachesim._engine_cuda(single, geom, *args_)
            # rows the back-invalidations changed are read and written too
            changed = (state["l2"][0] != l2_before).any(dim=-1)
            l2_rows, llc_rows = touched_rows(cachesim, geom, b, c, t)
            l2_rows = np.union1d(
                l2_rows, np.flatnonzero(changed.cpu().numpy()))
            nbytes = engine_bytes(geom, len(l2_rows), len(llc_rows), T, 1,
                                  commit=True)
            mode = "access_stream"
        else:
            B, T = shape
            lanes = rng.integers(0, lines, (B, T)).astype(np.int32)
            lanes[:, T - T // 4:] = -1
            b = smoke.t(lanes)
            c = smoke.t(np.zeros(B, np.int32))
            t = smoke.t(np.zeros(B, bool))
            s = smoke.t(np.array([3], np.int64))
            args_ = (b[None], c[None], t[None], s, False)
            l2_rows, llc_rows = touched_rows(cachesim, geom, b, c, t)
            nbytes = engine_bytes(geom, len(l2_rows), len(llc_rows), B * T,
                                  B, commit=False)
            mode = "access_streams_batched"
        valid = int((b >= 0).sum())
        # 2 compares (tag, age) per way per level per valid step
        ops = 2 * valid * (geom.l2.n_ways + geom.llc.n_ways)
        b_ms, b_by = bound(nbytes, ops)
        ms = smoke.device_ms(lambda: cachesim._engine_cuda(single, geom,
                                                           *args_))
        plain_ms = smoke.timeit(lambda: cachesim.engine_ref(single, geom,
                                                            *args_),
                                reps=1, warmup=0)
        return {"geometry": gname, "entry": mode, "shape": list(shape),
                "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                "bound_by": b_by, "bytes": nbytes, "ops": ops,
                "touched_rows": {"l2": len(l2_rows), "llc": len(llc_rows)}}

    engine_shapes = [engine_case(sky, "skylake_sp", (16, 128)),
                     engine_case(sky, "skylake_sp", (64, 128)),
                     engine_case(sky, "skylake_sp", (128, 128)),
                     engine_case(sky, "skylake_sp", (512,)),
                     engine_case(sky, "skylake_sp", (1536,)),
                     engine_case(table1, "table1", (16, 128)),
                     engine_case(table1, "table1", (1536,))]
    head = engine_shapes[0]
    rows.append({"name": "cachesim_engine", "route": "cuda",
                 "source": SOURCES["cachesim_engine"][0],
                 "replaces": SOURCES["cachesim_engine"][1],
                 "launches": main_launches.get("cachesim_engine", 0),
                 "path": "run_cachex(skylake_sp)",
                 "max_abs_err": smoke.err["cachesim_engine"],
                 "ms": head["ms"], "plain_ms": head["plain_ms"],
                 "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
                 "library_ms": None,
                 "shape": "access_streams_batched (16, 128) skylake_sp",
                 "shapes": engine_shapes, "card": card})

    W, T = 8, 128
    valid = int((rows_streams >= 0).sum())
    n = rows_tags.shape[0]
    b_ms, b_by = bound(n * W * 16 + n * T * 4 + n * T, 2 * W * valid)
    rows.append({
        "name": "lru_sets", "route": "cuda",
        "source": SOURCES["lru_sets"][0], "replaces": SOURCES["lru_sets"][1],
        "launches": path_launches["lru_sets"],
        "path": "ops.simulate_rows, skylake_sp LLC rows",
        "run_cachex_launches": main_launches.get("lru_sets", 0),
        "max_abs_err": smoke.err["lru_sets"],
        "ms": smoke.device_ms(lambda: sim_ops.simulate_rows(
            rows_tags, rows_age, rows_streams, clock0=rows_clock0)),
        "plain_ms": smoke.timeit(lambda: sim_ref.lru_sets_ref(
            rows_tags, rows_age, rows_streams, clock0=rows_clock0), reps=1,
            warmup=0),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "shape": f"({n}, {W}) x {T}", "card": card})

    B = 128
    vt = votes[B]
    valid = int((vt[2] >= 0).sum())
    b_ms, b_by = bound(B * W * 8 + B * T * 4 + B * 4 + B,
                       2 * W * (valid + B) + W * B)
    rows.append({
        "name": "prime_probe", "route": "cuda",
        "source": SOURCES["prime_probe"][0],
        "replaces": SOURCES["prime_probe"][1],
        "launches": path_launches["prime_probe"],
        "path": "ops.probe_verdicts, VEV Vote shapes B in (16, 64, 128, 256)",
        "run_cachex_launches": main_launches.get("prime_probe", 0),
        "max_abs_err": smoke.err["prime_probe"],
        "ms": smoke.device_ms(lambda: probe_ops.probe_verdicts(*vt)),
        "plain_ms": smoke.timeit(lambda: probe_ref.prime_probe_ref(*vt),
                                 reps=1, warmup=0),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "shape": f"({B}, {W}) x {T}", "card": card})
    for r in rows:
        print(f"time {r['name']}: {r['ms']:.4f} ms (plain {r['plain_ms']:.2f}"
              f" ms, bound {r['bound_ms']:.7f} ms by {r['bound_by']}) at "
              f"{r['shape']} on {card}")
    for s in engine_shapes:
        print(f"time cachesim_engine {s['entry']} {s['geometry']} "
              f"{tuple(s['shape'])}: {s['ms']:.4f} ms (plain "
              f"{s['plain_ms']:.2f} ms, bound {s['bound_ms']:.7f} ms by "
              f"{s['bound_by']}, {s['bytes']} bytes, touched rows "
              f"{s['touched_rows']}) on {card}")
    out["kernels"] = rows
    out["phases"]["total_s"] = time.perf_counter() - t_all
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1) + "\n")
    print(f"total: {out['phases']['total_s']:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
