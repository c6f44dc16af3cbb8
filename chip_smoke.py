#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (`src/repro_torch`) on one card.

    python3 chip_smoke.py [--out results.json]

Four phases, in order; any failure exits non-zero:

1. build   — compiles every CUDA source of the port with nvcc for sm_90a
             (one nvcc each, in parallel) and prints the build seconds,
             ptxas's register report and the card's name and power limit;
2. kernels — holds each kernel against its plain PyTorch version on the
             card: `lru_sets` and `prime_probe` (bit for bit) at the shapes
             of tests/test_kernels.py, at the main path's shapes (and
             `lru_sets` at the widths and lengths of the card tests, 1 to
             300 ways, 1 to 128 steps), and
             against the engine's batched lanes on a single-level geometry;
             the engine (bit for bit) at all four entry points, under lru
             and random replacement, inclusive and non-inclusive
             hierarchies, on the six registered platforms and the paper's
             Table 1 geometry, each through the design
             `cachesim._engine_plan` picks (state in shared memory, or
             rows copied on first touch), and on skylake_sp once more
             through the forced copy-on-touch design; `flash_attention`
             against `attention_ref` and
             `ssd_scan` against its plain version and the model's
             `ssd_chunked_ref` (within stated tolerances) at the shapes of
             tests/test_kernels.py, a ragged head-dim-80 case, head dims
             40 and 96, Sq != Sk, a GQA group of 8, (B, S, H, D) views
             whose strides are off the 16-byte grid, one chunk, chunks of
             96, p = 32 with n = 128 and the zamba2-2.7b / mamba2-2.7b
             prefill shapes; `triad` against `triad_ref` (bit for bit) at
             the shapes of tests/test_kernels.py, the monitor's 64 MiB
             probe (43,688 rows) and 1 GiB;
3. main    — four paths, each check with the launch counters set to 0
             just before it and read just after:
             (i) `run_cachex("skylake_sp")`: the report must equal
             tests/data/torch_golden_run_cachex_skylake_sp.json, the engine
             kernel must have launched once per engine call (361) and the
             plain engine never; then the two LRU kernels through their own
             entry points (`simulate_rows`, `probe_verdicts`) at the main
             path's shapes; then `run_matrix` on each of the six
             platforms against the goldens the JAX package wrote, the
             engine launched once a physical dispatch;
             (iv) the closed loop: `vtop.infer_llc_domains` on
             skylake_sp's fleet guest equal to the hypercall map;
             `run_fleet_matrix()` (six platforms x four policy/CAP
             combos, lockstep) equal to the golden (rel 1e-5 on the
             four fields through `fleet_interval_progress`, exact
             elsewhere), Fig 10 on 6/6 platforms and CAP's working-set
             latency under half of CAP off's; the 18-interval attack
             fleet equal to its golden, one defense, no false drift;
             `ShardedFleet("skylake_sp", 64)` with the automatic shard,
             64 and 8, per guest bit-identical; `tune_lowering`
             measured on the card for skylake_sp and milan_ccx; a tuned
             skylake_sp fleet equal to the untuned golden; the plan cost
             model's three constants measured for the engine;
             (ii) serving zamba2-2.7b at full width and depth (54 layers,
             d_model 2560, f32 weights from a seeded torch.Generator on the
             card): `lm.prefill` of 2 x 2048 tokens in f32 and in bf16,
             each with 9 `flash_attention` launches, 54 `ssd_scan` calls
             of 4 launches each and no plain call, held against
             `impl="ref"`; then `ServeEngine` answers 6 requests of
             256-token prompts (two waves of 4 slots, 8 new tokens each)
             in f32, its first tokens held against the kernel prefill's
             argmax, and again in bf16;
             (iii) training qwen1.5-0.5b at full width and depth (24
             layers, d_model 1024, vocab 151,936; f32 weights from a seeded
             torch.Generator on the card), which must start with at most
             1 GiB left allocated by the phases before it: `Trainer.run`
             for 5 steps of 8 x 2048 tokens in 2 microbatches, bf16, remat
             "full", with `PodMonitor(1)` timing the `triad` kernel
             between steps; finite losses, the first near ln(vocab), one
             triad launch per probe besides the monitor's calibration of
             its nominal at the first probe (the best of five idle triads
             at each of the 7 sizes its shrink can reach, 64 MiB to 1
             MiB; at 64 MiB at least 0.7 of the spec bandwidth), none
             after it, and no
             plain triad, tier 0 and an EWMA below 1.15 at every
             probe of the idle card, a plan every step, a 7.4 GB
             checkpoint written and deleted; the monitor's slowdowns on
             the idle card, while a second CUDA stream copies 1 GiB
             device to device in a loop (where a fresh monitor's first
             probe must warn of a contended nominal; the idle run must
             not), and after it, the monitor shrinking and restoring its
             probe as shipped; then a restart check
             on reduced qwen1.5-0.5b (2 steps, resume, equal to 4
             continuous steps, deterministic algorithms) and an
             accumulation check at full width in f32 (1 vs 2
             microbatches, grad_norm within rel 2e-3);
4. times   — times each kernel with CUDA events at the main path's shapes
             beside its plain version, its bound and the PyTorch library
             call where one exists (the engine also at the Table 1
             geometry, with its design, time a step and the state bytes
             its design moves; `lru_sets` also at 8192 x 8 x 128 and 1024
             x 16 x 512, with its time a step beside one warp touch's
             latency; the triad also at 256 MiB and 1 GiB, and from a cold
             L2; the SSD's four stages by torch.profiler, profiled up to
             three times and any stage still missing named as lost), and
             prints one `{"kernels": [...]}` line.

Before the kernels line, a `cost constants:` line; the line before the
last is `nvidia-smi`'s name and power limit of the card; the last line is
`{"ok": true, "device": {...}}`.  Without a CUDA
device the script exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import gc
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
import warnings
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
GOLDEN = ROOT / "tests" / "data" / "torch_golden_run_cachex_skylake_sp.json"
MAIN_PATH_ENGINE_CALLS = 361      # 308 access_streams_batched + 53 access_stream
# H100 SXM published peaks: HBM bytes/s, the 32-bit rate outside the tensor
# cores (integer compares, f32 FMAs), and the dense bf16 tensor-core rate.
HBM_BYTES_PER_S = 3.35e12
ALU_OPS_PER_S = 67e12
BF16_FLOPS_PER_S = 989e12

# Kernel vs plain version, float kernels: tests/test_kernels.py:15's
# tolerances (f32 2e-5, bf16 2e-2).  Both sides compute in full f32 (no
# TF32) and differ only in the order of their sums; bf16 outputs may round
# one ulp (2^-8 relative) apart.
FA_TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
          "bfloat16": dict(rtol=2e-2, atol=2e-2)}
SSD_TOL = dict(rtol=2e-5, atol=2e-5)
# At the full prefill shapes each y sums up to 128 x 64 products and each
# state carries 16 chunks of them, so the two orders drift further apart:
# 1e-4 (about 1700 f32 ulps at 1).
SSD_TOL_FULL = dict(rtol=1e-4, atol=1e-4)
# zamba2-2.7b's attention at the prefill shape: (B, Sq, Sk, Hq, Hkv, D)
ZAMBA_ATTN = (2, 2048, 2048, 32, 32, 80)

SOURCES = {
    "cachesim_engine": ("src/repro_torch/csrc/cachesim_engine.cu",
                        "src/repro/core/cachesim.py:294"),
    "lru_sets": ("src/repro_torch/csrc/cachesim_step.cu",
                 "src/repro/kernels/cachesim_step/kernel.py:44"),
    "prime_probe": ("src/repro_torch/csrc/cache_probe.cu",
                    "src/repro/kernels/cache_probe/kernel.py:80"),
    "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention/kernel.py:80"),
    "ssd_scan": ("src/repro_torch/csrc/ssd_scan.cu",
                 "src/repro/kernels/ssd_scan/kernel.py:87"),
    "triad": ("src/repro_torch/csrc/triad.cu",
              "src/repro/kernels/cache_probe/kernel.py:32"),
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
        self.err_by = {}                      # the same per (kernel, tag)
        self.checks = {k: 0 for k in SOURCES}
        self.triad_library_gap = 0.0         # torch.addcmul vs the kernel
        self.engine_designs = {}              # geometry -> engine design

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

    def close(self, kernel: str, what: str, got, want, rtol: float,
              atol: float, tag: str = "") -> float:
        """Float results: ``|got - want| <= atol + rtol * |want|``
        everywhere and both finite; records the max abs error (also per
        ``tag``, e.g. the dtype)."""
        torch = self.torch
        got, want = got.float(), want.float()
        if got.shape != want.shape:
            raise AssertionError(f"{kernel} {what}: shape {tuple(got.shape)}"
                                 f" != {tuple(want.shape)}")
        if not (torch.isfinite(got).all() and torch.isfinite(want).all()):
            raise AssertionError(f"{kernel} {what}: non-finite values")
        diff = (got - want).abs()
        err = float(diff.max()) if diff.numel() else 0.0
        self.err[kernel] = max(self.err[kernel], err)
        by = self.err_by.setdefault(kernel, {})
        by[tag] = max(by.get(tag, 0.0), err)
        self.checks[kernel] += 1
        bad = int((diff > atol + rtol * want.abs()).sum())
        if bad:
            raise AssertionError(f"{kernel} {what}: {bad} of {diff.numel()}"
                                 f" values beyond rtol {rtol} atol {atol} "
                                 f"(max abs err {err:.3g})")
        return err

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
        # the card tests' widths and lengths (tests/test_torch_gpu.py): every
        # row holder of the warp design, streams across chunks of 32, 37
        # rows, tied ages, -1 runs mid-stream, two clocks
        for W in (1, 4, 8, 11, 16, 32, 33, 40, 100, 200, 300):
            for T in (1, 31, 32, 33, 128):
                tags, age, streams = self.lru_edge_rows(37, W, T)
                for clock0 in (1, 1000):
                    self._lru_pair(ops, ref, tags, age, streams, clock0,
                                   f"edges {W} ways x {T} at {clock0}")
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

    @staticmethod
    def lru_edge_rows(rows: int, W: int, T: int):
        """Rows full and half empty with repeated blocks and many tied
        ages, and streams of hits and misses with -1 runs mid-stream
        (tests/test_torch_gpu.py's width test takes its inputs from
        here)."""
        rng = np.random.default_rng(W * 1000 + T)
        tags = rng.permutation(np.arange(rows * W) % (3 * W + 1)).astype(
            np.int32).reshape(rows, W)
        tags[rows // 2:, W // 2:] = -1
        age = rng.integers(0, 4, (rows, W)).astype(np.int32)
        streams = rng.integers(0, 3 * W + 1, (rows, T)).astype(np.int32)
        streams[rng.random((rows, T)) < 0.15] = -1
        streams[::3, T // 3: T // 3 + 5] = -1
        return tags, age, streams

    @staticmethod
    def lru_random_rows(rows: int, W: int, T: int, seed: int = 4):
        """Rows a fifth empty with ages below 1000, and streams over 4 W
        blocks, a tenth of the steps -1."""
        rng = np.random.default_rng(seed)
        tags = rng.integers(0, 4 * W, (rows, W)).astype(np.int32)
        tags[rng.random((rows, W)) < 0.2] = -1
        age = rng.integers(0, 1000, (rows, W)).astype(np.int32)
        streams = rng.integers(0, 4 * W, (rows, T)).astype(np.int32)
        streams[rng.random((rows, T)) < 0.1] = -1
        return tags, age, streams

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
        """The six registered platforms and the paper's Table 1 geometry."""
        from repro_torch.core import cachesim
        from repro_torch.core.platforms import get_platform, list_platforms
        out = {name: get_platform(name).machine()
               for name in list_platforms()}
        out["table1"] = cachesim.MachineGeometry(
            l2=cachesim.SKYLAKE_L2, llc=cachesim.skylake_llc(20))
        return out

    def engine_stream(self, geom, T: int, rng, lines: int):
        blocks = rng.integers(0, lines, T).astype(np.int32)
        blocks[rng.random(T) < 0.1] = -1
        cores = rng.integers(0, geom.n_cores, T).astype(np.int32)
        cot = rng.random(T) < 0.2
        return blocks, cores, cot

    def check_engine(self):
        """Every geometry through the design the plan picks (skylake_sp
        and Table 1 with 128 and 8 lanes, the other five platforms with
        32), then skylake_sp through the copy-on-touch design, forced by
        a shared-memory budget of 0 in every engine call of the case."""
        import functools
        from repro_torch.core import cachesim
        geoms = self.geometries()
        cases = [(gname, base, False) for gname, base in geoms.items()]
        cases.append(("skylake_sp", geoms["skylake_sp"], True))
        launch = cachesim._engine_cuda
        for gname, base, forced in cases:
            lines = 3 * base.llc.n_lines
            B = {"skylake_sp": 128, "table1": 8}.get(gname, 32)
            budget = 0 if forced else cachesim.SMEM_BUDGET
            design = cachesim._engine_plan(base, 128, False, budget).design
            self.engine_designs[f"{gname}{' forced' if forced else ''}"] = \
                design
            for repl in ("lru", "random"):
                for incl in ("inclusive", "non_inclusive"):
                    geom = dataclasses.replace(base, replacement=repl,
                                               inclusion=incl)
                    tag = f"{gname} {repl} {incl}"
                    rng = np.random.default_rng(
                        len(tag) + 7 * (repl == "lru") + 3 * forced)
                    tag += f" ({design})"
                    cachesim._engine_cuda = functools.partial(
                        launch, smem_budget=budget)
                    try:
                        self._engine_case(cachesim, geom, tag, rng, lines,
                                          B=B)
                    finally:
                        cachesim._engine_cuda = launch

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

    # -- phase 2d: the LM kernels -------------------------------------------------
    def randn(self, shape, seed: int, dtype=None, scale: float = 1.0):
        """Seeded normal values made on the card (torch.Generator)."""
        torch = self.torch
        g = torch.Generator(device=self.dev).manual_seed(seed)
        x = torch.randn(shape, generator=g, device=self.dev) * scale
        return x.to(dtype or torch.float32)

    def check_flash_attention(self):
        from repro_torch.kernels.flash_attention import kernel, ops, ref
        torch = self.torch
        cases = [  # (B, Sq, Sk, Hq, Hkv, D, causal)
            (1, 128, 128, 2, 2, 64, True),    # tests/test_kernels.py sweep
            (2, 256, 256, 4, 2, 64, True),
            (1, 256, 256, 4, 1, 128, True),
            (2, 128, 128, 2, 2, 128, False),
            (1, 384, 384, 6, 2, 64, True),
            (1, 200, 200, 4, 2, 80, True),    # ragged S, zamba2's head dim
            (2, 200, 200, 4, 4, 80, False),
            (1, 256, 256, 4, 2, 40, True),    # head dims padded in shared
            (2, 192, 192, 2, 2, 96, True),    # memory: 40 -> 48, 96
            (1, 128, 384, 4, 2, 64, True),    # Sq != Sk
            (1, 128, 384, 4, 2, 64, False),
            (2, 256, 256, 16, 2, 64, True),   # a GQA group of 8
            (*ZAMBA_ATTN, True)]              # the zamba2 prefill shape
        for i, (B, Sq, Sk, Hq, Hkv, D, causal) in enumerate(cases):
            for dtype in (torch.float32, torch.bfloat16):
                q = self.randn((B, Hq, Sq, D), 3 * i, dtype)
                k = self.randn((B, Hkv, Sk, D), 3 * i + 1, dtype)
                v = self.randn((B, Hkv, Sk, D), 3 * i + 2, dtype)
                name = str(dtype)[6:]
                tag = name + (" zamba2 shape" if i == len(cases) - 1 else "")
                what = (f"({B},{Hq}/{Hkv},{Sq}x{Sk},{D}) causal={causal} "
                        f"{name}")
                self.close("flash_attention", what,
                           kernel.flash_attention_bhsd(q, k, v, causal=causal),
                           ref.attention_ref(q, k, v, causal),
                           **FA_TOL[name], tag=tag)
                # the model layout, through strided views
                out = ops.flash_attention(q.transpose(1, 2),
                                          k.transpose(1, 2),
                                          v.transpose(1, 2), causal)
                self.close("flash_attention", what + " (B,S,H,D)",
                           out.transpose(1, 2),
                           ref.attention_ref(q, k, v, causal),
                           **FA_TOL[name], tag=tag)
        # (B, S, H, D) views of wider rows: sequence and head strides off
        # the 16-byte grid, so the kernel's loader copies element by
        # element instead of 16 bytes at a time
        B, S, H = 2, 160, 3
        for j, (D, causal) in enumerate(((64, True), (80, False))):
            for dtype in (torch.float32, torch.bfloat16):
                name = str(dtype)[6:]
                qkv = [self.randn((B, S, H, D + 1), 100 + 3 * j + u,
                                  dtype)[..., :D] for u in range(3)]
                self.close("flash_attention",
                           f"({B},{S},{H},{D}) view, seq stride "
                           f"{qkv[0].stride(1)} causal={causal} {name}",
                           ops.flash_attention(*qkv, causal).transpose(1, 2),
                           ref.attention_ref(*(t.transpose(1, 2)
                                               for t in qkv), causal),
                           **FA_TOL[name], tag=name)

    def check_ssd_scan(self):
        from repro_torch.kernels.ssd_scan import kernel, ops, ref
        from repro_torch.models import mamba2
        torch = self.torch
        cases = [  # (b, S, h, p, n, chunk, tolerance)
            (1, 128, 4, 32, 16, 32, SSD_TOL),     # tests/test_kernels.py
            (2, 256, 8, 64, 32, 64, SSD_TOL),
            (1, 256, 8, 64, 128, 128, SSD_TOL),
            (2, 64, 2, 32, 16, 64, SSD_TOL),
            (2, 128, 4, 64, 64, 128, SSD_TOL),    # one chunk
            (1, 384, 8, 64, 64, 96, SSD_TOL),     # chunks of 96
            (2, 512, 8, 32, 128, 128, SSD_TOL),   # p = 32 with n = 128
            (2, 2048, 80, 64, 64, 128, SSD_TOL_FULL),   # zamba2-2.7b
            (2, 2048, 80, 64, 128, 128, SSD_TOL_FULL)]  # mamba2-2.7b
        for i, (b, S, h, p, n, chunk, tol) in enumerate(cases):
            x = self.randn((b, S, h, p), 10 * i)
            dt = self.randn((b, S, h), 10 * i + 1, scale=0.5)
            A = -torch.exp(self.randn((h,), 10 * i + 2, scale=0.3))
            Bm = self.randn((b, S, n), 10 * i + 3, scale=0.3)
            Cm = self.randn((b, S, n), 10 * i + 4, scale=0.3)
            D = self.randn((h,), 10 * i + 5)
            what = f"(b={b}, S={S}, h={h}, p={p}, n={n}, chunk={chunk})"
            tag = "float32" + (" full shape" if S == 2048 else "")
            y, st = ops.ssd_scan(x, dt, A, Bm, Cm, D, chunk=chunk)
            y_r, st_r = mamba2.ssd_chunked_ref(x, dt, A, Bm, Cm, D, chunk)
            self.close("ssd_scan", what + " y vs ssd_chunked_ref", y, y_r,
                       **tol, tag=tag)
            self.close("ssd_scan", what + " state vs ssd_chunked_ref", st,
                       st_r, **tol, tag=tag)
            # the kernel's own function against its plain version
            nc = S // chunk
            dtv = torch.nn.functional.softplus(dt)
            grid = (x.reshape(b, nc, chunk, h, p).permute(0, 3, 1, 2, 4),
                    dtv.reshape(b, nc, chunk, h).permute(0, 3, 1, 2),
                    (dtv * A).reshape(b, nc, chunk, h).permute(0, 3, 1, 2),
                    Bm.reshape(b, nc, chunk, n), Cm.reshape(b, nc, chunk, n))
            grid = [g.contiguous() for g in grid]
            for name, a, r in zip(("y", "state"),
                                  kernel.ssd_scan_grid(*grid),
                                  ref.ssd_scan_grid_ref(*grid)):
                self.close("ssd_scan", f"{what} grid {name}", a, r, **tol,
                           tag=tag)
            if i < 4:   # bf16 inputs: cast to f32 before the kernel
                xb, Bb, Cb = (t.to(torch.bfloat16) for t in (x, Bm, Cm))
                dtb = dt.to(torch.bfloat16)
                y, _ = ops.ssd_scan(xb, dtb, A, Bb, Cb, D, chunk=chunk)
                y_r, _ = mamba2.ssd_chunked_ref(xb, dtb, A, Bb, Cb, D, chunk)
                self.close("ssd_scan", what + " bf16 y", y, y_r,
                           **FA_TOL["bfloat16"], tag="bfloat16 inputs")

    # -- phase 2e: triad ---------------------------------------------------------
    def check_triad(self):
        """Bit for bit against `triad_ref` (two roundings each): the shapes
        of tests/test_kernels.py:236, the monitor's 64 MiB probe and 1
        GiB (rows as `measure_hbm_bandwidth` makes them), a ragged and a
        misaligned flat case; and `torch.addcmul` (which may fuse the
        multiply-add) within one ulp of the product plus one of the
        result."""
        from repro_torch.kernels.cache_probe import kernel, ref
        torch = self.torch
        cases = [(rows, "test_kernels") for rows in (512, 1024, 64)]
        cases += [(triad_rows(TRIAD_MONITOR_BYTES), "monitor 64 MiB"),
                  (triad_rows(1 << 30), "1 GiB")]
        for i, (rows, what) in enumerate(cases):
            if what == "test_kernels":
                a = torch.arange(rows * 128, dtype=torch.float32,
                                 device=self.dev).reshape(rows, 128)
                b = torch.full((rows, 128), 2.0, device=self.dev)
                s = torch.tensor([3.0], device=self.dev)
                self.exact("triad", f"{what} {rows} rows",
                           kernel.triad(a, b, s), ref.triad_ref(a, b, s))
            a = self.randn((rows, 128), 200 + i)
            b = self.randn((rows, 128), 300 + i)
            s = torch.tensor([1.0 / 3.0], device=self.dev)
            got = kernel.triad(a, b, s)
            self.exact("triad", f"{what} {rows} rows random", got,
                       ref.triad_ref(a, b, s))
            lib = torch.addcmul(b, a, s)
            self.triad_library_gap = max(self.triad_library_gap,
                                          fma_gap(lib, got, a * s))
            del a, b, got, lib
        # 4099 elements: float4s and a tail of 3 on 16-byte aligned
        # pointers, then the scalar path on pointers off that grid
        flat = self.randn((3 * 4100,), 400)
        s = torch.tensor([-2.5], device=self.dev)
        for lo, what in ((0, "ragged"), (1, "misaligned")):
            a, b = flat[lo:lo + 4099], flat[4100 + lo:8199 + lo]
            self.exact("triad", f"{what} flat 4099", kernel.triad(a, b, s),
                       ref.triad_ref(a, b, s))
        if self.triad_library_gap > 1:
            raise AssertionError(f"torch.addcmul differs from the triad by "
                                 f"{self.triad_library_gap:.3g} of its "
                                 f"rounding bound (> 1)")

    def exact(self, kernel: str, what: str, got, want) -> None:
        """Float results equal bit for bit."""
        if got.shape != want.shape or got.dtype != want.dtype:
            raise AssertionError(f"{kernel} {what}: {tuple(got.shape)} "
                                 f"{got.dtype} != {tuple(want.shape)} "
                                 f"{want.dtype}")
        err = float((got - want).abs().max()) if got.numel() else 0.0
        self.err[kernel] = max(self.err[kernel], err)
        self.checks[kernel] += 1
        if not self.torch.equal(got, want):
            bad = int((got != want).sum())
            raise AssertionError(f"{kernel} {what}: {bad} of {got.numel()} "
                                 f"values differ from the plain version "
                                 f"(max abs err {err:.3g})")


# the monitor's default probe size and the row arithmetic of
# `measure_hbm_bandwidth` (three f32 streams, rows of 128, multiple of 8)
TRIAD_MONITOR_BYTES = 64 * (1 << 20)


def triad_rows(n_bytes: int) -> int:
    return max(8, (n_bytes // 4 // 3 // 128) // 8 * 8)


def fma_gap(lib, got, prod) -> float:
    """|lib - got| as a share of what one fused multiply-add may differ
    from a rounded product and a rounded sum: half an ulp of the product
    and half an ulp of each result, so at most one ulp of the product plus
    one of the larger result.  (Under cancellation the two can be many
    ulps of the result apart, so the result's ulp alone is no bound.)"""
    import torch
    inf = torch.tensor(float("inf"), device=got.device)

    def ulp(t):
        t = t.abs()
        return torch.nextafter(t, inf) - t
    bound_ = ulp(prod) + ulp(torch.maximum(lib.abs(), got.abs()))
    return float(((lib - got).abs() / bound_).max()) if got.numel() else 0.0


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


# -- the LM serving path (zamba2-2.7b at full width and depth) ----------------------

SERVE_ARCH = "zamba2_2p7b"
PREFILL_B, PREFILL_S = 2, 2048
SERVE_REQUESTS, SERVE_PROMPT, SERVE_NEW, SERVE_SLOTS = 6, 256, 8, 4
# kernel calls of one zamba2-2.7b prefill: 54 // 6 = 9 shared attention
# blocks, 54 Mamba2 layers (each `ssd_scan` call is
# `ssd_scan.kernel.LAUNCHES_PER_CALL` launches)
PREFILL_CALLS = {"flash_attention": 9, "ssd_scan": 54}
# Logits, kernel prefill vs `impl="ref"` prefill on the card.  f32: two
# implementations of attention and of the SSD scan whose sums differ in
# order (about 1e-6 relative each); 63 residual blocks carry that into
# logits of magnitude about 5, so 2e-3 leaves a margin of 100x and still
# catches a wrong mask or decay (those move logits by 0.1 or more).  bf16:
# the kernels must add no more error than bf16 compute itself makes on
# this input, so the bound is max |ref prefill in bf16 - kernel prefill in
# f32|, measured in the same run (every matmul and block output there
# rounds to 8 significant bits; the kernel and the ref path differ only
# where one attention or SSD output rounds one ulp apart).
PREFILL_TOL_F32 = 2e-3
# Logits after the last prompt token, teacher-forced decode (recurrent SSD
# step, attention over the cache) vs the kernel prefill, f32: the same
# function computed two ways, as above.
DECODE_TOL = 2e-3


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _timed_kernels(events):
    """Patch the LM kernel wrappers seen by their `ops` modules so each
    launch is bracketed by CUDA events (appended to ``events[name]``);
    returns a function that undoes the patch."""
    import repro_torch.kernels.flash_attention.ops as fa_ops
    import repro_torch.kernels.ssd_scan.ops as ssd_ops
    import torch
    saved = (fa_ops.flash_attention_bhsd, ssd_ops.ssd_scan_grid)

    def timed(name, fn):
        def call(*a, **kw):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            res = fn(*a, **kw)
            end.record()
            events.setdefault(name, []).append((start, end))
            return res
        return call

    fa_ops.flash_attention_bhsd = timed("flash_attention", saved[0])
    ssd_ops.ssd_scan_grid = timed("ssd_scan", saved[1])

    def undo():
        fa_ops.flash_attention_bhsd, ssd_ops.ssd_scan_grid = saved
    return undo


def profile_decode(smoke, cfg, params, prompts, max_len, step_s,
                   steps: int = 4):
    """Device work of a few f32 decode steps of the engine's shape, from
    torch.profiler: kernels launched and device-busy time per step, beside
    the engine's own wall per step (``step_s``)."""
    torch = smoke.torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import lm
    caches = lm.init_caches(cfg, SERVE_SLOTS, max_len, torch.float32,
                            device=smoke.dev)
    toks = torch.as_tensor(prompts[:SERVE_SLOTS, :1], device=smoke.dev)
    _, caches = lm.decode_step(cfg, params, caches, toks, 0, torch.float32)
    smoke.sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for pos in range(1, steps + 1):
            _, caches = lm.decode_step(cfg, params, caches, toks, pos,
                                       torch.float32)
        smoke.sync()
    busy_us, kernels = 0.0, 0
    for e in prof.key_averages():
        # the kernels themselves (a CPU op's device time repeats theirs)
        if str(e.device_type).endswith("CUDA"):
            busy_us += e.self_device_time_total
            kernels += e.count
    out = {"steps": steps, "kernels_per_step": kernels / steps,
           "device_busy_ms_per_step": busy_us / 1e3 / steps,
           "engine_wall_ms_per_step": step_s * 1e3}
    out["device_busy_share"] = (out["device_busy_ms_per_step"]
                                / out["engine_wall_ms_per_step"])
    print(f"serve: torch.profiler over {steps} f32 decode steps: "
          f"{out['kernels_per_step']:.0f} kernels and "
          f"{out['device_busy_ms_per_step']:.2f} ms of device time a step, "
          f"against {out['engine_wall_ms_per_step']:.1f} ms of engine wall "
          f"a step (device busy {100 * out['device_busy_share']:.1f}%"
          + ("" if kernels else "; the profiler saw no device activity")
          + ")")
    return out


def serve_main_path(smoke, card):
    """Phase 3 (ii): prefill and serve zamba2-2.7b at full width/depth."""
    torch = smoke.torch
    from repro_torch import _build
    from repro_torch.configs.base import get_config
    from repro_torch.kernels.ssd_scan.kernel import LAUNCHES_PER_CALL
    from repro_torch.models import lm
    from repro_torch.serve.engine import Request, ServeEngine
    cfg = get_config(SERVE_ARCH)
    expected = {"flash_attention": PREFILL_CALLS["flash_attention"],
                "ssd_scan": PREFILL_CALLS["ssd_scan"] * LAUNCHES_PER_CALL}
    t0 = time.perf_counter()
    params = lm.init_params(
        cfg, torch.Generator(device=smoke.dev).manual_seed(0),
        device=smoke.dev)
    smoke.sync()
    res = {"config": cfg.name, "n_layers": cfg.n_layers,
           "d_model": cfg.d_model,
           "n_params": sum(t.numel() for t in _leaves(params)),
           "init_s": time.perf_counter() - t0, "card": card}
    print(f"serve: {cfg.name} at full width and depth ({cfg.n_layers} "
          f"layers, d_model {cfg.d_model}, {res['n_params']:,} f32 "
          f"parameters) made on the card in {res['init_s']:.1f} s")
    rng = np.random.default_rng(0)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab, (
        PREFILL_B, PREFILL_S)).astype(np.int32), device=smoke.dev)
    batch = {"tokens": tokens}
    f32_logits = None
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype)[6:]
        _build.reset_counters()
        t0 = time.perf_counter()
        lk = lm.prefill(cfg, params, batch, dtype, "kernel",
                        device=smoke.dev)
        smoke.sync()
        wall = time.perf_counter() - t0
        launches, plain = dict(_build.LAUNCHES), dict(_build.PLAIN_CALLS)
        if launches != expected or plain:
            raise AssertionError(f"prefill {name}: launches {launches}, "
                                 f"plain calls {plain}; expected "
                                 f"{expected} and none")
        t0 = time.perf_counter()
        lr = lm.prefill(cfg, params, batch, dtype, "ref",
                        device=smoke.dev)
        smoke.sync()
        wall_ref = time.perf_counter() - t0
        want = (PREFILL_B, 1, cfg.vocab_padded)
        if tuple(lk.shape) != want or not bool(torch.isfinite(lk).all()):
            raise AssertionError(f"prefill {name}: logits {tuple(lk.shape)}"
                                 f", finite {bool(torch.isfinite(lk).all())}")
        err = float((lk - lr).abs().max())
        if f32_logits is None:
            f32_logits, tol = lk, PREFILL_TOL_F32
        else:
            tol = float((lr - f32_logits).abs().max())
        if err > tol:
            raise AssertionError(f"prefill {name}: kernel vs ref max abs "
                                 f"logit diff {err:.3g} > {tol:.3g}")
        # where the time goes: the same prefill again, with CUDA events
        # around the whole call and around each kernel launch
        events = {}
        undo = _timed_kernels(events)
        try:
            span = (torch.cuda.Event(enable_timing=True),
                    torch.cuda.Event(enable_timing=True))
            t0 = time.perf_counter()
            span[0].record()
            lm.prefill(cfg, params, batch, dtype, "kernel",
                        device=smoke.dev)
            span[1].record()
            smoke.sync()
            warm = time.perf_counter() - t0
        finally:
            undo()
        kern = {k: sum(a.elapsed_time(b) for a, b in v)
                for k, v in events.items()}
        span_ms = span[0].elapsed_time(span[1])
        res[f"prefill_{name}"] = {
            "launches": launches, "plain_calls": plain,
            "logits_max_abs": float(lk.abs().max()),
            "max_abs_diff_vs_ref": err, "tol": tol,
            "wall_s": wall, "wall_ref_s": wall_ref, "warm_wall_s": warm,
            "events_span_ms": span_ms, "kernel_event_ms": kern,
            "other_ms": span_ms - sum(kern.values())}
        print(f"serve: prefill {PREFILL_B}x{PREFILL_S} {name}: launches "
              f"{launches}, plain calls {plain}; kernel vs ref max |logit "
              f"diff| {err:.3g} (tol {tol:.3g}, logits up to "
              f"{float(lk.abs().max()):.2f}); wall {wall:.3f} s (first), "
              f"{warm:.3f} s (again, with events), ref {wall_ref:.3f} s; "
              f"event span {span_ms:.1f} ms of which flash_attention "
              f"{kern.get('flash_attention', 0):.1f} ms, ssd_scan "
              f"{kern.get('ssd_scan', 0):.1f} ms on {card}")

    # the engine: 6 requests of 256-token prompts, two waves of 4 slots
    prompts = rng.integers(0, cfg.vocab, (SERVE_REQUESTS, SERVE_PROMPT)
                           ).astype(np.int32)
    _build.reset_counters()
    pre = lm.prefill(cfg, params, {"tokens": prompts}, torch.float32,
                     "kernel", device=smoke.dev)[:, 0]
    smoke.sync()
    if dict(_build.LAUNCHES) != expected or _build.PLAIN_CALLS:
        raise AssertionError(f"prompt prefill launches "
                             f"{dict(_build.LAUNCHES)}")
    top2 = pre.topk(2, dim=-1).values
    margin = (top2[:, 0] - top2[:, 1]).cpu().numpy()
    pre_arg = pre.argmax(dim=-1).cpu().numpy()
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype)[6:]
        eng = ServeEngine(cfg, params, batch_slots=SERVE_SLOTS,
                          max_len=SERVE_PROMPT + SERVE_NEW + 8, dtype=dtype,
                          device=smoke.dev)
        decode, first, steps = eng._decode, [], [0]
        finite = []

        def capture(caches, toks, pos, decode=decode, first=first,
                    steps=steps, finite=finite):
            lg, caches = decode(caches, toks, pos)
            steps[0] += 1
            finite.append(torch.isfinite(lg).all())
            if pos == SERVE_PROMPT - 1:
                first.append(lg[:, -1].float().clone())
            return lg, caches

        eng._decode = capture
        for rid in range(SERVE_REQUESTS):
            eng.submit(Request(rid=rid, prompt=prompts[rid],
                               max_new=SERVE_NEW))
        _build.reset_counters()
        t0 = time.perf_counter()
        done = {r.rid: r.out for r in eng.run_until_drained()}
        smoke.sync()
        wall = time.perf_counter() - t0
        if sorted(done) != list(range(SERVE_REQUESTS)) or any(
                len(v) != SERVE_NEW for v in done.values()):
            raise AssertionError(f"serve {name}: tokens {done}")
        if not bool(torch.stack(finite).all()):
            raise AssertionError(f"serve {name}: non-finite logits")
        dec = torch.cat([first[0][:SERVE_SLOTS],
                         first[1][:SERVE_REQUESTS - SERVE_SLOTS]])
        diff = float((dec - pre).abs().max())
        agree = [int(done[r][0] == pre_arg[r]) for r in range(SERVE_REQUESTS)]
        entry = {"wall_s": wall, "decode_steps": steps[0],
                 "generated_tokens": SERVE_REQUESTS * SERVE_NEW,
                 "generated_tok_per_s": SERVE_REQUESTS * SERVE_NEW / wall,
                 "slot_steps_per_s": steps[0] * SERVE_SLOTS / wall,
                 "steps_per_s": steps[0] / wall,
                 "max_abs_diff_first_logits_vs_prefill": diff,
                 "first_token_equals_prefill_argmax": agree,
                 "prefill_top2_margin": margin.tolist(),
                 "launches": dict(_build.LAUNCHES),
                 "plain_calls": dict(_build.PLAIN_CALLS)}
        if dtype == torch.float32:
            if diff > DECODE_TOL:
                raise AssertionError(f"serve f32: decode vs prefill max "
                                     f"|logit diff| {diff:.3g} > "
                                     f"{DECODE_TOL}")
            for r in range(SERVE_REQUESTS):
                if margin[r] > 2 * DECODE_TOL and not agree[r]:
                    raise AssertionError(
                        f"serve f32: request {r} first token {done[r][0]} "
                        f"!= prefill argmax {pre_arg[r]} (margin "
                        f"{margin[r]:.3g})")
        res[f"serve_{name}"] = entry
        if dtype == torch.float32:
            entry["profile"] = profile_decode(smoke, cfg, params, prompts,
                                              eng.max_len, wall / steps[0])
        print(f"serve: ServeEngine {name}, {SERVE_REQUESTS} requests x "
              f"{SERVE_PROMPT}-token prompts, {SERVE_NEW} new tokens, "
              f"{SERVE_SLOTS} slots: {steps[0]} decode steps in {wall:.2f} "
              f"s ({steps[0] / wall:.1f} steps/s, "
              f"{SERVE_REQUESTS * SERVE_NEW / wall:.2f} generated tok/s); "
              f"first tokens equal the kernel prefill's argmax for "
              f"{sum(agree)}/{SERVE_REQUESTS} (top-2 margins "
              f"{np.round(margin, 3).tolist()}); max |decode - prefill| "
              f"logit {diff:.3g} on {card}")
        # the capture held the engine's bound decode, and the engine held
        # the capture: drop the cycle so the weights go with the engine
        del eng._decode
        del eng, capture, decode, first, finite, dec
    del params, tokens, batch, lk, lr, f32_logits, pre, top2
    gc.collect()
    torch.cuda.empty_cache()
    return res


# -- the training path (qwen1.5-0.5b at full width and depth) -----------------------

TRAIN_ARCH = "qwen1p5_0p5b"
TRAIN_SEQ, TRAIN_BATCH, TRAIN_MICRO, TRAIN_STEPS = 2048, 8, 2, 5
# Random weights give small logits, so the first softmax is near uniform
# and the first loss near ln(vocab) = 11.93 (reduced qwen on the CPU starts
# at 6.73 against ln 512 = 6.24).
FIRST_LOSS_TOL = 2.0
# 1 vs 2 microbatches at full width in f32: the same gradient summed in
# another order (tests/test_train_integration.py:64's 2e-3).
ACCUM_RTOL = 2e-3
# Restart vs continuous run under deterministic algorithms: the same
# computation in the same order, so equal; 1e-5 as in the CPU test.
RESTART_RTOL = 1e-5
# What earlier phases may leave allocated when training starts: their
# small tensors, not the serving phase's 9.4 GiB of zamba2 weights.
TRAIN_START_MAX_BYTES = 1 << 30
# Probes in each third of the monitor's contended window (idle, under
# the copy loop, after it), and the 1 GiB copies its second stream runs
# (about 0.72 ms each alone: they outlast the probes)
MONITOR_PROBES = 10
CONTENTION_COPIES = 1000


def matmul_params(cfg):
    """(layer weights that multiply activations: q, k, v, o and the three
    MLP matrices of every layer; the unembedding)."""
    d = cfg.d_model
    hq, hkv = cfg.n_heads_padded * cfg.head_dim, \
        cfg.n_kv_heads_eff * cfg.head_dim
    layer = 2 * d * hq + 2 * d * hkv + 3 * d * cfg.d_ff
    return layer * cfg.n_layers, d * cfg.vocab_padded


def _profile_step(smoke, step_fn, state, batch, step_s):
    """torch.profiler (device activity only) over one train step: kernels
    and device-busy time, against the median wall of the unprofiled steps
    (``step_s``; the profiled step's own wall carries the tracing)."""
    from torch.profiler import ProfilerActivity, profile
    t_all = time.perf_counter()
    smoke.sync()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        new, _ = step_fn(state, batch)
        smoke.sync()
        wall = time.perf_counter() - t0
    del new
    busy_us, kernels, by_name = 0.0, 0, []
    for e in prof.key_averages():
        if str(e.device_type).endswith("CUDA"):
            busy_us += e.self_device_time_total
            kernels += e.count
            by_name.append((e.self_device_time_total / 1e3, e.count, e.key))
    by_name.sort(reverse=True)
    return {"kernels": kernels, "device_busy_ms": busy_us / 1e3,
            "profiled_wall_ms": wall * 1e3, "step_ms": step_s * 1e3,
            "device_busy_share": busy_us / 1e3 / (step_s * 1e3),
            "profile_s": time.perf_counter() - t_all,
            "top_kernels": [{"ms": ms, "count": n, "name": k[:120]}
                            for ms, n, k in by_name[:12]]}


def train_main_path(smoke, card):
    """Phase 3 (iii): `Trainer.run` of qwen1.5-0.5b at full width and depth
    with the monitor timing the triad between steps.  The launch counters
    are set to 0 just before `run` and read just after."""
    torch = smoke.torch
    from repro_torch import _build
    from repro_torch._tree import tree_leaves
    from repro_torch.checkpoint import ckpt
    from repro_torch.configs.base import ShapeSpec, get_config
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.launch.mesh import HBM_BW
    from repro_torch.tpuprobe.monitor import (_CALIBRATION_PROBES,
                                              _IDLE_NOMINAL_MIN_SHARE,
                                              PodMonitor, _probe_sizes)
    from repro_torch.train import train_step as ts
    from repro_torch.train.trainer import Trainer, TrainerConfig
    start = torch.cuda.memory_allocated()
    print(f"train: {start / 2**30:.3f} GiB allocated on the card before the "
          f"training phase (at most {TRAIN_START_MAX_BYTES / 2**30:.0f} GiB)")
    if start > TRAIN_START_MAX_BYTES:
        raise AssertionError(f"train: {start / 2**30:.2f} GiB still allocated "
                             f"from earlier phases")
    cfg = get_config(TRAIN_ARCH)
    shape = ShapeSpec("chip_smoke", TRAIN_SEQ, TRAIN_BATCH, "train")
    hyper = ts.TrainHyper(microbatches=TRAIN_MICRO, remat="full",
                          compute_dtype=torch.bfloat16)
    t_setup = time.perf_counter()
    abstract = ts.abstract_train_state(cfg, hyper, smoke.dev)
    ckpt_bytes = sum(t.numel() * t.element_size()
                     for t in tree_leaves(abstract))
    n_params = sum(t.numel() for t in tree_leaves(abstract.params))
    res = {"config": cfg.name, "n_layers": cfg.n_layers,
           "d_model": cfg.d_model, "vocab": cfg.vocab,
           "n_params": n_params, "seq": TRAIN_SEQ, "batch": TRAIN_BATCH,
           "microbatches": TRAIN_MICRO, "steps": TRAIN_STEPS,
           "compute_dtype": "bfloat16", "remat": "full",
           "checkpoint_bytes": ckpt_bytes, "card": card}
    (ROOT / "build").mkdir(exist_ok=True)
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_ckpt_", dir=ROOT / "build")
    try:
        free = shutil.disk_usage(ckpt_dir).free
        if free < 2 * ckpt_bytes:
            raise RuntimeError(
                f"train: {free / 1e9:.1f} GB free under {ckpt_dir}, the "
                f"checkpoint needs {ckpt_bytes / 1e9:.1f} GB (twice that "
                f"is required)")
        monitor = PodMonitor(1, device=smoke.dev)     # clock=None: the card
        tr = Trainer(cfg, shape, hyper,
                     TrainerConfig(ckpt_dir=ckpt_dir, monitor_every=1,
                                   data=DataConfig(seed=0)),
                     monitor=monitor, device=smoke.dev)
        # instrumentation: the host time of each probe and of the
        # checkpoint, and the last state (for the profiled step)
        probe_s, probe_bytes, ck, last = [], [], {}, {}
        probe_tiers, probe_ewma = [], []
        probe_once, step_fn = monitor.probe_once, tr._step
        save_async, wait = tr.checkpointer.save_async, tr.checkpointer.wait

        def timed_probe():
            probe_bytes.append(monitor.probe_bytes)
            t0 = time.perf_counter()
            out = probe_once()
            probe_s.append(time.perf_counter() - t0)
            probe_tiers.append(monitor.device_tiers()[0])
            probe_ewma.append(float(monitor.ewma[0]))
            return out

        def keep_state(state, batch):
            new, metrics = step_fn(state, batch)
            last["state"] = new
            return new, metrics

        def timed_save(step, tree):
            t0 = time.perf_counter()
            save_async(step, tree)
            ck["snapshot_s"] = time.perf_counter() - t0
            ck["t0"] = t0

        def timed_wait():
            wait()
            if "t0" in ck and "write_done_s" not in ck:
                ck["write_done_s"] = time.perf_counter() - ck["t0"]

        monitor.probe_once, tr._step = timed_probe, keep_state
        tr.checkpointer.save_async = timed_save
        tr.checkpointer.wait = timed_wait
        smoke.sync()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        res["setup_s"] = time.perf_counter() - t_setup
        _build.reset_counters()
        t0 = time.perf_counter()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            log = tr.run(TRAIN_STEPS, seed=0)
        run_s = time.perf_counter() - t0
        nominal_warnings = monitor_warnings(caught)
        if nominal_warnings:
            raise AssertionError(f"train: the monitor warned of a contended "
                                 f"nominal on the idle card: "
                                 f"{nominal_warnings}")
        launches, plain = dict(_build.LAUNCHES), dict(_build.PLAIN_CALLS)
        repeats = _build.REPEATED_LAUNCHES["triad"]
        peak = torch.cuda.max_memory_allocated()
        probes = len(monitor.history)

        losses = [r["loss"] for r in log]
        if len(log) != TRAIN_STEPS or not all(map(math.isfinite, losses)):
            raise AssertionError(f"train: losses {losses}")
        if abs(losses[0] - math.log(cfg.vocab)) > FIRST_LOSS_TOL:
            raise AssertionError(f"train: first loss {losses[0]:.3f}, not "
                                 f"within {FIRST_LOSS_TOL} of ln(vocab) "
                                 f"{math.log(cfg.vocab):.2f}")
        calib = monitor._calibration_launches
        sizes = _probe_sizes(monitor.default_probe_bytes)
        want_calib = _CALIBRATION_PROBES * len(sizes)
        # a timed triad whose start event passed before the host had
        # enqueued it is taken again (`triad_device_seconds`): those
        # launches are real and counted apart
        if probes != TRAIN_STEPS \
                or not want_calib <= calib <= want_calib + repeats \
                or launches != {"triad": probes + want_calib + repeats} \
                or plain:
            raise AssertionError(f"train: {probes} probes, launches "
                                 f"{launches} ({calib} calibrating the "
                                 f"nominal, {repeats} repeating a timed "
                                 f"reading), plain calls {plain}; expected "
                                 f"one triad launch per probe besides "
                                 f"{want_calib} calibrating it "
                                 f"({_CALIBRATION_PROBES} at each of "
                                 f"{len(sizes)} sizes) and the repeats, "
                                 f"and no plain call")
        idle_share = (monitor.default_probe_bytes / HBM_BW
                      / monitor._idle_s[monitor.default_probe_bytes])
        if idle_share < _IDLE_NOMINAL_MIN_SHARE:
            raise AssertionError(f"train: the monitor's idle nominal at "
                                 f"{monitor.default_probe_bytes >> 20} MiB "
                                 f"is {idle_share:.3f} of the spec "
                                 f"{HBM_BW / 1e12:.2f} TB/s, below "
                                 f"{_IDLE_NOMINAL_MIN_SHARE}: was the card "
                                 f"busy when it calibrated?")
        if any(probe_tiers) or max(probe_ewma) >= 1.15:
            raise AssertionError(f"train: the monitor reads contention on "
                                 f"the idle card: tiers {probe_tiers}, EWMA "
                                 f"{probe_ewma}")
        if not all(r.get("mb_plan") == [TRAIN_MICRO] for r in log):
            raise AssertionError(f"train: plans {[r.get('mb_plan') for r in log]}")
        if ckpt.list_steps(ckpt_dir) != [TRAIN_STEPS]:
            raise AssertionError(f"train: checkpoints "
                                 f"{ckpt.list_steps(ckpt_dir)}")
        on_disk = sum(f.stat().st_size for f in
                      Path(ckpt_dir, f"step_{TRAIN_STEPS:08d}").iterdir())

        walls = [r["wall_s"] for r in log]
        step_s = float(np.median(walls[1:]))
        tokens = TRAIN_BATCH * TRAIN_SEQ
        p_layers, p_head = matmul_params(cfg)
        flops = 6 * (p_layers + p_head) * tokens + 2 * p_layers * tokens
        samples = [h[0] for h in monitor.history]
        probe_dt = [nb / x.effective_bw for nb, x in zip(probe_bytes, samples)]
        res["run"] = {
            "run_s": run_s, "losses": losses, "grad_norms":
            [r["grad_norm"] for r in log], "lr": [r["lr"] for r in log],
            "wall_s": walls, "median_step_s": step_s,
            "tokens_per_s": tokens / step_s,
            "model_flops_per_step": flops,
            "model_tflops_per_s": flops / step_s / 1e12,
            "bf16_peak_share": flops / step_s / BF16_FLOPS_PER_S,
            "peak_memory_bytes": peak,
            "memory_allocated_before_bytes": base, "launches": launches,
            "plain_calls": plain, "probes": probes,
            "probe_host_s": probe_s,
            "probe_share_of_step": float(np.median(probe_s)) / step_s,
            "probe_event_s": probe_dt,
            "probe_bytes_each": probe_bytes,
            "probe_effective_bw": [x.effective_bw for x in samples],
            "probe_slowdown": [x.slowdown for x in samples],
            "probe_tier": probe_tiers, "probe_ewma": probe_ewma,
            "triad_probe_launches": probes,
            "triad_calibration_launches": calib,
            "triad_repeated_launches": repeats,
            "monitor_idle_bw": {nb: nb / t for nb, t in
                                monitor._idle_s.items()},
            "monitor_idle_share_of_spec": idle_share,
            "mb_plan": [r["mb_plan"] for r in log],
            "checkpoint_snapshot_s": ck.get("snapshot_s"),
            "checkpoint_write_done_s": ck.get("write_done_s"),
            "checkpoint_bytes_on_disk": on_disk}
        res["contention"] = contended_probes(smoke, monitor, probe_once)
        batch = {k: torch.as_tensor(v, device=smoke.dev) for k, v in
                 make_batch(tr.tcfg.data, cfg, shape, TRAIN_STEPS).items()}
        res["profile"] = _profile_step(smoke, step_fn, last.pop("state"),
                                       batch, step_s)
        del tr, monitor, batch
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    torch.cuda.empty_cache()
    r, pr = res["run"], res["profile"]
    print(f"train: {cfg.name} at full width and depth ({cfg.n_layers} "
          f"layers, d_model {cfg.d_model}, vocab {cfg.vocab}, {n_params:,} "
          f"f32 parameters), {TRAIN_STEPS} steps of {TRAIN_BATCH} x "
          f"{TRAIN_SEQ} tokens in {TRAIN_MICRO} microbatches, bf16, remat "
          f"full: losses {np.round(losses, 4).tolist()}, grad_norm "
          f"{np.round(r['grad_norms'], 4).tolist()}; launches {launches}, "
          f"plain calls {plain}; run {run_s:.2f} s on {card}")
    print(f"train: median step {step_s * 1e3:.1f} ms (steps "
          f"{np.round(np.array(walls) * 1e3, 1).tolist()} ms), "
          f"{tokens / step_s:,.0f} tokens/s, model "
          f"{flops / step_s / 1e12:.1f} TFLOP/s = "
          f"{100 * flops / step_s / BF16_FLOPS_PER_S:.2f}% of the bf16 dense "
          f"peak ({flops / 1e12:.2f} TFLOP a step: 6 x "
          f"{(p_layers + p_head) / 1e6:.1f} M matmul weights x {tokens} "
          f"tokens + the remat forward of {p_layers / 1e6:.1f} M); peak "
          f"memory {peak / 2**30:.2f} GiB ({base / 2**30:.2f} GiB allocated "
          f"before the run)")
    print(f"train: monitor probe {np.round(np.array(probe_s) * 1e3, 3).tolist()}"
          f" ms host ({100 * r['probe_share_of_step']:.3f}% of the median "
          f"step), triad event time "
          f"{np.round(np.array(probe_dt) * 1e6, 2).tolist()} us, effective "
          f"{np.round(np.array(r['probe_effective_bw']) / 1e12, 3).tolist()} "
          f"TB/s, slowdown {np.round(r['probe_slowdown'], 3).tolist()} "
          f"(probes of {r['probe_bytes_each']} bytes)")
    nominal = r["monitor_idle_bw"]
    cont = res["contention"]
    print(f"train: triad launches {launches.get('triad', 0)} = "
          f"{r['triad_probe_launches']} probes + "
          f"{r['triad_calibration_launches']} calibrating the monitor's "
          f"nominal at the first probe (best of {_CALIBRATION_PROBES} idle "
          f"triads at each size the shrink can reach; "
          f"{r['triad_repeated_launches']} of all repeated a timed reading "
          f"the host had not enqueued in time): "
          + ", ".join(f"{nb >> 20} MiB {bw / 1e12:.4f} TB/s"
                      for nb, bw in sorted(nominal.items(), reverse=True))
          + f"; at {r['probe_bytes_each'][0] >> 20} MiB "
          f"{r['monitor_idle_share_of_spec']:.4f} of the spec HBM_BW {HBM_BW / 1e12:.2f} TB/s (at least "
          f"{_IDLE_NOMINAL_MIN_SHARE}, no warning); tiers {probe_tiers}, EWMA "
          f"{np.round(probe_ewma, 4).tolist()} on {card}")
    idle, busy, after = cont["idle"], cont["contended"], cont["after"]
    print(f"monitor: idle card, {len(idle['slowdown'])} probes of "
          f"{mib_list(idle)} MiB: slowdown "
          f"{np.round(idle['slowdown'], 4).tolist()} (max "
          f"{max(idle['slowdown']):.4f}); under a 1 GiB device-to-device "
          f"copy loop on a second stream ({cont['copy_tb_per_s']:.3f} TB/s "
          f"alone, "
          f"{'still running after' if cont['covered'] else 'ENDED BEFORE'} "
          f"the last probe), probes of {mib_list(busy)} MiB as the "
          f"monitor shrinks them: slowdown "
          f"{np.round(busy['slowdown'], 4).tolist()} (min "
          f"{min(busy['slowdown']):.4f}), EWMA "
          f"{np.round(busy['ewma'], 4).tolist()}, tiers {busy['tier']}; "
          f"separated: {cont['separated']} on {card}")
    print(f"monitor: after the copy loop, probes of {mib_list(after)} MiB: "
          f"slowdown {np.round(after['slowdown'], 4).tolist()}, EWMA "
          f"{np.round(after['ewma'], 4).tolist()}, tiers {after['tier']}; "
          f"calibration triads during the window: "
          f"{cont['window_calibration_launches']} on {card}")
    print(f"monitor: a fresh monitor calibrating under the copy loop "
          f"(copies still running after it: {cont['fresh_covered']}) read a "
          f"{cont['fresh_nominal_tb_per_s']:.4f} TB/s nominal and warned: "
          f"{cont['fresh_warning']!r}")
    print(f"train: checkpoint {ckpt_bytes / 1e9:.2f} GB ({on_disk:,} bytes "
          f"on disk): host snapshot {r['checkpoint_snapshot_s']:.2f} s, "
          f"written {r['checkpoint_write_done_s']:.2f} s after the save "
          f"began")
    print(f"train: torch.profiler over one step: {pr['kernels']} kernels, "
          f"{pr['device_busy_ms']:.1f} ms of device time, against the "
          f"median step of {pr['step_ms']:.1f} ms: device busy "
          f"{100 * pr['device_busy_share']:.1f}%"
          + ("" if pr["kernels"] else " (the profiler saw no device activity)")
          + f" (the profiled step took {pr['profiled_wall_ms']:.1f} ms, the "
          f"profile {pr['profile_s']:.1f} s in all)")
    for k in pr["top_kernels"]:
        print(f"  {k['ms']:9.2f} ms {k['count']:6d} x {k['name'][:90]}")
    t0 = time.perf_counter()
    res["restart"] = restart_check(smoke, card)
    res["restart"]["s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    res["accumulation"] = accumulation_check(smoke, card)
    res["accumulation"]["s"] = time.perf_counter() - t0
    print(f"train: phase seconds: set-up {res['setup_s']:.1f}, run "
          f"{run_s:.1f}, profile {pr['profile_s']:.1f}, restart "
          f"{res['restart']['s']:.1f}, accumulation "
          f"{res['accumulation']['s']:.1f}")
    return res


def mib_list(window):
    return [nb >> 20 for nb in window["probe_bytes"]]


def monitor_warnings(caught) -> list:
    """The monitor's contended-nominal warnings among ``caught``."""
    return [str(w.message) for w in caught
            if issubclass(w.category, RuntimeWarning)
            and str(w.message).startswith("PodMonitor:")]


def contended_probes(smoke, monitor, probe_once):
    """The monitor's readings on the idle card, under a co-tenant on the
    memory and after it.  ``probe_once`` is the monitor's own method,
    calibrated at its first probe in the training run; the window runs it
    as shipped, shrinking and restoring the probe size itself.  First
    `MONITOR_PROBES` idle probes; then as many while a second CUDA stream
    copies 1 GiB device to device `CONTENTION_COPIES` times; then as many
    after the copies end.  Fails if any probe of the trained monitor
    calibrates in the window.  Separated: every contended slowdown above
    every idle one.  Then a second copy loop, under which a fresh
    monitor's first probe calibrates: it must warn once of a contended
    nominal."""
    from repro_torch.tpuprobe.monitor import PodMonitor
    torch = smoke.torch
    src = torch.ones(1 << 28, dtype=torch.float32, device=smoke.dev)
    dst = torch.empty_like(src)
    side = torch.cuda.Stream(device=smoke.dev)
    smoke.sync()
    copy_ms = smoke.timeit(lambda: dst.copy_(src), reps=5)
    calib = monitor._calibration_launches

    def probes(n):
        w = {"probe_bytes": [], "slowdown": [], "ewma": [], "tier": []}
        for _ in range(n):
            w["probe_bytes"].append(monitor.probe_bytes)
            w["slowdown"].append(probe_once()[0].slowdown)
            w["ewma"].append(float(monitor.ewma[0]))
            w["tier"].append(monitor.device_tiers()[0])
        return w

    def copy_loop():
        with torch.cuda.stream(side):
            for _ in range(CONTENTION_COPIES):
                dst.copy_(src)
            done = torch.cuda.Event()
            done.record(side)
        return done

    idle = probes(MONITOR_PROBES)
    done = copy_loop()
    busy = probes(MONITOR_PROBES)
    covered = not done.query()
    done.synchronize()
    after = probes(MONITOR_PROBES)
    # a second copy loop, for a fresh monitor whose first probe
    # calibrates under it: it must warn once of a contended nominal
    done = copy_loop()
    fresh = PodMonitor(1, device=smoke.dev)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        fresh.probe_once()
    fresh_warnings = monitor_warnings(caught)
    fresh_covered = not done.query()
    done.synchronize()
    if len(fresh_warnings) != 1:
        raise AssertionError(f"monitor: a fresh monitor calibrating under "
                             f"the copy loop gave {fresh_warnings}, not one "
                             f"contended-nominal warning (copies still "
                             f"running after it: {fresh_covered})")
    fresh_nb = fresh.default_probe_bytes
    del src, dst
    window_calib = monitor._calibration_launches - calib
    if window_calib:
        raise AssertionError(f"monitor: {window_calib} calibration triads "
                             f"after the first probe")
    return {"idle": idle, "contended": busy, "after": after,
            "covered": covered, "copy_ms": copy_ms,
            "fresh_warning": fresh_warnings[0],
            "fresh_nominal_tb_per_s": fresh_nb / fresh._idle_s[fresh_nb]
            / 1e12, "fresh_covered": fresh_covered,
            "copy_tb_per_s": 2 * (1 << 30) / copy_ms / 1e9,
            "window_calibration_launches": window_calib,
            "separated": min(busy["slowdown"]) > max(idle["slowdown"])}


def restart_check(smoke, card):
    """Reduced qwen1.5-0.5b on the card: 2 steps, a new trainer resumes
    from the step-2 checkpoint to step 4; the losses equal those of 4
    continuous steps.  Deterministic algorithms are on: the embedding's
    backward would otherwise sum with atomics in a varying order."""
    torch = smoke.torch
    from repro_torch.configs.base import ShapeSpec, get_config, reduced_config
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.train import train_step as ts
    from repro_torch.train.trainer import Trainer, TrainerConfig
    cfg = reduced_config(get_config(TRAIN_ARCH))
    shape = ShapeSpec("restart", 64, 8, "train")
    hyper = ts.TrainHyper(microbatches=2, remat="full")
    torch.use_deterministic_algorithms(True)
    try:
        with tempfile.TemporaryDirectory(dir=ROOT / "build") as d:
            def trainer(sub):
                return Trainer(cfg, shape, hyper, TrainerConfig(
                    ckpt_dir=os.path.join(d, sub), ckpt_every=2,
                    data=DataConfig(seed=0)), device=smoke.dev)
            cont = trainer("continuous").run(4)
            trainer("split").run(2)
            resumed = trainer("split").run(4)
    finally:
        torch.use_deterministic_algorithms(False)
    want = [r["loss"] for r in cont[2:]]
    got = [r["loss"] for r in resumed]
    if [r["step"] for r in resumed] != [3, 4] or any(
            abs(g - w) > RESTART_RTOL * abs(w) for g, w in zip(got, want)):
        raise AssertionError(f"restart: resumed steps "
                             f"{[r['step'] for r in resumed]} losses {got}, "
                             f"continuous {want}")
    print(f"restart: {cfg.name} on the card, resumed at step 3 after a "
          f"2-step run: losses {got} vs continuous {want} (equal bit for "
          f"bit: {got == want})")
    return {"config": cfg.name, "resumed": got, "continuous": want,
            "exact": got == want, "card": card}


def accumulation_check(smoke, card):
    """One f32 step at full width from the same state with 1 and with 2
    microbatches: grad_norm within ACCUM_RTOL."""
    torch = smoke.torch
    from repro_torch.configs.base import ShapeSpec, get_config
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.train import train_step as ts
    cfg = get_config(TRAIN_ARCH)
    shape = ShapeSpec("accumulation", TRAIN_SEQ, 4, "train")
    batch = {k: torch.as_tensor(v, device=smoke.dev) for k, v in
             make_batch(DataConfig(seed=1), cfg, shape, 0).items()}
    out = {}
    for nm in (1, 2):
        hyper = ts.TrainHyper(microbatches=nm, remat="full",
                              compute_dtype=torch.float32)
        state = ts.make_train_state(
            cfg, hyper, torch.Generator(device=smoke.dev).manual_seed(1),
            smoke.dev)
        smoke.sync()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        new, m = ts.build_train_step(cfg, hyper)(state, batch)
        smoke.sync()
        out[nm] = {"grad_norm": float(m["grad_norm"]),
                   "loss": float(m["loss"]),
                   "wall_s": time.perf_counter() - t0,
                   "peak_memory_bytes": torch.cuda.max_memory_allocated()}
        del state, new
        torch.cuda.empty_cache()
    rel = abs(out[2]["grad_norm"] - out[1]["grad_norm"]) / out[1]["grad_norm"]
    print(f"accumulation: {cfg.name} f32, 4 x {TRAIN_SEQ} tokens, one step: "
          f"grad_norm {out[1]['grad_norm']:.6f} (1 microbatch) vs "
          f"{out[2]['grad_norm']:.6f} (2), rel {rel:.2e} (tol {ACCUM_RTOL}); "
          f"loss {out[1]['loss']:.6f} vs {out[2]['loss']:.6f}; peak memory "
          f"{out[1]['peak_memory_bytes'] / 2**30:.2f} / "
          f"{out[2]['peak_memory_bytes'] / 2**30:.2f} GiB; step "
          f"{out[1]['wall_s']:.2f} / {out[2]['wall_s']:.2f} s on {card}")
    if not rel <= ACCUM_RTOL:
        raise AssertionError(f"accumulation: grad_norm rel diff {rel:.3g} > "
                             f"{ACCUM_RTOL}")
    return {"by_microbatches": out, "grad_norm_rel_diff": rel, "card": card}


def triad_kernel_row(smoke, card, launches):
    """Phase 4 for the triad: device time at 64 MiB (the monitor's probe),
    256 MiB and 1 GiB, back to back and from a cold L2, beside its bound,
    its plain version and `torch.addcmul`; and the monitor's own reading
    (CUDA events) beside a host clock around the same launch."""
    torch = smoke.torch
    from repro_torch.kernels.cache_probe import kernel, ops, ref
    # reading it evicts the triad's lines: 256 MiB > the 50 MB L2
    flush = torch.ones((1 << 26,), dtype=torch.float32, device=smoke.dev)

    def cold_ms(fn, reps=10):
        times = []
        for _ in range(reps):
            flush.sum()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            times.append((start, end))
        smoke.sync()
        return float(np.median([a.elapsed_time(b) for a, b in times]))

    shapes = []
    for i, n_bytes in enumerate((TRIAD_MONITOR_BYTES, 256 << 20, 1 << 30)):
        rows = triad_rows(n_bytes)
        a = smoke.randn((rows, 128), 500 + i)
        b = smoke.randn((rows, 128), 600 + i)
        s = torch.tensor([1.0 / 3.0], device=smoke.dev)
        n = rows * 128
        b_ms, b_by = bound(12 * n, 2 * n)
        reps = 50 if n_bytes <= (256 << 20) else 20
        shapes.append({
            "n_bytes": n_bytes, "rows": rows, "shape": [rows, 128],
            "bytes_moved": 12 * n,
            "ms": smoke.device_ms(lambda: kernel.triad(a, b, s), reps=reps),
            "cold_ms": cold_ms(lambda: kernel.triad(a, b, s)),
            "plain_ms": smoke.timeit(lambda: ref.triad_ref(a, b, s),
                                     reps=20),
            "library_ms": smoke.device_ms(lambda: torch.addcmul(b, a, s),
                                          reps=reps),
            "library_cold_ms": cold_ms(lambda: torch.addcmul(b, a, s)),
            "bound_ms": b_ms, "bound_by": b_by})
        del a, b
    del flush
    # the monitor's reading: fresh buffers, one launch timed on the device
    # (`measure_hbm_bandwidth`); beside it, two readings of one launch made
    # from Python on an idle device: CUDA events around it, and a host
    # clock around it and a synchronize (as the JAX function times it)
    event_s, naive_s, host_s = [], [], []
    rows = triad_rows(TRIAD_MONITOR_BYTES)
    for _ in range(10):
        event_s.append(ops.measure_hbm_bandwidth(TRIAD_MONITOR_BYTES,
                                                 reps=1)[1])
        a = torch.ones((rows, 128), device=smoke.dev)
        b = torch.ones((rows, 128), device=smoke.dev)
        s = torch.ones((1,), device=smoke.dev)
        smoke.sync()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        ops.probe_triad(a, b, s)
        end.record()
        end.synchronize()
        naive_s.append(start.elapsed_time(end) / 1e3)
        smoke.sync()
        t0 = time.perf_counter()
        ops.probe_triad(a, b, s)
        smoke.sync()
        host_s.append(time.perf_counter() - t0)
    head = shapes[0]
    moved = head["bytes_moved"]
    row = {"name": "triad", "route": "cuda", "source": SOURCES["triad"][0],
           "replaces": SOURCES["triad"][1], "launches": launches,
           "path": "Trainer.run(qwen1.5-0.5b) -> PodMonitor.probe_once",
           "max_abs_err": smoke.err["triad"],
           "ms": head["ms"], "plain_ms": head["plain_ms"],
           "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
           "library_ms": head["library_ms"], "library": "torch.addcmul",
           "library_max_gap": smoke.triad_library_gap,
           "cold_ms": head["cold_ms"],
           "shape": f"({head['rows']}, 128) f32, the monitor's 64 MiB probe",
           "monitor_event_ms": float(np.median(event_s)) * 1e3,
           "python_event_ms": float(np.median(naive_s)) * 1e3,
           "monitor_host_ms": float(np.median(host_s)) * 1e3,
           "monitor_event_tb_per_s": moved / float(np.median(event_s)) / 1e12,
           "python_event_tb_per_s": moved / float(np.median(naive_s)) / 1e12,
           "monitor_host_tb_per_s": moved / float(np.median(host_s)) / 1e12,
           "shapes": shapes, "card": card}
    return row

def lm_kernel_rows(smoke, card, launches):
    """Phase 4 for the LM kernels: time at the zamba2 prefill shapes."""
    torch = smoke.torch
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
    from repro_torch.kernels.ssd_scan import ref as ssd_ref
    B, Sq, Sk, H, _, D = ZAMBA_ATTN
    shapes = []
    for dtype in (torch.float32, torch.bfloat16):
        q = smoke.randn((B, H, Sq, D), 101, dtype)
        k = smoke.randn((B, H, Sk, D), 102, dtype)
        v = smoke.randn((B, H, Sk, D), 103, dtype)
        # causal: q_pos >= k_pos pairs, 2*D flops each for QK^T and for PV
        flops = 4 * B * H * D * (Sq * (Sq + 1) // 2)
        nbytes = 4 * B * H * Sq * D * q.element_size()
        peak = ALU_OPS_PER_S if dtype == torch.float32 else BF16_FLOPS_PER_S
        t_ops, t_bytes = flops / peak * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
        shapes.append({
            "dtype": str(dtype)[6:], "shape": [B, H, Sq, D], "causal": True,
            "ms": smoke.device_ms(lambda: fa_kernel.flash_attention_bhsd(
                q, k, v, causal=True), reps=20),
            "plain_ms": smoke.timeit(lambda: fa_ref.attention_ref(
                q, k, v, True), reps=3),
            "library_ms": smoke.device_ms(
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    q, k, v, is_causal=True), reps=20),
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "flops": flops, "bytes": nbytes})
    head = shapes[0]
    rows = [{"name": "flash_attention", "route": "cuda",
             "source": SOURCES["flash_attention"][0],
             "replaces": SOURCES["flash_attention"][1],
             "launches": launches["flash_attention"],
             "path": "lm.prefill(zamba2-2.7b, 2 x 2048, f32)",
             "max_abs_err": smoke.err["flash_attention"],
             "max_abs_err_by": smoke.err_by["flash_attention"],
             "ms": head["ms"], "plain_ms": head["plain_ms"],
             "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
             "library_ms": head["library_ms"],
             "library": "torch.nn.functional.scaled_dot_product_attention",
             "shape": f"({B}, {H}, {Sq}, {D}) causal f32",
             "shapes": shapes, "card": card}]

    b, h, nc, L, p, n = 2, 80, PREFILL_S // 128, 128, 64, 64
    x = smoke.randn((b, h, nc, L, p), 111)
    dt = torch.nn.functional.softplus(smoke.randn((b, h, nc, L), 112))
    dA = dt * -torch.exp(smoke.randn((1, h, 1, 1), 113, scale=0.3))
    Bm = smoke.randn((b, nc, L, n), 114, scale=0.3)
    Cm = smoke.randn((b, nc, L, n), 115, scale=0.3)
    # per (batch, chunk): C.B^T for m <= l, shared by the heads; per
    # (batch, head, chunk): the masked att @ x, the carried-state term
    # C.state^T and the state update x^T B (+ the decay of the old state)
    tri = L * (L + 1) // 2
    flops = (b * nc * 2 * tri * n
             + b * h * nc * (2 * tri * p + 4 * L * p * n + p * n))
    nbytes = 4 * (2 * x.numel() + 2 * dt.numel() + 2 * Bm.numel()
                  + b * h * p * n)
    t_ops, t_bytes = flops / ALU_OPS_PER_S * 1e3, \
        nbytes / HBM_BYTES_PER_S * 1e3
    stages, lost, profiles = ssd_stage_us(
        smoke, lambda: ssd_kernel.ssd_scan_grid(x, dt, dA, Bm, Cm))
    rows.append({
        "name": "ssd_scan", "route": "cuda",
        "source": SOURCES["ssd_scan"][0], "replaces": SOURCES["ssd_scan"][1],
        "launches": launches["ssd_scan"],
        "path": "lm.prefill(zamba2-2.7b, 2 x 2048, f32)",
        "max_abs_err": smoke.err["ssd_scan"],
        "max_abs_err_by": smoke.err_by["ssd_scan"],
        "ms": smoke.device_ms(lambda: ssd_kernel.ssd_scan_grid(
            x, dt, dA, Bm, Cm), reps=20),
        "plain_ms": smoke.timeit(lambda: ssd_ref.ssd_scan_grid_ref(
            x, dt, dA, Bm, Cm), reps=3),
        "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": None, "flops": flops, "bytes": nbytes,
        "stage_us": stages, "stage_lost": lost,
        "stage_profiles": profiles,
        "shape": f"({b}, {h}, {nc}, {L}, {p}), n={n}, f32", "card": card})
    return rows


def engine_breakdown(smoke, cachesim, runner, main_s, card):
    """Phase 3 (i)'s breakdown of `run_cachex("skylake_sp")` by engine
    launch shape ("<mode> GxBxT"): CUDA events around each launch (an
    upper bound, with the host's enqueue) against the host clock, then
    each kernel's device time from torch.profiler."""
    torch = smoke.torch
    from torch.profiler import ProfilerActivity, profile
    launch = cachesim._engine_cuda
    order, spans = [], []

    def key(a):
        return ("commit " if a[6] else "measure ") + "x".join(
            str(int(x)) for x in a[2].shape)

    def timed_launch(*a, **kw):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        lat = launch(*a, **kw)
        end.record()
        spans.append((key(a), start, end))
        return lat

    def counted_launch(*a, **kw):
        order.append(key(a))
        return launch(*a, **kw)

    cachesim._engine_cuda = timed_launch
    try:
        t0 = time.perf_counter()
        runner.run_cachex("skylake_sp")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        cachesim._engine_cuda = counted_launch
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            runner.run_cachex("skylake_sp")
            torch.cuda.synchronize()
    finally:
        cachesim._engine_cuda = launch
    kernels = sorted((e for e in prof.events()
                      if str(e.device_type).endswith("CUDA")
                      and "cachesim_engine_kernel" in e.name),
                     key=lambda e: e.time_range.start)
    paired = len(kernels) == len(order)
    by = {}   # "<mode> GxBxT" -> launches, event ms, device ms
    for k, start, end in spans:
        r = by.setdefault(k, {"launches": 0, "event_ms": 0.0,
                              "device_ms": 0.0 if paired else None})
        r["launches"] += 1
        r["event_ms"] += start.elapsed_time(end)
    for k, e in zip(order, kernels) if paired else ():
        by[k]["device_ms"] += e.time_range.elapsed_us() / 1e3
    event_ms = sum(r["event_ms"] for r in by.values())
    device_ms = (sum(r["device_ms"] for r in by.values()) if paired
                 else None)
    print(f"main breakdown: wall {wall:.3f} s with events (uninstrumented "
          f"run {main_s:.3f} s), engine event time {event_ms:.1f} ms over "
          f"{len(spans)} launches (device idle at least "
          f"{100 * (1 - event_ms / 1e3 / wall):.1f}%); engine device time "
          + (f"{device_ms:.3f} ms by torch.profiler ({len(kernels)} kernels)"
             if paired else f"not measured (the profiler saw "
             f"{len(kernels)} engine kernels for {len(order)} launches)")
          + f" on {card}")
    for k, r in sorted(by.items(), key=lambda kv: -kv[1]["event_ms"]):
        dev = (f", device {r['device_ms']:.3f} ms "
               f"({r['device_ms'] / r['launches'] * 1e3:.1f} us a launch)"
               if paired else "")
        print(f"  engine {k} (G x B x T): {r['launches']} launches, events "
              f"{r['event_ms']:.3f} ms{dev}")
    for mode in ("commit", "measure"):
        sel = [r for k, r in by.items() if k.startswith(mode)]
        dev = (f", device {sum(r['device_ms'] for r in sel):.3f} ms"
               if paired else "")
        print(f"  engine {mode} mode: {sum(r['launches'] for r in sel)} "
              f"launches, events {sum(r['event_ms'] for r in sel):.3f} ms"
              f"{dev}")
    return {"wall_s": wall, "engine_event_ms": event_ms,
            "engine_device_ms": device_ms,
            "device_idle_share": 1.0 - event_ms / 1e3 / wall,
            "by_shape_GBT": dict(sorted(by.items()))}


# The SSD kernel's four CUDA kernels (csrc/ssd_scan.cu:112, :160, :248, :280)
SSD_STAGES = ("ssd_cb", "ssd_states", "ssd_carry", "ssd_out")
SSD_PROFILES = 3      # profiles of the stages before a missing one is lost


def stage_readout(us_by_name):
    """Each SSD stage's microseconds a launch from the profiler's records
    (kernel name -> us; other names are ignored) and the stages whose
    records are missing, in `SSD_STAGES` order.  A missing stage reads
    None, never a dict that looks whole."""
    stages = {k: us_by_name.get(k) for k in SSD_STAGES}
    return stages, [k for k, v in stages.items() if v is None]


def ssd_stage_us(smoke, call, reps: int = 5):
    """Device microseconds per launch of each of the SSD kernel's stages
    (its four CUDA kernels, by name), from torch.profiler over ``reps``
    calls.  A profile that lacks a stage's records is taken again, up to
    `SSD_PROFILES` in all; returns (stages, lost, profiles taken), a
    stage still missing being None in ``stages`` and named in ``lost``."""
    from torch.profiler import ProfilerActivity, profile
    call()
    smoke.sync()
    for n in range(1, SSD_PROFILES + 1):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                call()
            smoke.sync()
        seen = {}
        for e in prof.key_averages():
            name = e.key.split("::")[-1].split("(")[0]
            if str(e.device_type).endswith("CUDA") and e.count:
                seen[name] = e.self_device_time_total / e.count
        stages, lost = stage_readout(seen)
        if not lost:
            break
    return stages, lost, n


# -- run_cachex on every platform, and the closed loop (phase 3 (i), (iv)) -------

DATA = ROOT / "tests" / "data"
SHARDED_GUESTS = 64
TUNE_PLATFORMS = ("skylake_sp", "milan_ccx")
TUNE_GUESTS = 4
# CAP on against off under CAS (Table 8's shape): the working set's
# measured latency with CAP at most half of that without
CAP_LAT_RATIO = 0.5
# padded (lanes, steps) shapes the cost constants are measured at: each
# a new shape once, then repeated; `COST_SLOPE_SHAPES` span the work
COST_NEW_SHAPES = ((16, 64), (64, 32), (256, 64), (32, 512), (128, 256))
COST_SLOPE_SHAPES = ((8, 32), (8, 128), (32, 128), (128, 128), (128, 512),
                     (512, 256), (512, 512))
COST_REPS = 15
COST_NAMES = ("COMPILE_S", "DISPATCH_OVERHEAD_S", "STEP_COST_S")


@functools.lru_cache(maxsize=None)
def goldens():
    """tests/torch_goldens.py as a module: the golden format
    (`report_fields`) and the comparison of a fleet report with its golden
    (`fleet_mismatches`, rel `FLEET_RTOL` on `FLEET_FLOAT_FIELDS`, exact
    elsewhere), which the CPU tests use too.  It imports the JAX package
    only in the functions that write goldens, which this script never
    calls."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "torch_goldens", DATA.parent / "torch_goldens.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def engine_dispatches() -> int:
    """Physical engine dispatches so far: each one, probe or co-tenant
    window, notes its padded shape in `plancost.SHAPE_CACHE`."""
    from repro_torch.core.plancost import SHAPE_CACHE
    return SHAPE_CACHE.hits + SHAPE_CACHE.misses


def counted(smoke, fn):
    """Run ``fn`` with the launch counters set to 0 just before it and
    read just after: (its result, the engine's launches, the physical
    dispatches, the plain engine calls, the other launches, seconds)."""
    from repro_torch import _build
    _build.reset_counters()
    d0 = engine_dispatches()
    t0 = time.perf_counter()
    res = fn()
    smoke.sync()
    acct = {"s": time.perf_counter() - t0,
            "engine_launches": _build.LAUNCHES.get("cachesim_engine", 0),
            "physical_dispatches": engine_dispatches() - d0,
            "plain_engine_calls": _build.PLAIN_CALLS.get("cachesim_engine",
                                                         0),
            "other_launches": {k: v for k, v in _build.LAUNCHES.items()
                               if k != "cachesim_engine" and v}}
    return res, acct


def require_engine(what: str, acct: dict, exact: bool = True) -> None:
    """The engine kernel ran the path: it launched once a physical
    dispatch (``exact``; at least that often otherwise), nothing else
    launched, and no plain engine call."""
    n, d = acct["engine_launches"], acct["physical_dispatches"]
    if (not n or acct["plain_engine_calls"] or acct["other_launches"]
            or (n != d if exact else n < d)):
        raise AssertionError(f"{what}: {n} engine launches against {d} "
                             f"physical dispatches, "
                             f"{acct['plain_engine_calls']} plain engine "
                             f"calls, other launches "
                             f"{acct['other_launches']}")


def run_cachex_all(smoke, runner, card):
    """Phase 3 (i) on every platform: `run_matrix` one platform at a time
    (the counters set to 0 around each) against the goldens the JAX
    package wrote."""
    from repro_torch.core.platforms import list_platforms
    rows = {}
    for name in list_platforms():
        reports, acct = counted(smoke, lambda: runner.run_matrix(
            [name], device=smoke.dev))
        got = goldens().report_fields(reports[0])
        path = DATA / f"torch_golden_run_cachex_{name}.json"
        want = json.loads(path.read_text())
        if got != want:
            bad = {k: (got.get(k), want.get(k)) for k in set(got) | set(want)
                   if got.get(k) != want.get(k)}
            raise AssertionError(f"run_cachex({name}) differs from "
                                 f"{path.name}: {bad}")
        require_engine(f"run_cachex({name})", acct)
        if name == "skylake_sp" and \
                acct["physical_dispatches"] != MAIN_PATH_ENGINE_CALLS:
            raise AssertionError(f"run_cachex(skylake_sp): "
                                 f"{acct['physical_dispatches']} engine "
                                 f"dispatches, not {MAIN_PATH_ENGINE_CALLS}")
        rows[name] = dict(acct, probe_dispatches=got["dispatches"])
    print(f"main: run_matrix on {card}, each platform equal to its golden "
          f"report; engine launches (= physical dispatches, probes + "
          f"co-tenant windows), seconds: "
          + ", ".join(f"{n} {r['engine_launches']} ({r['probe_dispatches']}"
                      f" probes) {r['s']:.3f} s" for n, r in rows.items())
          + f"; no plain engine call, on {card}")
    return rows


def measure_cost_constants(smoke, card):
    """The plan cost model's three device constants for the CUDA engine,
    on a scratch skylake_sp VM on the card, host clock around each
    dispatch (each ends in its synchronizing copy):
    ``DISPATCH_OVERHEAD_S`` the median seconds of a minimal dispatch (one
    lane of one access, padded to (8, 32)); ``COMPILE_S`` the median over
    `COST_NEW_SHAPES` of a new padded shape's first dispatch less the
    median of its repeats; ``STEP_COST_S`` the least-squares slope of
    the median dispatch seconds over padded lane-work elements across
    `COST_SLOPE_SHAPES`."""
    from repro_torch.core import plancost
    from repro_torch.core.platforms import get_platform
    vm = plancost._scratch_vm(get_platform("skylake_sp"), 0, smoke.dev)

    def lanes(b, t):
        return plancost._cutout_lanes(vm, b, t)

    def secs(ls, reps):
        out = []
        for _ in range(reps):
            t0 = time.perf_counter()
            vm.timed_access_batch(ls, vcpu=0)
            out.append(time.perf_counter() - t0)
        return out

    one = [lanes(1, 1)[0]]
    secs(one, 3)                                   # the process warms up
    minimal = float(np.median(secs(one, 4 * COST_REPS)))
    extra = []
    for b, t in COST_NEW_SHAPES:
        ls = lanes(b, t)
        first = secs(ls, 1)[0]
        extra.append(first - float(np.median(secs(ls, COST_REPS))))
    xs, ys = [], []
    for b, t in COST_SLOPE_SHAPES:
        ls = lanes(b, t)
        secs(ls, 1)
        xs.append(b * t)
        ys.append(float(np.median(secs(ls, COST_REPS))))
    slope, icpt = np.polyfit(np.array(xs, float), np.array(ys), 1)
    res = {"COMPILE_S": float(np.median(extra)),
           "DISPATCH_OVERHEAD_S": minimal, "STEP_COST_S": float(slope),
           "new_shape_extra_s": extra, "slope_intercept_s": float(icpt),
           "slope_points": [[x, y] for x, y in zip(xs, ys)],
           "in_plancost": {k: getattr(plancost, k) for k in COST_NAMES},
           "card": card}
    return res


def cost_constant_flips(cc) -> list:
    """The cost model's choices that the constants measured in this run
    (``cc``) would change against those in plancost.py: on every platform
    the model-only lowering for `TUNE_GUESTS` guests and the shard for
    `SHARDED_GUESTS`, each chosen afresh under both sets (the tune and
    shard caches are emptied around each choice and after)."""
    from repro_torch.core import fleetshard, plancost
    from repro_torch.core.platforms import get_platform, list_platforms

    def choices():
        out = {}
        for name in list_platforms():
            plat = get_platform(name)
            plancost.clear_tune_cache()
            fleetshard.clear_shard_cache()
            low = plancost.tune_lowering(plat, None, n_guests=TUNE_GUESTS,
                                         measure=False).chosen
            fleetshard.clear_shard_cache()
            shard = fleetshard.choose_shard(
                plat, n_guests=SHARDED_GUESTS).shard_size
            out[name] = {"lowering": dataclasses.asdict(low),
                         "shard_size": shard}
        return out

    committed = choices()
    saved = {k: getattr(plancost, k) for k in COST_NAMES}
    try:
        for k in COST_NAMES:
            setattr(plancost, k, cc[k])
        fresh = choices()
    finally:
        for k, v in saved.items():
            setattr(plancost, k, v)
        plancost.clear_tune_cache()
        fleetshard.clear_shard_cache()
    return [{"platform": name, "choice": what, "committed": c[what],
             "measured": fresh[name][what]}
            for name, c in committed.items() for what in c
            if c[what] != fresh[name][what]]


def fleet_profile(smoke, run):
    """Where a fleet's time goes on the card: ``run`` once for its wall,
    then once under torch.profiler (device activity only) for its
    kernels; the device busy share is the kernels' device time over the
    unprofiled wall."""
    from torch.profiler import ProfilerActivity, profile
    smoke.sync()
    t0 = time.perf_counter()
    run()
    smoke.sync()
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        smoke.sync()
    engine_us = other_us = 0.0
    engine_n = other_n = 0
    for e in prof.key_averages():
        if not str(e.device_type).endswith("CUDA"):
            continue
        if "cachesim_engine_kernel" in e.key:
            engine_us += e.self_device_time_total
            engine_n += e.count
        else:
            other_us += e.self_device_time_total
            other_n += e.count
    busy_ms = (engine_us + other_us) / 1e3
    return {"wall_s": wall, "engine_kernels": engine_n,
            "engine_ms": engine_us / 1e3, "other_kernels": other_n,
            "other_ms": other_us / 1e3, "device_busy_ms": busy_ms,
            "device_busy_share": busy_ms / 1e3 / wall,
            "measured": bool(engine_n)}


def closed_loop(smoke, card):
    """Phase 3 (iv): the paper's closed loop on the card, each check with
    the counters set to 0 just before it and read just after."""
    from repro_torch.core import fleet, plancost, vtop
    from repro_torch.core.fleetshard import clear_shard_cache
    from repro_torch.core.platforms import get_platform, list_platforms
    res = {}
    t_phase = time.perf_counter()

    # vtop on skylake_sp's fleet guest (two LLC domains of three vCPUs)
    plat = fleet.fleet_view(get_platform("skylake_sp"),
                            len(fleet.default_workloads()))
    _, vm = plat.make_host_vm(seed=0, device=smoke.dev)
    pages = vm.alloc_pages(64)
    groups, acct = counted(smoke, lambda: vtop.infer_llc_domains(vm, pages))
    truth = {v: int(c) // plat.cores_per_domain
             for v, c in enumerate(vm.vcpu_cores)}
    want = sorted(tuple(v for v in truth if truth[v] == d)
                  for d in sorted(set(truth.values())))
    got = sorted(tuple(sorted(g)) for g in groups)
    if got != want:
        raise AssertionError(f"vtop: inferred {got}, hypercall {want}")
    require_engine("vtop", acct)
    res["vtop"] = dict(acct, groups=got)
    print(f"loop: infer_llc_domains on skylake_sp's fleet guest "
          f"({plat.n_domains} domains x {plat.cores_per_domain} vCPUs) = the "
          f"hypercall map {got}; {acct['engine_launches']} engine launches "
          f"in {acct['s']:.3f} s")

    # the six-platform sweep against the JAX package's goldens
    reports, acct = counted(
        smoke, lambda: fleet.run_fleet_matrix(device=smoke.dev))
    golden = json.loads((DATA / "torch_golden_fleet_matrix.json")
                        .read_text())
    got = [goldens().report_fields(r) for r in reports]
    if len(got) != len(golden):
        raise AssertionError(f"fleet matrix: {len(got)} reports, golden "
                             f"{len(golden)}")
    for g, w in zip(got, golden):
        bad = goldens().fleet_mismatches(g, w)
        if bad:
            raise AssertionError(f"fleet matrix {w['platform']} "
                                 f"{w['policy']}/cap {w['cap']}: {bad}")
    require_engine("fleet matrix", acct)
    f10 = fleet.fig10_summary(reports)
    n = len(list_platforms())
    if not (f10["n_platforms"] == f10["cas_quiet"] == f10["eevdf_pinned"]
            == f10["separated"] == n):
        raise AssertionError(f"fig10: {f10}")
    cap = {}
    for name in list_platforms():
        lat = {r.cap: r.ws_lat_cycles for r in reports
               if r.platform == name and r.policy == "cas"}
        cap[name] = lat
        if not lat["on"] < CAP_LAT_RATIO * lat["off"]:
            raise AssertionError(f"CAP on {name}: ws_lat {lat}")
    prof = fleet_profile(smoke, lambda: fleet.run_fleet_matrix(
        ["skylake_sp"], device=smoke.dev))
    res["matrix"] = dict(acct, fig10=f10, cap_ws_lat=cap,
                         speedup=fleet.speedup_summary(reports),
                         guests_per_sec=sorted({r.guests_per_sec
                                                for r in reports}),
                         skylake_sp_profile=prof)
    print(f"loop: run_fleet_matrix() on the card, {len(reports)} reports (6 "
          f"platforms x {len(fleet.DEFAULT_COMBOS)} combos, lockstep) equal "
          f"to the golden (rel {goldens().FLEET_RTOL} on "
          f"{goldens().FLEET_FLOAT_FIELDS}); Fig 10 "
          f"CAS quiet {f10['cas_quiet']}/{n}, eevdf pinned "
          f"{f10['eevdf_pinned']}/{n}, separated {f10['separated']}/{n}; CAP "
          f"ws_lat on/off "
          + ", ".join(f"{k} {v['on']:.1f}/{v['off']:.1f}"
                      for k, v in cap.items())
          + f"; {acct['engine_launches']} engine launches = physical "
          f"dispatches, no plain call, in {acct['s']:.1f} s on {card}")
    print(f"loop: skylake_sp's 4-guest cohort, {prof['wall_s']:.3f} s of "
          f"wall: "
          + (f"{prof['engine_kernels']} engine kernels {prof['engine_ms']:.2f}"
             f" ms and {prof['other_kernels']} other kernels "
             f"{prof['other_ms']:.2f} ms of device time (torch.profiler): "
             f"device busy {100 * prof['device_busy_share']:.2f}%"
             if prof["measured"] else "device time not measured (the "
             "profiler saw no engine kernel)") + f" on {card}")

    # the attack-and-defense loop
    rep, acct = counted(smoke, lambda: fleet.FleetSim(
        "skylake_sp", attack=True, with_poisoner=False, n_intervals=18,
        device=smoke.dev).run())
    got = goldens().report_fields(rep)
    want = json.loads((DATA / "torch_golden_fleet_attack.json").read_text())
    bad = goldens().fleet_mismatches(got, want)
    if bad or rep.defenses != 1 or rep.false_drift != 0:
        raise AssertionError(f"attack fleet: {bad}, defenses "
                             f"{rep.defenses}, false drift "
                             f"{rep.false_drift}")
    require_engine("attack fleet", acct)
    res["attack"] = dict(acct, report=got)
    print(f"loop: attack fleet (skylake_sp, 18 intervals) equal to its "
          f"golden: detected {rep.attack_detected} after "
          f"{rep.attack_detect_intervals} intervals, {rep.defenses} defense, "
          f"{rep.false_drift} false drift, residency pre/during/post "
          f"{rep.residency_pre:.2f}/{rep.residency_during:.2f}/"
          f"{rep.residency_post:.2f}; {acct['engine_launches']} engine "
          f"launches in {acct['s']:.1f} s")

    # rack scale: the automatic shard, then SHARDED_GUESTS forced, then
    # the smallest candidate shard (so at least one run is sharded
    # whatever the automatic choice)
    clear_shard_cache()
    plat = get_platform("skylake_sp")
    runs = {}
    for label, shard in (("auto", None), ("forced", SHARDED_GUESTS),
                         ("smallest", min(plat.scale.shard_candidates))):
        runs[label] = counted(smoke, lambda: fleet.ShardedFleet(
            "skylake_sp", SHARDED_GUESTS, shard_size=shard,
            device=smoke.dev).run())
    auto = runs["auto"][0]
    res["sharded"] = {}
    for label, (run, acct) in runs.items():
        diffs = [(i, [k for k in a if a[k] != b[k]])
                 for i, (a, b) in enumerate(zip(
                     map(goldens().report_fields, auto.reports),
                     map(goldens().report_fields, run.reports)))]
        diffs = [d for d in diffs if d[1]]
        if len(run.reports) != SHARDED_GUESTS or diffs:
            raise AssertionError(f"sharded fleet ({label}): "
                                 f"{len(run.reports)} reports, guests "
                                 f"that differ from auto {diffs[:4]}")
        require_engine(f"sharded fleet ({label})", acct)
        res["sharded"][label] = dict(
            acct, shard_size=run.shard_size, n_shards=run.n_shards,
            n_devices=run.n_devices, boot_s=run.boot_s, run_s=run.run_s,
            guests_per_sec=run.guests_per_sec)
        print(f"loop: ShardedFleet(skylake_sp, {SHARDED_GUESTS}) {label} "
              f"shard {run.shard_size} ({run.n_shards} shards, "
              f"{run.n_devices} device): {run.guests_per_sec:.2f} guests/s "
              f"(boot {run.boot_s:.2f} s, run {run.run_s:.2f} s, "
              f"{acct['engine_launches']} engine launches), per-guest "
              f"reports bit-identical to auto's, on {card}")

    # the lowering autotuner, measured on the card
    res["tune"] = {}
    for name in TUNE_PLATFORMS:
        plancost.clear_tune_cache()
        rep, acct = counted(smoke, lambda: plancost.tune_lowering(
            get_platform(name), None, n_guests=TUNE_GUESTS, measure=True,
            force=True, device=smoke.dev))
        trials = [dataclasses.asdict(t) for t in rep.trials]
        res["tune"][name] = dict(acct, chosen=dataclasses.asdict(rep.chosen),
                                 trials=trials)
        print(f"tune {name} ({TUNE_GUESTS} guests, measured on cuda in "
              f"{acct['s']:.2f} s): chosen {rep.chosen}")
        for t in rep.trials:
            print(f"  {t.knob:13s} {t.candidate:13s} cutout {t.cutout} "
                  f"measured {t.measured_s * 1e6:9.1f} us, new shapes "
                  f"{t.pred_misses}, score {t.score:.5f}"
                  f"{'  <- chosen' if t.chosen else ''}")
    plancost.clear_tune_cache()
    want = next(w for w in golden if (w["platform"], w["policy"], w["cap"])
                == ("skylake_sp", "cas", "on"))

    def tuned_run():
        sim = fleet.FleetSim("skylake_sp", device=smoke.dev)
        return sim.tune(), sim.run()
    (tune_rep, rep), acct = counted(smoke, tuned_run)
    bad = goldens().fleet_mismatches(goldens().report_fields(rep), want)
    if bad:
        raise AssertionError(f"tuned fleet (lowering {tune_rep.chosen}) "
                             f"differs from the untuned golden: {bad}")
    require_engine("tuned fleet", acct, exact=False)
    res["tuned_fleet"] = dict(acct, chosen=dataclasses.asdict(
        tune_rep.chosen))
    print(f"loop: run_fleet(skylake_sp) under the lowering measured on "
          f"the card ({tune_rep.chosen}) equals the untuned golden; "
          f"{acct['engine_launches']} engine launches against "
          f"{acct['physical_dispatches']} physical dispatches (the rest "
          f"are the tuner's cutouts), in {acct['s']:.1f} s")

    res["cost_constants"] = measure_cost_constants(smoke, card)
    res["cost_constants"]["flips"] = cost_constant_flips(
        res["cost_constants"])
    res["s"] = time.perf_counter() - t_phase
    return res


def print_cost_constants(cc) -> None:
    inp = cc["in_plancost"]
    print(f"cost constants (measured for the CUDA engine, host clock): "
          f"COMPILE_S {cc['COMPILE_S']:.3e} s (a new padded shape's first "
          f"dispatch over a repeat; per shape "
          f"{[round(x * 1e6, 1) for x in cc['new_shape_extra_s']]} us), "
          f"DISPATCH_OVERHEAD_S {cc['DISPATCH_OVERHEAD_S']:.3e} s (one "
          f"minimal dispatch + its synchronizing copy), STEP_COST_S "
          f"{cc['STEP_COST_S']:.3e} s a padded lane-work element (intercept "
          f"{cc['slope_intercept_s']:.3e} s); plancost.py has "
          f"{inp['COMPILE_S']:.3e} / {inp['DISPATCH_OVERHEAD_S']:.3e} / "
          f"{inp['STEP_COST_S']:.3e}; on {cc['card']}")
    flips = cc["flips"]
    print(f"cost constants: {len(flips)} of the model's choices (lowering "
          f"for {TUNE_GUESTS} guests, shard for {SHARDED_GUESTS}, six "
          f"platforms) differ under the measured constants from "
          f"plancost.py's" + "".join(
              f"; {f['platform']} {f['choice']} {f['committed']} -> "
              f"{f['measured']}" for f in flips))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the full results as JSON here")
    args = ap.parse_args()

    # cuBLAS reads this when it makes its first handle: the restart check
    # runs with deterministic algorithms, which need it
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    # full f32 everywhere: the float kernels and their references are held
    # to f32 tolerances, which TF32 (10-bit mantissa) would not meet
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
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
    smoke.check_flash_attention()
    smoke.check_ssd_scan()
    smoke.check_triad()
    smoke.sync()
    out["phases"]["kernels_s"] = time.perf_counter() - t0
    print(f"kernels: cachesim_engine, lru_sets, prime_probe, triad bit-exact "
          f"vs plain (torch.addcmul at {smoke.triad_library_gap:.3f} of one "
          f"ulp of the product plus one of the result from the triad); max "
          f"abs err flash_attention "
          f"{smoke.err_by['flash_attention']}, ssd_scan "
          f"{smoke.err_by['ssd_scan']}, within the stated tolerances "
          f"(checks {smoke.checks}, launches {dict(_build.LAUNCHES)}) in "
          f"{out['phases']['kernels_s']:.1f} s; engine designs "
          f"{smoke.engine_designs}")
    out["engine_designs"] = smoke.engine_designs

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
    # bound on the engine's device time.  A third run under torch.profiler
    # gives each engine kernel's own device time, paired with its launch
    # by order (one stream).
    out["main"]["breakdown"] = engine_breakdown(smoke, cachesim, runner,
                                                main_s, card)

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
    t0 = time.perf_counter()
    out["main"]["platforms"] = run_cachex_all(smoke, runner, card)
    out["phases"]["main_platforms_s"] = time.perf_counter() - t0

    loop = closed_loop(smoke, card)
    out["phases"]["loop_s"] = loop["s"]
    out["loop"] = loop
    print(f"loop: phase seconds {loop['s']:.1f} (vtop "
          f"{loop['vtop']['s']:.1f}, matrix {loop['matrix']['s']:.1f}, "
          f"attack {loop['attack']['s']:.1f}, sharded "
          + " + ".join(f"{v['s']:.1f}" for v in loop["sharded"].values())
          + ", tune "
          + " + ".join(f"{v['s']:.1f}" for v in loop["tune"].values())
          + f", tuned fleet {loop['tuned_fleet']['s']:.1f}) on {card}")

    t0 = time.perf_counter()
    serve = serve_main_path(smoke, card)
    out["phases"]["serve_s"] = time.perf_counter() - t0
    out["serve"] = serve

    t0 = time.perf_counter()
    train = train_main_path(smoke, card)
    out["phases"]["train_s"] = time.perf_counter() - t0
    out["train"] = train

    # -- 4. times -----------------------------------------------------------------
    # "ms" is device time per launch (Smoke.device_ms), "plain_ms" the
    # plain version's time per call, host included (Smoke.timeit).
    sky = get_platform("skylake_sp").machine()
    table1 = smoke.geometries()["table1"]
    rng = np.random.default_rng(0)
    rows = []

    def engine_case(geom, gname, shape, budget=cachesim.SMEM_BUDGET):
        """Device time of one engine launch at ``shape`` ((T,) commit or
        (B, T) measure) after a warming stream, with the design the plan
        picks under ``budget`` and the state bytes that design moves: the
        staged state in and, in commit mode, out (shared); the rows each
        lane copied, read and written (touch, measure mode; from the
        kernel's own count); the touched rows, read and written in place
        (touch, commit)."""
        plan = cachesim._engine_plan(geom, shape[-1], len(shape) == 1,
                                     budget)
        launch = functools.partial(cachesim._engine_cuda,
                                   smem_budget=budget)
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
            launch(single, geom, *args_)
            # rows the back-invalidations changed are read and written too
            changed = (state["l2"][0] != l2_before).any(dim=-1)
            l2_rows, llc_rows = touched_rows(cachesim, geom, b, c, t)
            l2_rows = np.union1d(
                l2_rows, np.flatnonzero(changed.cpu().numpy()))
            nbytes = engine_bytes(geom, len(l2_rows), len(llc_rows), T, 1,
                                  commit=True)
            mode, lanes_, copied = "access_stream", 1, None
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
            mode, lanes_, copied = "access_streams_batched", B, None
            if plan.design == "touch":
                copied = smoke.torch.zeros((B, 2), dtype=smoke.torch.int32,
                                           device=smoke.dev)
                launch(single, geom, *args_, rows_copied=copied)
                copied = copied.sum(dim=0).tolist()
        valid = int((b >= 0).sum())
        # 2 compares (tag, age) per way per level per valid step
        ops = 2 * valid * (geom.l2.n_ways + geom.llc.n_ways)
        b_ms, b_by = bound(nbytes, ops)
        ms = smoke.device_ms(lambda: launch(single, geom, *args_))
        plain_ms = smoke.timeit(lambda: cachesim.engine_ref(single, geom,
                                                            *args_),
                                reps=1, warmup=0)
        row_bytes = (8 * geom.l2.n_ways, 8 * geom.llc.n_ways)
        state_bytes = 8 * (geom.n_cores * geom.l2.n_sets * geom.l2.n_ways
                           + geom.n_domains * geom.llc.n_lines)
        if plan.design == "shared":
            moved = lanes_ * state_bytes * (2 if len(shape) == 1 else 1)
        elif copied is not None:
            moved = 2 * (copied[0] * row_bytes[0] + copied[1] * row_bytes[1])
        else:
            moved = 2 * (len(l2_rows) * row_bytes[0]
                         + len(llc_rows) * row_bytes[1])
        return {"geometry": gname, "entry": mode, "shape": list(shape),
                "design": plan.design, "forced": budget == 0, "ms": ms,
                "ms_per_step": ms / T, "plain_ms": plain_ms, "bound_ms": b_ms,
                "bound_by": b_by, "bytes": nbytes, "ops": ops,
                "touched_rows": {"l2": len(l2_rows), "llc": len(llc_rows)},
                "rows_copied": copied, "state_bytes_moved": moved}

    engine_shapes = [engine_case(sky, "skylake_sp", (16, 128)),
                     engine_case(sky, "skylake_sp", (64, 128)),
                     engine_case(sky, "skylake_sp", (128, 128)),
                     engine_case(sky, "skylake_sp", (512,)),
                     engine_case(sky, "skylake_sp", (1536,)),
                     engine_case(table1, "table1", (16, 128)),
                     engine_case(table1, "table1", (1536,)),
                     # the copy-on-touch design on skylake_sp, forced
                     engine_case(sky, "skylake_sp", (16, 128), budget=0),
                     engine_case(sky, "skylake_sp", (1536,), budget=0)]
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
                 "fleet_matrix_launches": loop["matrix"]["engine_launches"],
                 "shapes": engine_shapes,
                 "main_by_shape": out["main"]["breakdown"]["by_shape_GBT"],
                 "card": card})

    def lru_case(tags, age, streams, clock0, what, plain=True):
        """Device time of one `lru_sets` launch beside its bound and, with
        ``plain``, its plain version (after holding the two equal)."""
        n_, W_ = tags.shape
        T_ = streams.shape[1]
        if plain:
            smoke._lru_pair(sim_ops, sim_ref, tags, age, streams, clock0,
                            f"timed {what} {n_}x{W_}x{T_}")
        valid = int((streams >= 0).sum())
        b_ms, b_by = bound(n_ * W_ * 16 + n_ * T_ * 4 + n_ * T_,
                           2 * W_ * valid)
        ms = smoke.device_ms(lambda: sim_ops.simulate_rows(
            tags, age, streams, clock0=clock0))
        return {"shape": [n_, W_, T_], "rows": what, "ms": ms,
                "us_per_step": ms * 1e3 / T_, "bound_ms": b_ms,
                "bound_by": b_by,
                "plain_ms": smoke.timeit(lambda: sim_ref.lru_sets_ref(
                    tags, age, streams, clock0=clock0), reps=1, warmup=0)
                if plain else None}

    i32 = torch.int32
    lru_shapes = [lru_case(rows_tags, rows_age, rows_streams, rows_clock0,
                           "skylake_sp LLC rows")]
    for n_, W_, T_ in ((8192, 8, 128), (1024, 16, 512)):
        args_ = [smoke.t(x, i32) for x in smoke.lru_random_rows(n_, W_, T_)]
        lru_shapes.append(lru_case(*args_, 1, "random rows"))
    # one row alone: one warp's chain of touches, whose time a step is the
    # latency of one touch (the unit of the kernel's floor, T touches)
    args_ = [smoke.t(x, i32) for x in smoke.lru_random_rows(1, 8, 4096)]
    touch = lru_case(*args_, 1, "one row", plain=False)
    for sh in lru_shapes:
        sh["latency_floor_ms"] = sh["shape"][2] * touch["us_per_step"] / 1e3
    head = lru_shapes[0]
    rows.append({
        "name": "lru_sets", "route": "cuda",
        "source": SOURCES["lru_sets"][0], "replaces": SOURCES["lru_sets"][1],
        "launches": path_launches["lru_sets"],
        "path": "ops.simulate_rows, skylake_sp LLC rows",
        "run_cachex_launches": main_launches.get("lru_sets", 0),
        "max_abs_err": smoke.err["lru_sets"],
        "ms": head["ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": None, "us_per_step": head["us_per_step"],
        "latency_floor_ms": head["latency_floor_ms"],
        "touch_us": touch["us_per_step"], "shapes": lru_shapes,
        "shape": "({}, {}) x {}".format(*head["shape"]), "card": card})

    W, T = 8, 128
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
    rows += lm_kernel_rows(smoke, card, serve["prefill_float32"]["launches"])
    rows.append(triad_kernel_row(smoke, card,
                                 train["run"]["launches"]["triad"]))
    for r in rows:
        lib = (f", library {r['library_ms']:.4f} ms"
               if r["library_ms"] is not None else "")
        print(f"time {r['name']}: {r['ms']:.4f} ms (plain {r['plain_ms']:.2f}"
              f" ms, bound {r['bound_ms']:.7f} ms by {r['bound_by']}{lib}) "
              f"at {r['shape']}, {r['launches']} launches on its path, on "
              f"{card}")
    ssd = rows[4]
    print(f"time ssd_scan stages (device us per launch, torch.profiler, "
          f"{ssd['stage_profiles']} profile(s)): "
          + (f"{ssd['stage_us']}" if not ssd["stage_lost"] else
             f"{ssd['stage_us']}; LOST {ssd['stage_lost']}: the profiler "
             f"recorded no kernel of those stages in "
             f"{ssd['stage_profiles']} profiles, so they are not measured")
          + f" on {card}")
    for sh in rows[3]["shapes"][1:]:
        print(f"time flash_attention {sh['dtype']} {tuple(sh['shape'])}: "
              f"{sh['ms']:.4f} ms (plain {sh['plain_ms']:.2f} ms, bound "
              f"{sh['bound_ms']:.7f} ms by {sh['bound_by']}, library "
              f"{sh['library_ms']:.4f} ms) on {card}")
    tr_row = rows[-1]
    for sh in tr_row["shapes"]:
        print(f"time triad ({sh['rows']}, 128) = {sh['n_bytes'] >> 20} MiB "
              f"probe, {sh['bytes_moved'] / 1e6:.1f} MB moved: "
              f"{sh['ms'] * 1e3:.2f} us back to back "
              f"({sh['bytes_moved'] / sh['ms'] / 1e9:.3f} TB/s), "
              f"{sh['cold_ms'] * 1e3:.2f} us from a cold L2 "
              f"({sh['bytes_moved'] / sh['cold_ms'] / 1e9:.3f} TB/s); bound "
              f"{sh['bound_ms'] * 1e3:.2f} us; plain {sh['plain_ms'] * 1e3:.2f}"
              f" us; torch.addcmul {sh['library_ms'] * 1e3:.2f} us (cold "
              f"{sh['library_cold_ms'] * 1e3:.2f} us) on {card}")
    print(f"time triad, the monitor's reading at 64 MiB "
          f"(measure_hbm_bandwidth, device time): "
          f"{tr_row['monitor_event_ms'] * 1e3:.2f} us "
          f"({tr_row['monitor_event_tb_per_s']:.3f} TB/s); one launch from "
          f"Python on an idle device: CUDA events around it "
          f"{tr_row['python_event_ms'] * 1e3:.2f} us "
          f"({tr_row['python_event_tb_per_s']:.3f} TB/s), host clock around "
          f"it and a synchronize {tr_row['monitor_host_ms'] * 1e3:.2f} us "
          f"({tr_row['monitor_host_tb_per_s']:.3f} TB/s); medians of 10 on "
          f"{card}")
    lru = rows[1]
    for sh in lru["shapes"]:
        print(f"time lru_sets {sh['rows']} {tuple(sh['shape'])} (rows, "
              f"ways, steps): {sh['ms']:.4f} ms, {sh['us_per_step']:.4f} us "
              f"a step (plain {sh['plain_ms']:.2f} ms, bound "
              f"{sh['bound_ms']:.7f} ms by {sh['bound_by']}, latency floor "
              f"{sh['latency_floor_ms']:.4f} ms = {sh['shape'][2]} touches of "
              f"{lru['touch_us']:.4f} us, one row's 4096-step chain) on "
              f"{card}")
    for s in engine_shapes:
        print(f"time cachesim_engine {s['entry']} {s['geometry']} "
              f"{tuple(s['shape'])}, {s['design']} design"
              f"{' (forced)' if s['forced'] else ''}: {s['ms']:.4f} ms, "
              f"{s['ms_per_step'] * 1e3:.4f} us a step (plain "
              f"{s['plain_ms']:.2f} ms, bound {s['bound_ms']:.7f} ms by "
              f"{s['bound_by']}, {s['bytes']} bytes, touched rows "
              f"{s['touched_rows']}, state bytes its design moves "
              f"{s['state_bytes_moved']}, rows copied {s['rows_copied']}) "
              f"on {card}")
    out["kernels"] = rows
    out["phases"]["total_s"] = time.perf_counter() - t_all
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1) + "\n")
    print(f"total: {out['phases']['total_s']:.1f} s")
    print_cost_constants(loop["cost_constants"])
    print(json.dumps({"kernels": rows}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
