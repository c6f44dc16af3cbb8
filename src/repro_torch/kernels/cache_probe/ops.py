"""Entry points of the cache-probe kernels: the HBM streaming probe and the
batched Prime+Probe verdicts (`repro.kernels.cache_probe.ops` in the JAX
package)."""

from __future__ import annotations

import time
from typing import Tuple

import torch

import repro_torch
from repro_torch.kernels.cache_probe.kernel import (prime_probe, triad,
                                                    triad_device_seconds)

__all__ = ["probe_triad", "probe_verdicts", "measure_hbm_bandwidth"]


def probe_triad(a: torch.Tensor, b: torch.Tensor,
                scale: torch.Tensor) -> torch.Tensor:
    """``a * scale + b``: one triad launch on CUDA tensors."""
    return triad(a, b, scale)


def probe_verdicts(tags: torch.Tensor, age: torch.Tensor,
                   streams: torch.Tensor, targets: torch.Tensor,
                   clock0: int = 1) -> torch.Tensor:
    """Batched multi-set Prime+Probe eviction verdicts (one launch).

    B simultaneous single-set eviction tests over pre-resolved set rows.
    The probing pipeline (`run_cachex`) does not call it: its eviction
    tests run on the full machine engine, which adds slices, the L2 level
    and back-invalidation.  It is held against `ref.prime_probe_ref` and
    against that engine on a single-level geometry in the tests.
    """
    return prime_probe(tags, age, streams, targets, clock0=clock0)


def measure_hbm_bandwidth(n_bytes: int = 256 * (1 << 20), reps: int = 3,
                          device=None) -> Tuple[float, float]:
    """Run the triad over an ``n_bytes`` working set; returns
    (effective_bytes_per_s, seconds per triad).  ``device`` None means the
    card.

    The row and byte arithmetic is the JAX function's: three f32 streams,
    rows of 128 rounded down to a multiple of 8 (at least 8).  On the card
    the ``reps`` launches are timed on the device
    (`kernel.triad_device_seconds`): one 64 MiB triad takes about 20 us,
    the same order as one launch from Python plus one synchronize, so a
    host clock around ``reps=1`` (the monitor's setting) would time the
    host, and so would CUDA events around a Python launch on an idle
    device.  The JAX function's warm call (its compile) becomes loading
    the kernel's module before the first event, which launches nothing:
    a probe is ``reps`` launches.  On the CPU the plain version runs under
    the host clock (the only clock there) and each call counts in
    ``_build.PLAIN_CALLS``."""
    dev = repro_torch.resolve_device(device)
    n_elems = n_bytes // 4 // 3          # three f32 streams
    rows = max(8, (n_elems // 128) // 8 * 8)
    a = torch.ones((rows, 128), dtype=torch.float32, device=dev)
    b = torch.ones((rows, 128), dtype=torch.float32, device=dev)
    s = torch.ones((1,), dtype=torch.float32, device=dev)
    bytes_moved = rows * 128 * 4 * 3
    if dev.type == "cpu":
        t0 = time.perf_counter()
        for _ in range(reps):
            probe_triad(a, b, s)
        dt = (time.perf_counter() - t0) / reps
        return bytes_moved / dt, dt
    with torch.cuda.device(dev):
        dt = triad_device_seconds(a, b, s, reps)
    return bytes_moved / dt, dt
