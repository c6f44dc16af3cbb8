"""The CacheX monitor on the card: the paper's VSCAN loop over the card's
memory bandwidth.  The port of `repro.tpuprobe.monitor`.

Probed resource: the card's effective HBM bandwidth, from the CUDA STREAM
triad (`kernels.cache_probe.ops.measure_hbm_bandwidth`).  The structure is
the paper's and the JAX module's, arithmetic for arithmetic: periodic
probes between steps (the idle-step analogue of pausing VM workloads),
*slowdown* = nominal / effective bandwidth, EWMA smoothing, auto-shrinking
probe size when the budget is blown, and qualitative tiers with
3-interval hysteresis (`core.cas.TierTracker`) feeding
`distributed.rebalance.StragglerMitigator`.

Clock injection: ``clock=None`` times the real kernel on the monitor's
device (``device`` None means the card); a `SimClock` plays back a
contention schedule instead, so the control path (probe -> EWMA -> tier
-> rebalance) runs identically on the CPU.  As in the JAX module, every
device index probes the one device the monitor runs on: ``n_devices``
probes are ``n_devices`` triad launches there.  Probing each card of a
node waits for the multi-card slice.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional

import numpy as np

import repro_torch
from repro_torch.core.cas import TierTracker
from repro_torch.launch.mesh import HBM_BW

__all__ = ["ProbeSample", "SimClock", "PodMonitor"]


@dataclasses.dataclass
class ProbeSample:
    device: int
    effective_bw: float      # bytes/s
    slowdown: float          # nominal / effective  (>= 1.0 under contention)
    t: float


class SimClock:
    """Deterministic contention playback for CPU-only validation.

    `schedule(device, t)` -> slowdown factor; the monitor's probe timing is
    synthesized as nominal_time * slowdown.
    """

    def __init__(self, schedule: Callable[[int, float], float]):
        self.schedule = schedule
        self.t = 0.0

    def advance(self, dt: float) -> None:
        self.t += dt

    def probe_time(self, device: int, nominal_s: float) -> float:
        return nominal_s * float(self.schedule(device, self.t))


class PodMonitor:
    """Periodic per-device contention monitor + tier tracker."""

    def __init__(self, n_devices: int, clock: Optional[SimClock] = None,
                 probe_bytes: int = 64 * (1 << 20),
                 ewma_alpha: float = 0.3,
                 tier_thresholds=(1.15, 1.5),
                 interval_s: float = 1.0, device=None):
        self.n_devices = n_devices
        self.clock = clock
        # only a real probe runs on a device; a SimClock needs none
        self.device = (repro_torch.resolve_device(device) if clock is None
                       else None)
        self.probe_bytes = probe_bytes
        self.default_probe_bytes = probe_bytes
        self.ewma_alpha = ewma_alpha
        self.interval_s = interval_s
        self.ewma = np.ones(n_devices)          # slowdown EWMA
        self.tiers = TierTracker(keys=list(range(n_devices)),
                                 thresholds=list(tier_thresholds))
        self.history: List[List[ProbeSample]] = []

    # -- one monitoring interval ------------------------------------------------
    def probe_once(self) -> List[ProbeSample]:
        nominal_s = self.probe_bytes / HBM_BW
        samples = []
        for d in range(self.n_devices):
            if self.clock is not None:
                dt = self.clock.probe_time(d, nominal_s)
                t = self.clock.t
            else:  # real hardware: time the triad kernel on the card
                from repro_torch.kernels.cache_probe.ops import \
                    measure_hbm_bandwidth
                _, dt = measure_hbm_bandwidth(self.probe_bytes, reps=1,
                                              device=self.device)
                t = time.time()
            eff = self.probe_bytes / max(dt, 1e-12)
            slow = max(1.0, HBM_BW / eff) if self.clock is None else \
                max(1.0, dt / nominal_s)
            samples.append(ProbeSample(device=d, effective_bw=eff,
                                       slowdown=slow, t=t))
        slows = np.array([s.slowdown for s in samples])
        self.ewma = (1 - self.ewma_alpha) * self.ewma + self.ewma_alpha * slows
        self.tiers.update({d: float(self.ewma[d])
                           for d in range(self.n_devices)})
        # auto-shrink (paper §3.3): if the probe budget is blown everywhere,
        # halve the probe size; restore when quiet
        if float(slows.min()) > 2.0:
            self.probe_bytes = max(self.probe_bytes // 2, 1 << 20)
        elif float(slows.max()) < 1.05:
            self.probe_bytes = self.default_probe_bytes
        self.history.append(samples)
        if self.clock is not None:
            self.clock.advance(self.interval_s)
        return samples

    # -- consumers ------------------------------------------------------------
    def device_tiers(self) -> Dict[int, int]:
        return dict(self.tiers.tier)

    def slow_devices(self, tier_at_least: int = 1) -> List[int]:
        return [d for d, t in self.tiers.tier.items() if t >= tier_at_least]

    def per_device_slowdown(self) -> np.ndarray:
        return self.ewma.copy()
