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
-> rebalance) runs identically on the CPU.

The nominal: under a `SimClock` it is the spec sheet's bandwidth
(`launch.mesh.HBM_BW`), as in the JAX module.  On a device it is the
triad's own idle time at the probe's size: the first probe takes the
best of `_CALIBRATION_PROBES` triads at every size the auto-shrink can
reach (`_probe_sizes`: the default halved down to 1 MiB), and every
later probe is read against its size's time (slowdown = time / idle
time = idle rate / effective rate).  A 64 MiB triad moves
2.5-2.6 TB/s on an idle H100, so the spec's 3.35 TB/s would read a
slowdown of about 1.3, and a tier, with no co-tenant.  Nothing is
calibrated after the first probe: a shrink happens under contention,
and a nominal read then would hide it.  The first probe must therefore
find the card idle: a co-tenant already running then would become the
nominal.  So after calibrating, the monitor holds the rate at its
largest size against the spec: at 64 MiB or more a rate below
`_IDLE_NOMINAL_MIN_SHARE` (0.7) of `HBM_BW` warns once with a
`RuntimeWarning` naming both rates (an idle H100 80GB HBM3 moves
0.74-0.80 of the spec at 64 MiB).  As in the JAX module, every
device index probes the one device the monitor runs on: ``n_devices``
probes are ``n_devices`` triad launches there.  Probing each card of a
node waits for the multi-card slice.
"""

from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Callable, Dict, List, Optional

import numpy as np

import repro_torch
from repro_torch.core.cas import TierTracker
from repro_torch.launch.mesh import HBM_BW

__all__ = ["ProbeSample", "SimClock", "PodMonitor"]

#: triads whose best time sets the nominal bandwidth at a probe size
_CALIBRATION_PROBES = 5
#: the auto-shrink's smallest probe
_MIN_PROBE_BYTES = 1 << 20
#: the least share of the spec bandwidth an idle nominal may have at a
#: probe size of at least `_NOMINAL_CHECK_BYTES`, or the monitor warns
_IDLE_NOMINAL_MIN_SHARE = 0.7
_NOMINAL_CHECK_BYTES = 64 * (1 << 20)


def _shrunk(probe_bytes: int) -> int:
    return max(probe_bytes // 2, _MIN_PROBE_BYTES)


def _probe_sizes(default_bytes: int) -> List[int]:
    """Every probe size the auto-shrink can reach from the default."""
    sizes = [default_bytes]
    while _shrunk(sizes[-1]) not in sizes:
        sizes.append(_shrunk(sizes[-1]))
    return sizes


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
        self._idle_s: Dict[int, float] = {}     # probe bytes -> seconds
        self._calibration_launches = 0          # triads the nominal took

    # -- the nominal on a device -------------------------------------------------
    def _triad_seconds(self, n_bytes: int) -> float:
        from repro_torch.kernels.cache_probe import ops
        return ops.measure_hbm_bandwidth(n_bytes, reps=1,
                                         device=self.device)[1]

    def _idle_seconds(self) -> float:
        """The idle triad's seconds at the current probe size.  The first
        call calibrates every size the shrink can reach, each the best of
        `_CALIBRATION_PROBES` triads; later calls only read them."""
        if not self._idle_s:
            from repro_torch import _build
            before = _build.LAUNCHES["triad"] + _build.PLAIN_CALLS["triad"]
            for nb in _probe_sizes(self.default_probe_bytes):
                self._idle_s[nb] = min(self._triad_seconds(nb)
                                       for _ in range(_CALIBRATION_PROBES))
            self._calibration_launches += (_build.LAUNCHES["triad"]
                                           + _build.PLAIN_CALLS["triad"]
                                           - before)
            self._check_nominal()
        return self._idle_s[self.probe_bytes]

    def _check_nominal(self) -> None:
        """Warn when the calibrated nominal at the largest size looks
        contended: a co-tenant running at the first probe would otherwise
        become the idle reference, and every later reading would hide
        it."""
        nb = max(self._idle_s)
        rate = nb / self._idle_s[nb]
        if (nb >= _NOMINAL_CHECK_BYTES
                and rate < _IDLE_NOMINAL_MIN_SHARE * HBM_BW):
            warnings.warn(
                f"PodMonitor: the idle nominal at {nb >> 20} MiB moves "
                f"{rate / 1e12:.3f} TB/s, below {_IDLE_NOMINAL_MIN_SHARE} "
                f"of the spec {HBM_BW / 1e12:.2f} TB/s: was the device "
                f"busy at the first probe?  Later slowdowns are read "
                f"against this rate.", RuntimeWarning, stacklevel=3)

    # -- one monitoring interval ------------------------------------------------
    def probe_once(self) -> List[ProbeSample]:
        nominal_s = (self.probe_bytes / HBM_BW if self.clock is not None
                     else self._idle_seconds())
        samples = []
        for d in range(self.n_devices):
            if self.clock is not None:
                dt = self.clock.probe_time(d, nominal_s)
                t = self.clock.t
            else:  # real hardware: time the triad kernel on the card
                dt = self._triad_seconds(self.probe_bytes)
                t = time.time()
            eff = self.probe_bytes / max(dt, 1e-12)
            slow = max(1.0, dt / nominal_s)
            samples.append(ProbeSample(device=d, effective_bw=eff,
                                       slowdown=slow, t=t))
        slows = np.array([s.slowdown for s in samples])
        self.ewma = (1 - self.ewma_alpha) * self.ewma + self.ewma_alpha * slows
        self.tiers.update({d: float(self.ewma[d])
                           for d in range(self.n_devices)})
        # auto-shrink (paper §3.3): if the probe budget is blown everywhere,
        # halve the probe size; restore when quiet
        if float(slows.min()) > 2.0:
            self.probe_bytes = _shrunk(self.probe_bytes)
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
