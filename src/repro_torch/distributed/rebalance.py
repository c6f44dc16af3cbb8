"""CAS on the card: contention-aware work placement.  The port of
`repro.distributed.rebalance` (numpy, unchanged arithmetic).

The paper's CAS (§4.1) steers tasks to idle vCPUs in less-contended LLC
domains.  Here the "tasks" are units of shardable work and the "domains"
are cards whose effective bandwidth the monitor tracks:

  * **microbatch rebalancing** (data axis): per-device microbatch counts
    are re-weighted inversely to the EWMA slowdown, so a throttled or
    noisy-neighbour card stops gating the step (straggler mitigation
    without killing the step),
  * **expert re-placement** (EP axis, MoE): the expert->device binding is
    re-ranked so the hottest experts (by router load) sit on the
    least-contended cards, with the paper's hysteresis: bindings only
    move after the tier tracker commits (3 consecutive intervals).

`StragglerMitigator.on_contention` / `ExpertRebalancer.on_contention`
consume any published view whose ``per_domain`` maps a device to its EWMA
slowdown, as `TierTracker.on_contention` consumes the LLC session.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.cas import TierTracker

__all__ = ["rebalanced_microbatches", "ExpertPlacement", "replace_experts",
           "StragglerMitigator", "ExpertRebalancer"]


def rebalanced_microbatches(slowdown: np.ndarray, total_microbatches: int,
                            min_per_device: int = 1) -> np.ndarray:
    """Integer microbatch counts per device ~ 1/slowdown (sum preserved).

    With a uniform fleet this returns the uniform split; one slow chip
    sheds work to the others.  Largest-remainder rounding keeps the sum
    exact.
    """
    n = len(slowdown)
    speed = 1.0 / np.maximum(np.asarray(slowdown, np.float64), 1.0)
    share = speed / speed.sum() * total_microbatches
    base = np.maximum(np.floor(share).astype(int), min_per_device)
    # largest-remainder correction to preserve the total
    deficit = total_microbatches - int(base.sum())
    if deficit > 0:
        order = np.argsort(-(share - base))
        for i in order[:deficit]:
            base[i] += 1
    elif deficit < 0:
        order = np.argsort(share - base)
        for i in order:
            if deficit == 0:
                break
            if base[i] > min_per_device:
                base[i] -= 1
                deficit += 1
    return base


@dataclasses.dataclass
class ExpertPlacement:
    expert_to_device: np.ndarray       # (E,) device id per expert

    def permutation(self, n_experts: int) -> np.ndarray:
        return self.expert_to_device


def replace_experts(expert_load: np.ndarray, device_tiers: Dict[int, int],
                    experts_per_device: int) -> ExpertPlacement:
    """Bind the heaviest experts to the least-contended devices.

    `expert_load`: (E,) router token counts (EWMA).  Devices are ranked by
    committed tier (ties: id); experts by load, assigned round-robin so
    every device keeps `experts_per_device`.
    """
    E = len(expert_load)
    devices = sorted(device_tiers, key=lambda d: (device_tiers[d], d))
    order = np.argsort(-np.asarray(expert_load))
    placement = np.zeros(E, int)
    slot = {d: 0 for d in devices}
    di = 0
    for e in order:
        # next device with spare capacity, best tier first
        while slot[devices[di % len(devices)]] >= experts_per_device:
            di += 1
        d = devices[di % len(devices)]
        placement[e] = d
        slot[d] += 1
        di += 1
    return ExpertPlacement(expert_to_device=placement)


class StragglerMitigator:
    """Step-level controller: watches the monitor, commits rebalances with the
    paper's 3-interval hysteresis, and exposes the current plan."""

    def __init__(self, n_devices: int, total_microbatches: int,
                 hysteresis: int = 3):
        self.n_devices = n_devices
        self.total = total_microbatches
        self.plan = rebalanced_microbatches(np.ones(n_devices), total_microbatches)
        self._pending: Optional[np.ndarray] = None
        self._pending_count = 0
        self.hysteresis = hysteresis
        self.rebalances = 0

    def update(self, slowdown: np.ndarray) -> np.ndarray:
        proposal = rebalanced_microbatches(slowdown, self.total)
        if np.array_equal(proposal, self.plan):
            self._pending, self._pending_count = None, 0
            return self.plan
        if self._pending is not None and np.array_equal(proposal,
                                                        self._pending):
            self._pending_count += 1
        else:
            self._pending, self._pending_count = proposal, 1
        if self._pending_count >= self.hysteresis:
            self.plan = proposal
            self._pending, self._pending_count = None, 0
            self.rebalances += 1
        return self.plan

    def step_time(self, slowdown: np.ndarray,
                  per_microbatch_s: float = 1.0) -> float:
        """Modelled step wall time = max over devices of work x slowdown."""
        return float(np.max(self.plan * np.maximum(slowdown, 1.0))) * \
            per_microbatch_s

    def on_contention(self, view) -> np.ndarray:
        """`CacheXSession.subscribe` hook: one published ContentionView
        (``per_domain`` = per-chip slowdown) is one decision interval."""
        slow = np.array([float(view.per_domain.get(d, 1.0))
                         for d in range(self.n_devices)])
        return self.update(slow)


class ExpertRebalancer:
    """Session-driven MoE expert re-placement — the paper's task
    migration, on the EP axis, with its hysteresis intact.

    The binding only moves when the device `TierTracker` *commits* a tier
    change (3 consecutive intervals by default): transient contention
    shifts the pending counter, never the placement, so experts don't
    bounce between chips (§4.1's anti-bouncing rule).  Router load is
    EWMA-smoothed separately; load drift alone re-ranks experts *within*
    the committed tier ordering only when a commit happens.
    """

    def __init__(self, n_experts: int, n_devices: int,
                 experts_per_device: Optional[int] = None,
                 thresholds: Sequence[float] = (1.15, 1.5),
                 hysteresis: int = 3, ewma_alpha: float = 0.3):
        if experts_per_device is None:
            experts_per_device = max(1, n_experts // n_devices)
        self.n_experts = n_experts
        self.n_devices = n_devices
        self.experts_per_device = experts_per_device
        self.ewma_alpha = ewma_alpha
        self.tiers = TierTracker(keys=list(range(n_devices)),
                                 thresholds=list(thresholds),
                                 hysteresis=hysteresis)
        self.load = np.ones(n_experts)
        self.placement = replace_experts(self.load, self.tiers.tier,
                                         experts_per_device)
        self._last_committed = dict(self.tiers.tier)
        self.moves = 0
        self.rebalances = 0

    def update_load(self, expert_load: np.ndarray) -> None:
        a = self.ewma_alpha
        self.load = (1 - a) * self.load + a * np.asarray(expert_load, float)

    def on_contention(self, view) -> ExpertPlacement:
        """One published ContentionView = one tier interval; re-place only
        after the tracker commits."""
        committed = self.tiers.update(
            {d: float(view.per_domain.get(d, 1.0))
             for d in range(self.n_devices)})
        if committed != self._last_committed:
            proposal = replace_experts(self.load, committed,
                                       self.experts_per_device)
            moved = int(np.sum(proposal.expert_to_device
                               != self.placement.expert_to_device))
            if moved:
                self.moves += moved
                self.rebalances += 1
                self.placement = proposal
            self._last_committed = dict(committed)
        return self.placement
