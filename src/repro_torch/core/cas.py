"""CAS — LLC-contention-aware task scheduling (paper §4.1).

Policy layer consuming VSCAN's per-LLC eviction rates.  Faithful to the
paper's design points:

  * domains are classified into **qualitative tiers** by eviction rate
    (lower rate = higher rank),
  * a domain's tier only changes after its rate moves consistently in one
    direction for **three consecutive monitoring intervals** (prevents
    task bouncing on transient contention),
  * task placement prefers **idle vCPUs in higher-ranked domains**; cache
    affinity (previous vCPU / waker's domain) is honoured only *within* a
    tier — this is what breaks the "counterproductive cache affinity" of
    §2.2,
  * load balancing may not pull tasks from a less- to a more-contended
    domain unless the source domain is saturated.

The same tier machinery is reused by CAP for per-color contention and by
the TPU adaptation layer (`tpuprobe/monitor.py`) for per-chip/per-link
contention — the paper's policy, generic over "domains".

A deliberately small discrete-time scheduler simulation (`MiniSched`)
validates the Fig 10 behaviour: under asymmetric contention, CAS steers
cache-sensitive tasks to the quiet domain while EEVDF-like affinity pins
them to their (possibly polluted) birth domain.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

HYSTERESIS_INTERVALS = 3


class TierTracker:
    """Qualitative contention tiers with 3-interval hysteresis (§4.1)."""

    def __init__(self, keys: Sequence, thresholds: Sequence[float] = (0.5, 4.0),
                 hysteresis: int = HYSTERESIS_INTERVALS):
        self.thresholds = list(thresholds)   # tier i if rate < thresholds[i]
        self.hysteresis = hysteresis
        self.tier: Dict = {k: 0 for k in keys}
        self._pending: Dict = {k: (0, 0) for k in keys}  # (direction, count)

    def _instant_tier(self, rate: float) -> int:
        for i, t in enumerate(self.thresholds):
            if rate < t:
                return i
        return len(self.thresholds)

    def update(self, rates: Dict) -> Dict:
        """Feed one monitoring interval of EWMA rates; returns committed
        tiers (lower tier == less contended == ranked higher)."""
        for k, rate in rates.items():
            cur = self.tier.setdefault(k, 0)
            inst = self._instant_tier(rate)
            direction = (inst > cur) - (inst < cur)
            pdir, cnt = self._pending.get(k, (0, 0))
            if direction == 0:
                self._pending[k] = (0, 0)
                continue
            cnt = cnt + 1 if direction == pdir else 1
            if cnt >= self.hysteresis:
                self.tier[k] = inst
                self._pending[k] = (0, 0)
            else:
                self._pending[k] = (direction, cnt)
        return dict(self.tier)

    def ranked(self) -> List:
        """Keys ordered best (least contended) first."""
        return sorted(self.tier, key=lambda k: self.tier[k])

    def on_contention(self, view) -> Dict:
        """`CacheXSession.subscribe` hook: consume one published
        contention update (anything with a ``per_domain`` rate dict) as a
        monitoring interval.  The scheduler never polls VScan directly —
        it sits on the session's published abstraction."""
        return self.update(view.per_domain)


@dataclasses.dataclass
class PlacementRequest:
    prev_vcpu: Optional[int] = None
    waker_vcpu: Optional[int] = None


def select_vcpu(idle_vcpus: Sequence[int], vcpu_domain: Dict[int, int],
                tiers: Dict[int, int], req: PlacementRequest) -> Optional[int]:
    """scx_rusty-style CPU selection with CAS's domain-tier preference.

    Candidates are grouped by their domain's committed tier; within the best
    non-empty tier, prefer (1) the task's previous vCPU, (2) a vCPU in the
    waker's domain, (3) any idle vCPU.
    """
    if not idle_vcpus:
        return None
    best_tier = min(tiers.get(vcpu_domain[v], 0) for v in idle_vcpus)
    cands = [v for v in idle_vcpus
             if tiers.get(vcpu_domain[v], 0) == best_tier]
    if req.prev_vcpu in cands:
        return req.prev_vcpu
    if req.waker_vcpu is not None:
        wd = vcpu_domain.get(req.waker_vcpu)
        same = [v for v in cands if vcpu_domain[v] == wd]
        if same:
            return same[0]
    return cands[0]


def allow_pull(src_domain: int, dst_domain: int, tiers: Dict[int, int],
               src_utilization: float, saturation: float = 0.9) -> bool:
    """Load-balance guard (§4.1): never pull from a less-contended to a
    more-contended domain unless the source is saturated."""
    if tiers.get(dst_domain, 0) > tiers.get(src_domain, 0):
        return src_utilization >= saturation
    return True


def policy_place(policy: str, idle: Sequence[int], vcpu_domain: Dict[int, int],
                 tiers: Optional[Dict[int, int]], prev_vcpu: Optional[int],
                 rr_index: int = 0) -> Optional[int]:
    """Place one waking task under a named scheduling policy.

    Shared by :class:`MiniSched` (the toy Fig 10 harness) and the closed-loop
    fleet simulator (`repro_torch.core.fleet`):

      * ``"cas"``   — :func:`select_vcpu` over the committed contention tiers
        (affinity honoured only within the best tier),
      * ``"rusty"`` — scx_rusty-like: previous vCPU if idle, else a
        round-robin pick indexed by ``rr_index``,
      * ``"eevdf"`` — strong cache affinity: previous vCPU, else any idle
        vCPU in the previous vCPU's domain, else the first idle vCPU.
    """
    idle = sorted(idle)
    if not idle:
        return None
    if policy == "cas":
        return select_vcpu(idle, vcpu_domain, tiers or {},
                           PlacementRequest(prev_vcpu=prev_vcpu))
    if policy == "rusty":
        return prev_vcpu if prev_vcpu in idle else idle[rr_index % len(idle)]
    if policy == "eevdf":
        if prev_vcpu in idle:
            return prev_vcpu
        prev_d = vcpu_domain.get(prev_vcpu, None)
        same = [x for x in idle if vcpu_domain[x] == prev_d]
        return same[0] if same else idle[0]
    raise ValueError(f"unknown policy {policy!r}")


# ---------------------------------------------------------------------------
# MiniSched: discrete-time validation harness for Fig 10.
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SimTask:
    name: str
    sensitivity: float        # IPC penalty slope vs contention
    vcpu: Optional[int] = None
    done_work: float = 0.0


class MiniSched:
    """Tasks run one tick per interval on their vCPU; per-tick progress is
    ``1 / (1 + sensitivity * contention[domain])`` — the IPC model behind
    Fig 2a/10.  Scheduler policies decide placement at wakeup each tick."""

    def __init__(self, vcpu_domain: Dict[int, int], policy: str,
                 tier_tracker: Optional[TierTracker] = None, seed: int = 0):
        self.vcpu_domain = vcpu_domain
        self.policy = policy                  # "eevdf" | "rusty" | "cas"
        self.tiers = tier_tracker
        self.rng = np.random.default_rng(seed)
        self.domain_residency: Dict[str, Dict[int, int]] = {}

    def tick(self, tasks: List[SimTask], contention: Dict[int, float],
             rates: Optional[Dict[int, float]] = None) -> None:
        if self.policy == "cas" and self.tiers is not None and rates:
            self.tiers.update(rates)
        free = set(self.vcpu_domain)
        order = self.rng.permutation(len(tasks))
        for ti in order:
            task = tasks[ti]
            idle = sorted(free)
            if not idle:
                break
            v = policy_place(self.policy, idle, self.vcpu_domain,
                             self.tiers.tier if self.tiers else None,
                             task.vcpu, rr_index=int(ti))
            task.vcpu = v
            free.discard(v)
            d = self.vcpu_domain[v]
            task.done_work += 1.0 / (1.0 + task.sensitivity * contention[d])
            self.domain_residency.setdefault(task.name, {}).setdefault(d, 0)
            self.domain_residency[task.name][d] += 1
