"""AttackerGuest — adversarial co-tenancy as a first-class scenario.

A Prime+Probe attacker needs exactly the machinery this repo already
builds for the *victim*: eviction sets over opaque (set, slice) cells.
So the attacker is just another `CacheXSession` attached to a second
`GuestVM` on the victim's `SimHost` — it pays the same attach cost,
discovers the same abstraction, and compiles its attack windows through
ProbePlan so attacks cost dispatches like any other probe.

The attack proceeds in three phases:

  1. **profile** — the attacker primes every one of its own monitored
     cells, lets the victim run, and probes: cells the victim touched
     (its hot colors — VSCAN primes, working-set traversals) come back
     evicted, ranking the shared cells by victim activity.  Profiling is
     passive from the victim's perspective: the victim's own priming
     simply overwrites the attacker's lines.

  2. **attack traffic** — the attacker's cross-VM *effect* is its
     priming stream: a `CotenantWorkload` that sweeps the chosen target
     sets' lines deterministically, refilling each victim cell every
     window.  From the victim's monitor this is the classic signature —
     periodic whole-set evictions concentrated on few sets — which is
     what `repro_torch.core.shield.CacheShield` detects.

  3. **observe** — windowed Prime+Probe (`variant="primeprobe"`: time
     every line of each target set) or flush-less Evict+Time
     (`variant="evicttime"`: prime the set, time a single resident line
     — no clflush analogue needed), compiled to plans labeled
     ``attack.primeprobe`` / ``attack.evicttime``.  The attacker's own
     traffic is paused during its measurement window so it observes the
     victim, not itself.

The defense story (`FleetSim(attack=...)`): CAT way isolation re-carves
the victim's allocation so the attacker's evictions can no longer reach
it — modeled by a ``cat`` `HostEvent` plus disabling the attack stream.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.core.abstraction import CacheXSession, ProbeConfig
from repro_torch.core.cachesim import LLC_MISS_THRESHOLD
from repro_torch.core.host_model import CotenantWorkload, GuestVM, SimHost
from repro_torch.core.platforms import CachePlatform, get_platform
from repro_torch.core import probeplan
from repro_torch.core.probeplan import (Commit, Measure, ProbePlan,
                                        Segment, Wait, WarmTimer)

#: Attack-stream intensity: accesses per target line per ms.  Each target
#: cell holds `ways` lines, so one window at the default 7 ms re-primes
#: every cell dozens of times — the "periodic whole-set eviction" shape.
ATTACK_RATE_PER_LINE_MS = 12.0
#: Eviction fraction above which the attacker scores a window as
#: victim-active on a target set.
HIT_FRAC = 0.5


@dataclasses.dataclass(frozen=True)
class AttackObservation:
    """One attack window as the attacker saw it."""

    target_indices: Tuple[int, ...] = ()
    frac: Tuple[float, ...] = ()     # per-target evicted fraction
    window_ms: float = 0.0
    time_ms: float = 0.0

    @property
    def victim_active(self) -> Tuple[bool, ...]:
        return tuple(f >= HIT_FRAC for f in self.frac)


@dataclasses.dataclass
class AttackReport:
    """Aggregate of an attack run (benchmarks / tests)."""

    platform: str
    variant: str
    windows: int = 0
    n_targets: int = 0
    hit_windows: int = 0       # windows where >=1 target was victim-active
    mean_frac: float = 0.0
    attach_dispatches: int = 0
    attack_dispatches: int = 0


class AttackerGuest:
    """A malicious co-tenant VM running Prime+Probe against host neighbors."""

    def __init__(self, host: SimHost,
                 platform: Union[str, CachePlatform],
                 seed: int = 0, name: str = "mallory",
                 n_guest_pages: int = 1 << 12,
                 variant: str = "primeprobe",
                 config: Optional[ProbeConfig] = None):
        if variant not in ("primeprobe", "evicttime"):
            raise ValueError(f"unknown attack variant {variant!r}")
        self.platform = (get_platform(platform) if isinstance(platform, str)
                         else platform)
        self.name = name
        self.variant = variant
        machine = self.platform.machine()
        # a fresh co-located VM: fragmented mapping (it boots late, long
        # after contiguity is gone), modest footprint, vCPUs everywhere
        self.vm = GuestVM(host, n_guest_pages=n_guest_pages,
                          mapping="fragmented",
                          vcpu_cores=list(range(machine.n_cores)),
                          seed=seed + 7919)
        d0 = self.vm.stat_passes
        # prune_self_conflicts: cells thrashed by our *own* monitor would
        # read as permanently victim-active and poison target selection
        cfg = config or ProbeConfig.for_platform(
            self.platform, seed=seed, prune_self_conflicts=True)
        self.session = CacheXSession.attach(self.vm, self.platform, cfg)
        self.session.monitored_sets()       # build the scan grid eagerly
        self.attach_dispatches = self.vm.stat_passes - d0
        self.activity: Optional[np.ndarray] = None
        self.targets: List[int] = []
        self.active = False
        self._cotenant_name = f"attacker:{name}"
        self._mean_frac_sum = 0.0
        self.windows = 0
        self.hit_windows = 0

    # -- plan compilation ------------------------------------------------------
    def _sets(self):
        return self.session.monitored_sets()

    def _ops(self, idxs: Sequence[int], window_ms: Optional[float]):
        """Prime+Probe / Evict+Time ops over the given own-set indices."""
        mon = self._sets()
        by_prober = {}
        for i in idxs:
            by_prober.setdefault(mon[i].vcpu, []).append(i)
        order = [i for v in by_prober.values() for i in v]
        prime = Commit(segments=tuple(
            Segment(gvas=np.concatenate([mon[i].es.gvas for i in v]),
                    vcpu=vcpu)
            for vcpu, v in by_prober.items()))
        if self.variant == "evicttime":
            # flush-less Evict+Time: the prime evicted whatever the victim
            # had resident; timing ONE of our own lines after the window
            # tells whether the victim refilled the set (our line gone)
            lanes = tuple(mon[i].es.gvas[:1] for i in order)
        else:
            lanes = tuple(mon[i].es.gvas[::-1] for i in order)
        probe = Measure(lanes=lanes,
                        vcpus=tuple(mon[i].vcpu for i in order))
        ops = (prime,)
        if window_ms is not None:
            ops += (Wait(ms=window_ms),)
        ops += (WarmTimer(), probe)
        return ops, order

    def window_plan(self, window_ms: float,
                    idxs: Optional[Sequence[int]] = None) -> ProbePlan:
        """One attack window compiled to a ProbePlan: prime targets, wait,
        timed probe — the same IR (and dispatch accounting) as VSCAN's
        monitor, under the ``attack.*`` label namespace."""
        idxs = list(idxs) if idxs is not None else list(self.targets)
        ops, order = self._ops(idxs, window_ms)
        return ProbePlan(ops=ops, label=f"attack.{self.variant}",
                         hints=self.session.config.lowering,
                         meta={"order": order, "window_ms": window_ms})

    def _frac(self, order, lat_lanes) -> np.ndarray:
        return np.array([float(np.mean(l > LLC_MISS_THRESHOLD))
                         for l in lat_lanes])

    # -- phase 1: profile victim activity --------------------------------------
    def prime(self, idxs: Optional[Sequence[int]] = None) -> None:
        """Prime own sets (1 dispatch), committing our lines to the cells."""
        idxs = list(idxs) if idxs is not None else list(self.targets)
        ops, _ = self._ops(idxs, None)
        plan = ProbePlan(ops=ops[:1], label=f"attack.{self.variant}.prime",
                         hints=self.session.config.lowering)
        probeplan.execute(self.vm, plan)

    def probe(self, idxs: Optional[Sequence[int]] = None) -> np.ndarray:
        """Timed re-probe of own sets (no re-prime); returns per-set
        evicted fraction in the order of ``idxs``."""
        idxs = list(idxs) if idxs is not None else list(self.targets)
        ops, order = self._ops(idxs, None)
        plan = ProbePlan(ops=ops[-2:], label=f"attack.{self.variant}.probe",
                         hints=self.session.config.lowering)
        frac = self._frac(order, probeplan.execute(self.vm, plan).last)
        # back to idxs order
        pos = {i: p for p, i in enumerate(order)}
        return np.array([frac[pos[i]] for i in idxs])

    def profile(self, rounds: int = 1,
                between: Optional[Callable[[], None]] = None) -> np.ndarray:
        """Rank own cells by victim activity: prime everything, let the
        victim run (``between`` — in a simulation harness, e.g. the
        victim's `refresh()`), probe.  Returns mean evicted fraction per
        own monitored set; stored as ``self.activity``."""
        mon = self._sets()
        idxs = list(range(len(mon)))
        acc = np.zeros(len(mon))
        for _ in range(max(1, rounds)):
            self.prime(idxs)
            if between is not None:
                between()
            acc += self.probe(idxs)
        self.activity = acc / max(1, rounds)
        return self.activity

    def choose_targets(self, k: int = 4, domain: Optional[int] = None,
                       hot_colors: Optional[Sequence[int]] = None
                       ) -> List[int]:
        """Pick the ``k`` most-victim-active own sets (optionally pinned
        to one LLC domain / the victim's known-hot colors)."""
        mon = self._sets()
        cand = [i for i, m in enumerate(mon)
                if (domain is None or m.domain == domain)
                and (hot_colors is None or m.color in set(hot_colors))]
        if self.activity is not None:
            cand.sort(key=lambda i: -float(self.activity[i]))
        self.targets = cand[:max(1, k)]
        return list(self.targets)

    # -- phase 2: the attack stream (cross-VM effect) --------------------------
    def target_blocks(self) -> np.ndarray:
        """Host cache blocks of the target sets' lines — the addresses the
        attack stream sweeps.  (The host resolves the attacker's GVAs the
        same way it resolves any guest's traffic; this is the simulator's
        stand-in for the attacker replaying its own buffers.)"""
        mon = self._sets()
        gvas = np.concatenate([mon[i].es.gvas for i in self.targets])
        return self.vm._hpa_block(gvas)

    def begin(self, rate_per_ms: Optional[float] = None,
              domain: Optional[int] = None) -> CotenantWorkload:
        """Start emitting priming traffic into the host's co-tenant stream
        (the attack's effect on neighbors, interleaved into every window
        any guest waits through)."""
        if not self.targets:
            raise RuntimeError("choose_targets() before begin()")
        blocks = self.target_blocks()
        if rate_per_ms is None:
            rate_per_ms = ATTACK_RATE_PER_LINE_MS * len(blocks)
        if domain is None:
            domain = self._sets()[self.targets[0]].domain
        host = self.vm.host
        wl = host.cotenant(self._cotenant_name)
        if wl is None:
            wl = CotenantWorkload(self._cotenant_name, int(domain),
                                  float(rate_per_ms), attack_gen(blocks))
            host.add_cotenant(wl)
        else:
            wl.gen = attack_gen(blocks)
            host.retarget_cotenant(self._cotenant_name, domain=int(domain),
                                   rate_per_ms=float(rate_per_ms),
                                   enabled=True)
        self.active = True
        return wl

    def stop(self) -> None:
        """Silence the attack stream (the workload stays registered so a
        later `begin()` can resume it)."""
        if self.vm.host.cotenant(self._cotenant_name) is not None:
            self.vm.host.retarget_cotenant(self._cotenant_name,
                                           enabled=False)
        self.active = False

    # -- phase 3: the attacker's own measurements ------------------------------
    def observe(self, window_ms: float = 7.0) -> AttackObservation:
        """One windowed measurement over the targets.  The attacker's own
        stream is paused for the window so it measures the victim (and
        other co-tenants), not its own priming."""
        if not self.targets:
            raise RuntimeError("choose_targets() before observe()")
        was_active = self.active
        if was_active:
            self.stop()
        d0 = self.vm.stat_passes
        plan = self.window_plan(window_ms)
        frac = self._frac(plan.meta["order"],
                          probeplan.execute(self.vm, plan).last)
        self.attack_dispatches = (getattr(self, "attack_dispatches", 0)
                                  + self.vm.stat_passes - d0)
        if was_active:
            self.begin()
        obs = AttackObservation(
            target_indices=tuple(plan.meta["order"]),
            frac=tuple(float(f) for f in frac),
            window_ms=window_ms, time_ms=self.vm.host.time_ms)
        self.windows += 1
        self._mean_frac_sum += float(np.mean(frac)) if len(frac) else 0.0
        if any(obs.victim_active):
            self.hit_windows += 1
        return obs

    def run(self, windows: int, window_ms: float = 7.0,
            between: Optional[Callable[[], None]] = None) -> AttackReport:
        """Drive ``windows`` attack windows (``between`` interleaves the
        victim, as in `profile`) and summarize."""
        for _ in range(windows):
            obs = self.observe(window_ms)
            if between is not None:
                between()
        return self.report()

    def report(self) -> AttackReport:
        return AttackReport(
            platform=self.platform.name, variant=self.variant,
            windows=self.windows, n_targets=len(self.targets),
            hit_windows=self.hit_windows,
            mean_frac=self._mean_frac_sum / max(1, self.windows),
            attach_dispatches=self.attach_dispatches,
            attack_dispatches=getattr(self, "attack_dispatches", 0))


def attack_gen(blocks: np.ndarray):
    """Deterministic sweep over the target sets' lines: unlike the random
    polluter/zipf generators, a full in-order sweep guarantees every
    target cell is completely re-primed each period — the whole-set
    periodic eviction signature `CacheShield` keys on."""
    blocks = np.asarray(blocks, np.int64)

    def gen(rng: np.random.Generator, n: int) -> np.ndarray:
        reps = -(-n // len(blocks))
        return np.tile(blocks, reps)[:n]

    return gen
