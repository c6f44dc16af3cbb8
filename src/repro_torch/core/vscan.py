"""VSCAN — LLC associativity & set-contention probing (paper §3.3).

Monitors one representative LLC set per set-index *row* (addresses with the
same set index spread evenly over slices, so one set represents its row):

  * **parallel eviction set construction** (Fig 6): the candidate pool is
    split into color groups by the VCOL color filters, each group is
    partitioned by aligned page offset, and ``f`` minimal eviction sets are
    built per partition (``f = 4`` by default) so that both rows reachable
    from a partition (the uncontrollable HPA bit above the color bits) are
    covered with high probability.  Partitions are handed to
    constructor/helper vCPU pairs on disjoint rows (VTOP-placed).

  * theoretical coverage (Table 5): a partition reaches ``2`` rows spread
    over ``2n`` (row, slice) cells, ``n`` = number of slices.  With ``f``
    sets the chance that all land in a single row is
    ``Pf = 2*C(n,f)/C(2n,f)``, giving
    ``coverage = 100%*(1-Pf) + 50%*Pf``.
    (The paper's prose writes ``Pf = C(n,f)/C(2n,f)``; only the factor-2
    form reproduces its own Table 5 numbers — 75.64% @ f=2, 94.70% @ f=4 —
    so we implement that and flag the discrepancy in EXPERIMENTS.md.)

  * **windowed Prime+Probe** (vs windowless, which tracks access frequency
    rather than occupancy): prime all monitored sets with MLP batching, wait
    a window (default 7 ms, auto-shrinks on full eviction / resets when
    evictions vanish), probe *sequentially in reverse order* to measure
    per-line latency while avoiding self-evictions.

  * eviction-rate normalization (% of lines evicted per ms), EWMA smoothing,
    and per-LLC / per-color aggregation consumed by CAS and CAP.

Monitored sets carry a cache *level* ("llc" by default): L2-level sets —
built against a prober core's private L2, probed with the L2 miss
threshold — ride the same interval plans, windows and drift machinery,
but feed separate per-level/per-core aggregates (`per_level_rate`,
`l2_core_rate`, `l2_color_rate`) that sense idle private-L2 capacity for
CAP's harvest tier without perturbing the LLC contention signal.
"""

from __future__ import annotations

import dataclasses
from math import comb
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.color import ColorFilters, VCOL
from repro_torch.core.eviction import VEV, EvictionSet, build_many
from repro_torch.core.hierarchy import miss_threshold
from repro_torch.core.host_model import GuestVM
from repro_torch.core import probeplan
from repro_torch.core.probeplan import (Commit, Measure, PlanLowering, PlanResult,
                                        ProbePlan, Segment, Wait, WarmTimer)

DEFAULT_WINDOW_MS = 7.0
MIN_WINDOW_MS = 1.0
#: Zero-wait eviction fraction above which a monitored set is anomalous:
#: with no window, co-tenants emit no traffic, so ANY eviction of a just-
#: primed set means the set conflicts with the monitor's own priming —
#: which only happens when host drift broke congruence assumptions
#: (remapped members landing in another monitored cell, or a CAT
#: repartition shrinking the effective associativity so a set over-fills
#: its own cell).  0.2 catches a 2-way capacity loss (frac 0.25) while
#: staying far above the exact-zero idle baseline.
DRIFT_FRAC = 0.2
#: Consecutive anomalous intervals before a set becomes a drift suspect
#: (same debounce philosophy as CAS's 3-interval tier hysteresis).
DRIFT_INTERVALS = 3


@dataclasses.dataclass(frozen=True)
class DriftSignal:
    """An explicit drift event distilled from sustained probe anomalies.

    Emitted when monitored sets show eviction fractions ``>= drift_frac``
    for ``drift_intervals`` consecutive windows AND a zero-wait
    prime→probe confirms the anomaly is self-inflicted (contention-proof:
    co-tenants only run while the guest waits).  The flagged sets are
    quarantined — their garbage measurements stop feeding the EWMA and the
    per-domain/per-color aggregates — until a repair rebuilds them.
    """

    kind: str                 # "self_conflict" (capacity change / remap)
    set_indices: Tuple[int, ...]
    frac: Tuple[float, ...]   # confirming zero-wait eviction fractions
    time_ms: float
    intervals: int            # suspicion streak length that triggered it


def theoretical_coverage(n_slices: int, f: int) -> float:
    """Table 5 'Theo. Cov.' (%)."""
    if f > 2 * n_slices:
        f = 2 * n_slices
    pf = 2.0 * comb(n_slices, f) / comb(2 * n_slices, f) if f <= n_slices else 0.0
    return 100.0 * (1.0 - pf) + 50.0 * pf


@dataclasses.dataclass
class MonitoredSet:
    es: EvictionSet
    color: int          # virtual color (from the pool's color group)
    domain: int         # LLC domain whose vCPU probes it
    vcpu: int           # prober vCPU
    level: str = "llc"  # cache level probed: "llc" (shared) or "l2" (the
    #                     prober core's private L2 — harvest-tier capacity
    #                     sensing; excluded from the LLC aggregates)


@dataclasses.dataclass
class VScanSnapshot:
    eviction_frac: np.ndarray    # per monitored set, fraction of lines evicted
    rate: np.ndarray             # per set, % lines evicted per ms
    ewma_rate: np.ndarray
    window_ms: float
    time_ms: float


class VScan:
    """Periodic contention monitor over a list of monitored sets."""

    def __init__(self, vm: GuestVM, monitored: List[MonitoredSet],
                 window_ms: float = DEFAULT_WINDOW_MS,
                 ewma_alpha: float = 0.3, n_pairs: int = 1,
                 use_batch: bool = True, use_plans: bool = True,
                 lowering: Optional[PlanLowering] = None,
                 drift_frac: float = DRIFT_FRAC,
                 drift_intervals: int = DRIFT_INTERVALS):
        self.vm = vm
        self.monitored = monitored
        self.window_ms = window_ms
        self.default_window_ms = window_ms
        self.ewma_alpha = ewma_alpha
        self.n_pairs = max(1, n_pairs)
        # drift detection (module constants above): sustained anomalies
        # become suspects; `confirm_drift` turns suspects into a quarantine
        self.drift_frac = drift_frac
        self.drift_intervals = drift_intervals
        self._suspect = np.zeros(len(monitored), np.int64)
        self.flagged = np.zeros(len(monitored), bool)
        # subset of `flagged` quarantined for *interference* (an attack
        # episode), not structural damage: excluded from aggregates like
        # any quarantine, but NOT treated as broken by repair — the
        # un-quarantine path is `confirm_clean`, not a rebuild
        self.attack_flagged = np.zeros(len(monitored), bool)
        # intervals to wait before re-running a (failed) drift confirmation
        # — legitimate heavy contention keeps suspicion streaks alive, and
        # the cooldown bounds the zero-wait re-checks it can trigger
        self._confirm_cooldown = 0
        # use_batch probes every monitored set as one lane of a single fused
        # multi-set Prime+Probe dispatch (Table 6); False keeps the seed
        # one-dispatch-per-set probe loop for benchmarking.
        self.use_batch = use_batch
        # use_plans compiles each interval to a ProbePlan (fused multi-vCPU
        # prime Commit + Wait + timed probe Measure) executed by
        # `probeplan.execute` — the route `monitor_plan()`/`apply_monitor()`
        # expose so a fleet harness can co-execute many guests' intervals;
        # False keeps the pre-plan per-prober prime loop (parity reference).
        self.use_plans = use_plans
        self.lowering = lowering
        self.ewma = np.zeros(len(monitored))
        self.history: List[VScanSnapshot] = []

    # -- construction pipeline (Fig 6) ----------------------------------------
    @classmethod
    def build(cls, vm: GuestVM, cf: ColorFilters, vcol: VCOL,
              pool_pages: np.ndarray, ways: int, f: int,
              offsets: Sequence[int], domain_vcpus: Dict[int, List[int]],
              votes: int = 1, seed: int = 0,
              window_ms: float = DEFAULT_WINDOW_MS,
              ewma_alpha: float = 0.3,
              use_batch: bool = True,
              prime_reps: int = 1, use_plans: bool = True,
              lowering: Optional[PlanLowering] = None
              ) -> Tuple["VScan", Dict]:
        """Split pool into color groups, partition by offset, build f sets
        per partition per domain.  Returns (vscan, build_info)."""
        colors = vcol.identify_colors_parallel(cf, pool_pages)
        monitored: List[MonitoredSet] = []
        info = {"partitions": 0, "built": 0, "failed_partitions": 0}
        rng = np.random.default_rng(seed)
        jobs = []
        job_meta = []
        for domain, vcpus in domain_vcpus.items():
            for color in range(cf.n_colors):
                cpages = pool_pages[colors == color]
                if len(cpages) == 0:
                    continue
                for off in offsets:
                    info["partitions"] += 1
                    pool = np.array([vm.gva(int(p), int(off)) for p in cpages],
                                    np.int64)
                    rng.shuffle(pool)
                    jobs.append({"offset": int(off), "pool": pool,
                                 "max_sets": f, "vcpu": vcpus[0]})
                    job_meta.append((domain, vcpus[0], color))
        # all (domain, color, offset) partitions advance in lockstep sharing
        # fused dispatches (Fig 6 parallel construction)
        results, _, _ = build_many(vm, jobs, "llc", ways, votes=votes,
                                   seed=seed, use_batch=use_batch,
                                   prime_reps=prime_reps,
                                   use_plans=use_plans, lowering=lowering)
        for (domain, vcpu, color), sets in zip(job_meta, results):
            if not sets:
                info["failed_partitions"] += 1
            for es in sets:
                monitored.append(MonitoredSet(
                    es=es, color=color, domain=domain, vcpu=vcpu))
                info["built"] += 1
        return cls(vm, monitored, window_ms=window_ms,
                   ewma_alpha=ewma_alpha, use_batch=use_batch,
                   use_plans=use_plans, lowering=lowering), info

    # -- persistence (the `CacheXSession` export contract) ---------------------
    def state_dict(self) -> Dict:
        """JSON-serializable monitored-set list + window parameters.

        EWMA rates and history are deliberately *not* serialized: they are
        live measurements, stale by definition on a re-attached VM — the
        importer re-measures with the restored monitored sets."""
        return {
            "window_ms": float(self.window_ms),
            "default_window_ms": float(self.default_window_ms),
            "ewma_alpha": float(self.ewma_alpha),
            "monitored": [{"es": m.es.state_dict(), "color": int(m.color),
                           "domain": int(m.domain), "vcpu": int(m.vcpu),
                           "level": str(m.level)}
                          for m in self.monitored],
        }

    @classmethod
    def from_state(cls, vm: GuestVM, state: Dict,
                   use_batch: bool = True, use_plans: bool = True,
                   lowering: Optional[PlanLowering] = None) -> "VScan":
        monitored = [MonitoredSet(es=EvictionSet.from_state(m["es"]),
                                  color=int(m["color"]),
                                  domain=int(m["domain"]),
                                  vcpu=int(m["vcpu"]),
                                  level=str(m.get("level", "llc")))
                     for m in state["monitored"]]
        vs = cls(vm, monitored, window_ms=float(state["default_window_ms"]),
                 ewma_alpha=float(state["ewma_alpha"]), use_batch=use_batch,
                 use_plans=use_plans, lowering=lowering)
        vs.window_ms = float(state["window_ms"])
        return vs

    # -- associativity ---------------------------------------------------------
    def associativity(self) -> float:
        """Median minimal-eviction-set size across monitored sets (Table 3)."""
        return float(np.median([len(m.es) for m in self.monitored]))

    # -- one monitoring interval -----------------------------------------------
    def _by_prober(self) -> Dict[int, List[int]]:
        by_prober: Dict[int, List[int]] = {}
        for i, m in enumerate(self.monitored):
            by_prober.setdefault(m.vcpu, []).append(i)
        return by_prober

    def _prime(self, by_prober: Dict[int, List[int]]) -> None:
        """Each thread pair traverses its share with MLP batching."""
        for vcpu, idxs in by_prober.items():
            lines = np.concatenate([self.monitored[i].es.gvas for i in idxs])
            self.vm.access(lines, vcpu=vcpu)

    def _probe(self, by_prober: Dict[int, List[int]]) -> np.ndarray:
        """Per-set evicted-line fraction (reverse-order timed probe)."""
        frac = np.zeros(len(self.monitored))
        if self.use_batch and self.monitored:
            # one fused dispatch probes every monitored set (its own lane,
            # reverse order, issued from its prober's core)
            order = [i for idxs in by_prober.values() for i in idxs]
            lanes = [self.monitored[i].es.gvas[::-1] for i in order]
            vcpus = [self.monitored[i].vcpu for i in order]
            self.vm.warm_timer()
            lat_lanes = self.vm.timed_access_batch(lanes, vcpu=vcpus)
            for i, lats in zip(order, lat_lanes):
                thr = miss_threshold(self.monitored[i].level)
                frac[i] = float(np.mean(lats > thr))
        else:
            for vcpu, idxs in by_prober.items():
                for i in idxs:
                    gvas = self.monitored[i].es.gvas[::-1]  # reverse order
                    self.vm.warm_timer()
                    lats = self.vm.timed_access(gvas, vcpu=vcpu)
                    thr = miss_threshold(self.monitored[i].level)
                    frac[i] = float(np.mean(lats > thr))
        return frac

    # -- plan emission (the ProbePlan route) -----------------------------------
    def _interval_ops(self, by_prober: Dict[int, List[int]],
                      window_ms: Optional[float]
                      ) -> Tuple[Tuple, List[int]]:
        """Ops of one interval: fused multi-vCPU prime Commit, optional
        Wait, warm-up, reverse-order timed probe Measure.  Returns
        (ops, lane order → monitored index)."""
        order = [i for idxs in by_prober.values() for i in idxs]
        prime = Commit(segments=tuple(
            Segment(gvas=np.concatenate(
                [self.monitored[i].es.gvas for i in idxs]), vcpu=vcpu)
            for vcpu, idxs in by_prober.items()))
        levels = {self.monitored[i].level for i in order}
        probe = Measure(
            lanes=tuple(self.monitored[i].es.gvas[::-1] for i in order),
            vcpus=tuple(self.monitored[i].vcpu for i in order),
            level=levels.pop() if len(levels) == 1 else "mixed")
        ops: Tuple = (prime,)
        if window_ms is not None:
            ops += (Wait(ms=window_ms),)
        ops += (WarmTimer(), probe)
        return ops, order

    def monitor_plan(self) -> ProbePlan:
        """Compile one monitoring interval — prime every monitored set,
        wait the current window, probe each set reverse-order timed — to a
        ProbePlan.  Execute with `probeplan.execute` (or co-execute many
        guests' plans with `probeplan.execute_many`) and feed the result to
        :meth:`apply_monitor`."""
        ops, order = self._interval_ops(self._by_prober(), self.window_ms)
        return ProbePlan(ops=ops, label="vscan.monitor",
                         hints=self.lowering,
                         meta={"order": order, "window_ms": self.window_ms})

    def _frac_from_lanes(self, order: List[int],
                         lat_lanes: List[np.ndarray]) -> np.ndarray:
        frac = np.zeros(len(self.monitored))
        for i, lats in zip(order, lat_lanes):
            thr = miss_threshold(self.monitored[i].level)
            frac[i] = float(np.mean(lats > thr))
        return frac

    def apply_monitor(self, plan: ProbePlan,
                      result: PlanResult) -> VScanSnapshot:
        """Consume one executed monitor plan: per-set eviction fractions →
        rate normalization → EWMA → window auto-adjustment (§3.3)."""
        frac = self._frac_from_lanes(plan.meta["order"], result.last)
        return self._finish_interval(frac, plan.meta["window_ms"])

    def _finish_interval(self, frac: np.ndarray,
                         window_ms: float) -> VScanSnapshot:
        rate = 100.0 * frac / max(window_ms, 1e-9)          # % lines / ms
        # quarantined (flagged) sets stop feeding the EWMA: their probes
        # measure drift damage, not co-tenant contention — freezing them is
        # exactly the "explicit DriftSignal instead of folding garbage into
        # the EWMA" contract (they rejoin once a repair clears the flag)
        live = ~self.flagged
        self.ewma = np.where(
            live,
            (1 - self.ewma_alpha) * self.ewma + self.ewma_alpha * rate,
            self.ewma)
        # drift suspicion: an anomalously high fraction sustains a streak;
        # `drift_suspects`/`confirm_drift` turn streaks into a quarantine
        anomalous = live & (frac >= self.drift_frac)
        self._suspect = np.where(anomalous, self._suspect + 1, 0)
        self._suspect[~live] = 0
        self._confirm_cooldown = max(0, self._confirm_cooldown - 1)

        # window auto-adjustment (§3.3): shrink on full eviction across
        # (live) sets, reset to default when evictions are absent.
        lf = frac[live]
        if len(lf) and float(np.min(lf)) >= 1.0:
            self.window_ms = max(MIN_WINDOW_MS, self.window_ms - 1.0)
        elif len(lf) and float(np.max(lf)) == 0.0:
            self.window_ms = self.default_window_ms

        snap = VScanSnapshot(eviction_frac=frac, rate=rate,
                             ewma_rate=self.ewma.copy(),
                             window_ms=self.window_ms,
                             time_ms=self.vm.host.time_ms)
        self.history.append(snap)
        return snap

    def prune_self_conflicts(self, max_frac: float = 0.5) -> int:
        """Drop monitored sets that VSCAN's *own priming* evicts.

        Zero-wait prime -> probe: with no window for co-tenant traffic, any
        set showing evictions is being thrashed by another monitored set
        sharing its (set, slice) cell — which happens when the LLC exposes
        fewer set-index rows than there are virtual colors (e.g. a small
        CCX LLC: 128 sets = 2 rows for 4 colors), so two colors' minimal
        sets land congruent and 2x`ways` lines fight over `ways` ways.
        The later-primed set of each conflicting pair survives and keeps
        the shared cell covered.  Purely guest-side (no hypercall), run
        once after construction.  Returns the number of sets dropped."""
        if not self.monitored:
            return 0
        by_prober = self._by_prober()
        if self.use_batch and self.use_plans:
            ops, order = self._interval_ops(by_prober, window_ms=None)
            plan = ProbePlan(ops=ops, label="vscan.prune",
                             hints=self.lowering)
            frac = self._frac_from_lanes(
                order, probeplan.execute(self.vm, plan).last)
        else:
            self._prime(by_prober)
            frac = self._probe(by_prober)
        keep = frac <= max_frac
        dropped = int((~keep).sum())
        if dropped:
            self.monitored = [m for m, k in zip(self.monitored, keep) if k]
            self.ewma = self.ewma[keep]
            self._suspect = self._suspect[keep]
            self.flagged = self.flagged[keep]
            self.attack_flagged = self.attack_flagged[keep]
        return dropped

    # -- drift detection (suspects → zero-wait confirm → quarantine) -----------
    def _zero_wait_frac(self, label: str) -> np.ndarray:
        """Zero-wait prime→probe over every monitored set (2 dispatches).

        The contention-proof arbiter shared by `confirm_drift` and
        `confirm_clean`: host time only advances inside Wait ops, so
        co-tenants — including an adversarial Prime+Probe guest — emit
        nothing between the prime Commit and the timed Measure.  Any
        eviction it sees is self-inflicted, i.e. structural."""
        by_prober = self._by_prober()
        if self.use_batch and self.use_plans:
            ops, order = self._interval_ops(by_prober, window_ms=None)
            plan = ProbePlan(ops=ops, label=label, hints=self.lowering)
            return self._frac_from_lanes(
                order, probeplan.execute(self.vm, plan).last)
        self._prime(by_prober)
        return self._probe(by_prober)

    def drift_suspects(self) -> np.ndarray:
        """Indices of live monitored sets whose anomaly streak reached
        ``drift_intervals`` (candidates for :meth:`confirm_drift`)."""
        if self._confirm_cooldown > 0:
            return np.empty(0, np.int64)
        return np.flatnonzero((self._suspect >= self.drift_intervals)
                              & ~self.flagged)

    def confirm_drift(self) -> Optional[DriftSignal]:
        """Zero-wait prime→probe over the monitored sets, the
        contention-proof arbiter behind the suspicion streaks: with no
        window, co-tenants emit nothing, so evictions can only be
        self-inflicted — host drift (remap collisions, CAT capacity loss),
        not load.  Confirmed sets are flagged (quarantined from the EWMA
        and aggregates) and an explicit :class:`DriftSignal` is returned;
        an unconfirmed suspicion resets the streaks and backs off.  Costs
        2 dispatches; callers gate it on :meth:`drift_suspects`."""
        suspects = np.flatnonzero((self._suspect >= self.drift_intervals)
                                  & ~self.flagged)
        if not len(suspects):
            return None
        frac = self._zero_wait_frac("vscan.confirm")
        confirmed = np.flatnonzero((frac >= self.drift_frac)
                                   & ~self.flagged)
        # opportunistic un-quarantine: the same zero-wait probe measured
        # every flagged set for free — any that came back clean is
        # structurally intact (quarantined for interference, e.g. an
        # attack episode, not for damage) and rejoins the live population
        self._unflag_clean(frac)
        self._suspect[:] = 0
        if not len(confirmed):
            self._confirm_cooldown = 4 * self.drift_intervals
            return None
        self.flagged[confirmed] = True
        return DriftSignal(kind="self_conflict",
                           set_indices=tuple(int(i) for i in confirmed),
                           frac=tuple(float(frac[i]) for i in confirmed),
                           time_ms=self.vm.host.time_ms,
                           intervals=self.drift_intervals)

    def flag_sets(self, indices: Sequence[int], attack: bool = False) -> None:
        """Quarantine monitored sets found broken by an external check
        (e.g. `VEV.validate_sets` during `CacheXSession.repair`) or — with
        ``attack=True`` — poisoned by one (`CacheShield` attack onset).
        Attack quarantine excludes the sets from aggregates the same way,
        but marks them intact: repair skips them (nothing to rebuild) and
        `confirm_clean` lifts the flag once the attacker goes quiet."""
        for i in indices:
            self.flagged[int(i)] = True
            if attack:
                self.attack_flagged[int(i)] = True

    def _unflag_clean(self, frac: np.ndarray) -> Tuple[int, ...]:
        """Un-quarantine flagged sets whose zero-wait eviction fraction is
        below ``drift_frac``: structurally intact, safe to re-live."""
        clean = np.flatnonzero(self.flagged & (frac < self.drift_frac))
        for i in clean:
            self.flagged[i] = False
            self.attack_flagged[i] = False
            self._suspect[i] = 0
            self.ewma[i] = 0.0   # quarantine-era rate described interference
        return tuple(int(i) for i in clean)

    def confirm_clean(self) -> Tuple[int, ...]:
        """Zero-wait re-check of quarantined sets; un-flags the intact ones.

        Historically `flagged` was one-way outside of repair: only
        `replace_set` (a rebuild) cleared it.  That is right for
        drift-confirmed sets — they really are broken — but wrong for
        sets quarantined because of *interference*: a set flagged during
        a sustained attack episode is structurally fine, and without this
        check it stayed quarantined forever after the attacker stopped,
        permanently shrinking the live monitor population (and, next
        repair, getting pointlessly rebuilt).  Costs 2 dispatches; a
        still-broken set (e.g. CAT capacity loss) still self-conflicts
        zero-wait and stays flagged.  Returns the un-flagged indices."""
        if not self.flagged.any() or not self.monitored:
            return ()
        frac = self._zero_wait_frac("vscan.clean")
        return self._unflag_clean(frac)

    def replace_set(self, index: int, es) -> None:
        """Swap in a repaired eviction set and bring the slot back live:
        flag cleared, EWMA and suspicion reset (a repaired set re-measures
        from scratch — its old rate history described different lines)."""
        self.monitored[index].es = es
        self.flagged[index] = False
        self.attack_flagged[index] = False
        self._suspect[index] = 0
        self.ewma[index] = 0.0

    def monitor_once(self) -> VScanSnapshot:
        """Prime -> wait(window) -> probe (reverse order, timed).  One
        ProbePlan execution on the default route (2 dispatches: fused
        multi-vCPU prime + fused probe); the pre-plan per-prober prime
        loop survives behind ``use_plans=False`` as the parity reference,
        and ``use_batch=False`` keeps the seed one-dispatch-per-set
        probe."""
        if self.use_batch and self.use_plans:
            plan = self.monitor_plan()
            return self.apply_monitor(plan, probeplan.execute(self.vm, plan))
        by_prober = self._by_prober()
        self._prime(by_prober)
        self.vm.wait_ms(self.window_ms)
        frac = self._probe(by_prober)
        return self._finish_interval(frac, self.window_ms)

    # -- aggregation (consumed by CAS / CAP) -------------------------------------
    # Quarantined (flagged) sets are excluded: their EWMA is frozen drift
    # garbage.  A (domain, color) whose every set is quarantined simply
    # drops out of the dict until repaired — consumers already tolerate
    # missing keys (CAP orders unmeasured colors last).  The classic
    # per-domain/per-color aggregates describe *LLC* contention only:
    # L2-level monitored sets feed the per-level/per-core views below
    # (the harvest tier's capacity sensors), never the CAS/CAP LLC rates.
    def per_domain_rate(self) -> Dict[int, float]:
        out: Dict[int, List[float]] = {}
        for i, m in enumerate(self.monitored):
            if self.flagged[i] or m.level != "llc":
                continue
            out.setdefault(m.domain, []).append(self.ewma[i])
        return {d: float(np.mean(v)) for d, v in out.items()}

    def per_color_rate(self, domain: Optional[int] = None) -> Dict[int, float]:
        out: Dict[int, List[float]] = {}
        for i, m in enumerate(self.monitored):
            if self.flagged[i] or m.level != "llc":
                continue
            if domain is not None and m.domain != domain:
                continue
            out.setdefault(m.color, []).append(self.ewma[i])
        return {c: float(np.mean(v)) for c, v in out.items()}

    def per_level_rate(self) -> Dict[str, float]:
        """Mean live EWMA rate per monitored cache level — the signal
        `check_drift`/`repair` use to rebuild only the level that broke,
        and `ContentionView.per_level` publishes."""
        out: Dict[str, List[float]] = {}
        for i, m in enumerate(self.monitored):
            if self.flagged[i]:
                continue
            out.setdefault(m.level, []).append(self.ewma[i])
        return {lv: float(np.mean(v)) for lv, v in out.items()}

    def l2_core_rate(self) -> Dict[int, float]:
        """Per-core private-L2 eviction rate (live L2-level sets grouped by
        the prober's core) — the harvest tier's quiet-L2 sensor."""
        out: Dict[int, List[float]] = {}
        for i, m in enumerate(self.monitored):
            if self.flagged[i] or m.level != "l2":
                continue
            core = int(self.vm.vcpu_cores[m.vcpu])
            out.setdefault(core, []).append(self.ewma[i])
        return {c: float(np.mean(v)) for c, v in out.items()}

    def l2_color_rate(self, core: Optional[int] = None) -> Dict[int, float]:
        """Per-L2-color eviction rate over live L2-level sets (optionally
        one core's) — ranks which L2 page colors are co-tenant-quiet."""
        out: Dict[int, List[float]] = {}
        for i, m in enumerate(self.monitored):
            if self.flagged[i] or m.level != "l2":
                continue
            if (core is not None
                    and int(self.vm.vcpu_cores[m.vcpu]) != core):
                continue
            out.setdefault(m.color, []).append(self.ewma[i])
        return {c: float(np.mean(v)) for c, v in out.items()}

    def add_sets(self, new: Sequence[MonitoredSet]) -> None:
        """Append monitored sets (e.g. the L2-level sensors built after the
        LLC population), growing every parallel per-set array — new slots
        start live with zero EWMA/suspicion, exactly like freshly built
        sets at construction."""
        if not new:
            return
        n = len(new)
        self.monitored.extend(new)
        self.ewma = np.concatenate([self.ewma, np.zeros(n)])
        self._suspect = np.concatenate([self._suspect,
                                        np.zeros(n, np.int64)])
        self.flagged = np.concatenate([self.flagged, np.zeros(n, bool)])
        self.attack_flagged = np.concatenate([self.attack_flagged,
                                              np.zeros(n, bool)])

    # -- validation (hypercall ground truth) ---------------------------------------
    def measured_row_coverage(self, vm: GuestVM, n_rows: int) -> float:
        """Fraction of set-index rows covered by >=1 monitored set (Table 5
        'Exp. Cov.'), via the GPA->HPA hypercall."""
        rows = set()
        for m in self.monitored:
            s, _ = vm.hypercall_llc_setslice(int(m.es.gvas[0]))
            rows.add(s)
        return len(rows) / n_rows
