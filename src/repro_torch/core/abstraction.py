"""CacheXSession — the probed cache abstraction as a first-class query API.

The paper's core artifact is not any single probe but the *abstraction* a
guest ends up holding — provisioned topology, virtual colors, and live
per-domain / per-color contention — which in-kernel CacheX exposes as a
subsystem API that the scheduler (CAS) and the page cache (CAP) consume.
This module is that API for the reproduction: one :class:`CacheXSession`
owns the VEV → VCOL → VSCAN probing lifecycle against a
:class:`~repro_torch.core.platforms.CachePlatform` and serves stable queries, so
policies, drivers, benchmarks and examples never hand-wire probe
constructors or thread ``votes``/``prime_reps``/``use_batch`` parameters
again (the Com-CAS / CacheShield design point: a cache-state interface
between probing and policy).

Surface:

  * :meth:`CacheXSession.attach` — bind a session to a booted
    :class:`~repro_torch.core.host_model.GuestVM`; the pipeline runs lazily, one
    stage per first query (or eagerly with ``eager=True``).
  * :meth:`~CacheXSession.topology` — LLC domains, guest-effective
    associativity, probed (detected) associativity, built eviction sets.
  * :meth:`~CacheXSession.colors` — a :class:`ColorsView`: color filters,
    per-page virtual-color lookup (cached), colored free lists.
  * :meth:`~CacheXSession.contention` — latest :class:`ContentionView`
    (per-domain / per-color EWMA rates) with staleness metadata; re-probes
    when older than ``ProbeConfig.refresh_interval_ms`` (or an explicit
    ``max_age_ms``).  :meth:`~CacheXSession.refresh` forces one monitoring
    interval and publishes the view to :meth:`~CacheXSession.subscribe`
    hooks — how CAS's ``TierTracker`` and CAP's ``CapAllocator`` consume
    measurements instead of polling ``VScan`` directly.
  * :meth:`~CacheXSession.export` / :meth:`~CacheXSession.import_` — the
    probed abstraction serializes to JSON and re-attaches to a fresh
    (rebooted) VM without re-running VEV/VCOL/VSCAN construction: the
    paper's "persists across reboot" story (GPA→HPA backing survives a
    guest reboot, so guest-page colors and eviction sets stay valid).
  * :meth:`~CacheXSession.validate` — hypercall ground-truth checks
    (§6.2); like every ``hypercall_*`` consumer, for tests / benchmarks /
    report-building only, never for decisions.

:class:`ProbeConfig` replaces the parameter threading: platform defaults
via :meth:`ProbeConfig.for_platform`, per-call overrides via
:meth:`ProbeConfig.replace`.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.core.cachesim import PAGE_BITS
from repro_torch.core.color import VCOL, ColorFilters, color_accuracy
from repro_torch.core.eviction import C_POOL_SCALE, VEV, EvictionSet, build_many
from repro_torch.core.host_model import GuestVM
from repro_torch.core.platforms import CachePlatform, get_platform
from repro_torch.core import probeplan
from repro_torch.core.probeplan import PlanLowering, PlanResult, ProbePlan
from repro_torch.core.shield import AttackSignal, CacheShield
from repro_torch.core.vscan import (DEFAULT_WINDOW_MS, DriftSignal, VScan,
                                    VScanSnapshot)

#: Current export format.  v2 adds the drift-epoch stamps
#: (``host_epoch`` / ``abstraction_epoch`` / ``effective_ways``) and
#: per-set spares; v1 exports (pre-drift) still import, with no staleness
#: check possible (docs/MIGRATION.md).
EXPORT_FORMAT = "cachex-abstraction/v2"
_ACCEPTED_FORMATS = ("cachex-abstraction/v1", EXPORT_FORMAT)


class StaleAbstractionError(ValueError):
    """Raised by :meth:`CacheXSession.import_` when the snapshot was
    exported under a different host provisioning epoch than the VM now
    runs on — live migration, CAT repartitioning, or page remapping
    happened in between, so the snapshot's colors/sets describe a host
    that no longer exists.  Import with ``allow_stale=True`` and call
    :meth:`CacheXSession.repair` to salvage what survived."""

#: Upper bound on the VSCAN probing-pool allocation (guest pages).
#:
#: Sizing rationale: a pool of ``Ps = W * rows * slices * C`` pages
#: (§3.1's candidate-pool formula with C = 3 over-provisioning) guarantees
#: enough congruent lines per (row, slice) cell to build ``f`` monitored
#: sets per partition with high probability.  384 pages is exactly Ps for
#: the largest registered geometry (skylake_sp at our scale: 8 ways x 8
#: rows x 2 slices x 3), i.e. the cap is inactive on every shipped
#: platform and only binds if a future geometry would demand more — where
#: extra candidates no longer improve coverage (only ``f`` sets per
#: partition are kept) but do inflate group-testing cost quadratically and
#: eat guest memory (384 pages ≈ 4.7% of the default 8192-page guest).
VSCAN_POOL_CAP_PAGES = 384


@dataclasses.dataclass(frozen=True)
class ProbeConfig:
    """Every knob of the probing pipeline in one place.

    Platform defaults come from :meth:`for_platform`; per-call overrides
    via :meth:`replace`.  Field reference:

    ``votes``            majority votes per eviction test (non-LRU /
                         noisy scenarios; ``CachePlatform.votes``).
    ``prime_reps``       prime repetitions per test (same rationale).
    ``use_batch``        route probes through the fused multi-set engine
                         (False keeps the seed per-test path for benches).
    ``use_plans``        emit every batched probe as a ProbePlan program
                         run by the one executor (`repro_torch.core.probeplan`);
                         False keeps the pre-plan per-stage dispatch
                         drivers as the parity/benchmark reference.
    ``lowering``         ProbePlan lowering hints (padding buckets, commit
                         fusion, lockstep eligibility); platform-derived
                         via :meth:`CachePlatform.plan_lowering` in
                         :meth:`for_platform`.
    ``f``                monitored sets built per (domain, color, offset)
                         VSCAN partition (paper Table 5 coverage knob).
    ``offsets``          aligned page offsets VSCAN partitions by.
    ``vev_target_sets``  minimal LLC eviction sets the topology stage
                         builds; None → ``min(4, rows * slices)``.
    ``vscan_pool_pages`` probing-pool size for VSCAN construction; None →
                         ``min(W * rows * slices * C, vscan_pool_cap)``
                         (§3.1 Ps sizing, see :data:`VSCAN_POOL_CAP_PAGES`).
    ``vscan_pool_cap``   the cap applied to the derived pool size.
    ``prune_self_conflicts``  drop monitored sets thrashed by VSCAN's own
                         priming after construction (few-row geometries).
    ``l2_monitor_cores`` cores whose private L2 gets per-color monitored
                         sets (level="l2") appended to the VSCAN
                         population — the harvest tier's capacity
                         sensors.  Empty (the default) keeps monitoring
                         LLC-only and bit-identical to pre-hierarchy
                         sessions.
    ``window_ms``        Prime+Probe wait window (auto-adjusted live).
    ``ewma_alpha``       EWMA smoothing of eviction rates.
    ``refresh_interval_ms``  staleness bound for
                         :meth:`CacheXSession.contention`: a view older
                         than this (simulated ms) triggers a re-probe.
    ``seed``             scenario seed threaded through every stage.
    """

    votes: int = 1
    prime_reps: int = 1
    use_batch: bool = True
    use_plans: bool = True
    lowering: Optional[PlanLowering] = None
    f: int = 2
    offsets: Tuple[int, ...] = (0,)
    vev_target_sets: Optional[int] = None
    vscan_pool_pages: Optional[int] = None
    vscan_pool_cap: int = VSCAN_POOL_CAP_PAGES
    prune_self_conflicts: bool = False
    l2_monitor_cores: Tuple[int, ...] = ()
    window_ms: float = DEFAULT_WINDOW_MS
    ewma_alpha: float = 0.3
    refresh_interval_ms: float = 50.0
    seed: int = 0

    @classmethod
    def for_platform(cls, plat: Union[str, CachePlatform],
                     **overrides) -> "ProbeConfig":
        """Platform defaults (votes/prime_reps/pool sizing), overridable."""
        plat = get_platform(plat) if isinstance(plat, str) else plat
        kw = dict(votes=plat.votes, prime_reps=plat.prime_reps,
                  lowering=plat.plan_lowering())
        kw.update(overrides)
        cfg = cls(**kw)
        if cfg.vscan_pool_pages is None:
            cfg = cfg.replace(vscan_pool_pages=cfg.derive_vscan_pool(plat))
        return cfg

    def replace(self, **overrides) -> "ProbeConfig":
        return dataclasses.replace(self, **overrides)

    # -- derived sizes -------------------------------------------------------
    def derive_vscan_pool(self, plat: CachePlatform) -> int:
        """§3.1 Ps pool sizing, capped (see :data:`VSCAN_POOL_CAP_PAGES`)."""
        ps = (plat.effective_ways * plat.n_llc_rows_per_offset
              * plat.llc.n_slices * C_POOL_SCALE)
        return min(ps, self.vscan_pool_cap)

    def resolve_vev_targets(self, plat: CachePlatform) -> int:
        if self.vev_target_sets is not None:
            return self.vev_target_sets
        return min(4, plat.n_llc_rows_per_offset * plat.llc.n_slices)


# ---------------------------------------------------------------------------
# query views
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TopologyView:
    """What the session knows about the provisioned cache topology.

    ``effective_ways`` is the guest-effective LLC associativity the
    pipeline built against; ``detected_associativity`` is what the probe
    actually measured (equal on success — under CAT it is the *allocation*,
    paper Table 3).  ``vev_built_sets`` of ``vev_target_sets`` minimal LLC
    eviction sets were constructed (hypercall verification of those sets
    is report-building, not a session query — see
    :meth:`CacheXSession.validate`).
    """

    n_domains: int
    cores_per_domain: int
    domain_vcpus: Dict[int, List[int]]
    effective_ways: int
    detected_associativity: Optional[int]
    vev_target_sets: int
    vev_built_sets: int
    #: abstraction epoch the view was served under (bumps on every
    #: :meth:`CacheXSession.repair`); holders can tell a pre-drift view
    #: from a post-repair one without re-querying
    epoch: int = 0


class ColorsView:
    """Virtual-color queries bound to a session (paper §3.2).

    ``color_of``/``colors_of`` identify pages via the session's color
    filters (answers are cached per page — a page's virtual color is
    stable while its GPA→HPA backing is); ``build_free_lists`` produces
    the colored free-page lists CAP allocates from.
    """

    def __init__(self, session: "CacheXSession"):
        self._s = session

    @property
    def n_colors(self) -> int:
        return self._s._cf.n_colors

    @property
    def offsets(self) -> np.ndarray:
        return self._s._cf.offsets

    @property
    def filters(self) -> ColorFilters:
        return self._s._cf

    def color_of(self, page: int) -> int:
        return int(self.colors_of([page])[0])

    def colors_of(self, pages: Sequence[int]) -> np.ndarray:
        return self._s._colors_of(pages)

    def build_free_lists(self, pages: Sequence[int]) -> Dict[int, List[int]]:
        return self._s._build_free_lists(pages)

    def known_pages(self) -> Dict[int, int]:
        """Snapshot of the cached page → virtual-color map."""
        return dict(self._s._page_colors)


@dataclasses.dataclass(frozen=True)
class ContentionView:
    """One monitoring interval's published contention measurements.

    ``per_domain``/``per_color`` are EWMA eviction rates (%-lines/ms, the
    VSCAN scale) over *LLC-level* monitored sets; ``mean_rate`` is this
    interval's *instantaneous* mean rate across monitored sets (what
    `run_cachex` reports as idle/hot).  ``per_level`` breaks the EWMA out
    by monitored cache level ("llc", and "l2" when
    ``ProbeConfig.l2_monitor_cores`` sensors exist) — the signal repair
    uses to rebuild only the level that broke; ``l2_cores`` is the
    per-core private-L2 rate the CAP harvest tier ranks quiet cores by
    (both empty on LLC-only sessions).  ``measured_at_ms`` (simulated
    clock) + :meth:`age_ms` are the staleness metadata; ``interval``
    counts refreshes since attach.
    """

    per_domain: Dict[int, float]
    per_color: Dict[int, float]
    mean_rate: float
    window_ms: float
    measured_at_ms: float
    interval: int
    #: abstraction epoch the view was measured under (bumps per repair)
    epoch: int = 0
    #: mean EWMA rate per monitored cache level ("llc" / "l2")
    per_level: Dict[str, float] = dataclasses.field(default_factory=dict)
    #: per-core private-L2 eviction rate (harvest-tier capacity sensing)
    l2_cores: Dict[int, float] = dataclasses.field(default_factory=dict)

    def age_ms(self, now_ms: float) -> float:
        return now_ms - self.measured_at_ms


@dataclasses.dataclass(frozen=True)
class RepairReport:
    """What one :meth:`CacheXSession.repair` pass found and fixed.

    ``*_checked`` counts structures validated (filters / cached page
    colors / LLC topology sets / monitored sets); ``*_repaired`` counts
    incremental fixes (survivor-pool rebuilds, single-page recolors);
    ``*_rebuilt`` counts structures that had drifted beyond incremental
    recovery and were re-probed from a fresh pool (e.g. after a live
    migration every filter rebuilds).  ``dispatches`` is the total probe
    dispatches the whole pass cost — the drift benchmarks compare it
    against a from-scratch re-attach (≥5x cheaper at ≤25% remap).
    """

    epoch: int                  # abstraction epoch after the pass
    effective_ways: int         # associativity the session now believes
    ways_changed: bool          # a CAT repartition was detected
    filters_checked: int = 0
    filters_repaired: int = 0
    filters_rebuilt: int = 0
    pages_checked: int = 0
    pages_recolored: int = 0
    llc_checked: int = 0
    llc_repaired: int = 0
    llc_rebuilt: int = 0
    vscan_checked: int = 0
    vscan_repaired: int = 0
    vscan_rebuilt: int = 0
    dispatches: int = 0

    @property
    def anything_broken(self) -> bool:
        return bool(self.filters_repaired or self.filters_rebuilt
                    or self.pages_recolored or self.llc_repaired
                    or self.llc_rebuilt or self.vscan_repaired
                    or self.vscan_rebuilt or self.ways_changed)


# ---------------------------------------------------------------------------
# stage builders (shared by the session and the deprecated runner shims)
# ---------------------------------------------------------------------------

def _build_colors(vm: GuestVM, plat: CachePlatform,
                  cfg: ProbeConfig) -> Tuple[VCOL, ColorFilters]:
    """VCOL stage: build the platform's L2 color filters."""
    vcol = VCOL(vm, vev=VEV(vm, votes=cfg.votes, prime_reps=cfg.prime_reps,
                            use_batch=cfg.use_batch,
                            use_plans=cfg.use_plans, lowering=cfg.lowering))
    cf = vcol.build_color_filters(n_colors=plat.n_l2_colors,
                                  ways=plat.l2.n_ways, seed=cfg.seed)
    return vcol, cf


def _default_domain_vcpus(plat: CachePlatform) -> Dict[int, List[int]]:
    """One constructor vCPU per LLC domain (VTOP-placed)."""
    return {d: [d * plat.cores_per_domain] for d in range(plat.n_domains)}


def _build_vscan(vm: GuestVM, plat: CachePlatform, vcol: VCOL,
                 cf: ColorFilters, cfg: ProbeConfig,
                 domain_vcpus: Optional[Dict[int, List[int]]] = None,
                 pool_pages: Optional[np.ndarray] = None,
                 ways: Optional[int] = None
                 ) -> Tuple[VScan, Dict, Dict[int, List[int]]]:
    """VSCAN stage: allocate the probing pool (ProbeConfig-sized) and build
    the monitored-set list, one constructor vCPU per LLC domain.  ``ways``
    overrides the platform's effective associativity (drift repair rebuilds
    at the session's *currently detected* capacity)."""
    if domain_vcpus is None:
        domain_vcpus = _default_domain_vcpus(plat)
    if pool_pages is None:
        n_pool = cfg.vscan_pool_pages
        if n_pool is None:
            n_pool = cfg.derive_vscan_pool(plat)
        pool_pages = vm.alloc_pages(n_pool)
    info_pool = np.asarray(pool_pages, np.int64)
    vs, info = VScan.build(vm, cf, vcol, pool_pages,
                           ways=(ways if ways is not None
                                 else plat.effective_ways), f=cfg.f,
                           offsets=list(cfg.offsets),
                           domain_vcpus=domain_vcpus, votes=cfg.votes,
                           prime_reps=cfg.prime_reps, seed=cfg.seed,
                           window_ms=cfg.window_ms,
                           ewma_alpha=cfg.ewma_alpha,
                           use_batch=cfg.use_batch,
                           use_plans=cfg.use_plans, lowering=cfg.lowering)
    if cfg.prune_self_conflicts:
        info["pruned_self_conflicts"] = vs.prune_self_conflicts()
    info["pool_pages"] = info_pool      # for drift-rebuild page recycling
    return vs, info, domain_vcpus


# ---------------------------------------------------------------------------
# the session
# ---------------------------------------------------------------------------

class CacheXSession:
    """Facade over the probing lifecycle of one VM on one platform.

    Construct via :meth:`attach` (probe) or :meth:`import_` (restore a
    previously exported abstraction).  Stages run at most once, lazily:

      * :meth:`colors` → VCOL color filters,
      * :meth:`topology` → VEV minimal LLC sets + associativity probe,
      * :meth:`contention` / :meth:`refresh` / :meth:`monitored_sets` →
        VSCAN monitored-set construction (which itself needs colors).
    """

    def __init__(self, vm: GuestVM, platform: Union[str, CachePlatform],
                 config: Optional[ProbeConfig] = None):
        self.vm = vm
        self.platform = (get_platform(platform) if isinstance(platform, str)
                         else platform)
        self.config = config or ProbeConfig.for_platform(self.platform)
        # VCOL
        self._vcol: Optional[VCOL] = None
        self._cf: Optional[ColorFilters] = None
        self._page_colors: Dict[int, int] = {}
        self._free_lists: Dict[int, List[int]] = {}
        # VEV / topology
        self._topo_ready = False
        self._llc_sets: List[EvictionSet] = []
        self._detected: Optional[int] = None
        self._domain_vcpus: Optional[Dict[int, List[int]]] = None
        # VSCAN / contention
        self._vs: Optional[VScan] = None
        self.vscan_info: Dict = {}
        self._last: Optional[ContentionView] = None
        self._intervals = 0
        self._subs: Dict[int, Callable[[ContentionView], None]] = {}
        self._drift_subs: Dict[int, Callable[[DriftSignal], None]] = {}
        self._attack_subs: Dict[int, Callable[[AttackSignal], None]] = {}
        # attack detection is opt-in: the CacheShield is created on first
        # `subscribe_attack` and never consulted with zero subscribers, so
        # benign deployments keep bit-identical monitoring behavior
        self._shield: Optional[CacheShield] = None
        self._next_sub = 0
        # -- drift state ----------------------------------------------------
        # abstraction epoch: bumps on every repair(); stamped on views
        self.epoch = 0
        # host provisioning epoch observed when a stage last (re)probed —
        # VALIDATION METADATA ONLY (export stamps + validate() staleness);
        # guest-side repair decisions come from probing, never from this
        self._probed_host_epoch: Optional[int] = None
        # the LLC associativity the session currently believes (None until
        # topology probes; updated when repair detects a CAT repartition)
        self._effective_ways: Optional[int] = None
        # True once a DriftSignal arrived: the next repair() re-detects
        # associativity (the signal may have been a capacity change)
        self._capacity_suspect = False
        # guest pages backing stage pools (freed if a rebuild replaces them)
        self._topo_pool_pages = np.empty(0, np.int64)

    # -- lifecycle -----------------------------------------------------------
    @classmethod
    def attach(cls, vm: GuestVM, platform: Union[str, CachePlatform],
               config: Optional[ProbeConfig] = None,
               eager: bool = False, backend: str = "llc"):
        """Bind a session to a booted VM.  ``eager=True`` runs the whole
        VEV→VCOL→VSCAN pipeline now; the default probes lazily on first
        query (each stage still runs at most once).

        ``backend`` selects the probing target kind
        (`repro_torch.core.backend`): the default ``"llc"`` is this classic
        GuestVM path, untouched — the dispatch below never runs for it.
        Any other name resolves through the backend registry, which
        returns a session serving the same query surface."""
        if backend != "llc":
            from repro_torch.core.backend import get_backend
            return get_backend(backend).attach(vm, platform, config=config,
                                               eager=eager)
        session = cls(vm, platform, config)
        if eager:
            session.colors()
            session.topology()
            session.monitored_sets()
        return session

    # -- stage ensures -------------------------------------------------------
    def _note_probed_epoch(self, revalidated: bool = False) -> None:
        """Record the host epoch a stage was probed under — validation
        metadata only (export stamps, `validate()` staleness reporting):
        it never drives a guest-side decision.

        The recorded value is the *earliest* epoch any built stage was
        probed under: a stage built after a drift event must not mask the
        staleness of stages built before it (colors probed at epoch 0 stay
        epoch-0 data even if VSCAN builds at epoch 1).  Only a full
        :meth:`repair` pass — which re-validates every stage —
        advances it unconditionally (``revalidated=True``)."""
        now = self.vm.hypercall_host_epoch()
        if revalidated or self._probed_host_epoch is None:
            self._probed_host_epoch = now
        else:
            self._probed_host_epoch = min(self._probed_host_epoch, now)

    def _vev(self) -> VEV:
        cfg = self.config
        return VEV(self.vm, votes=cfg.votes, prime_reps=cfg.prime_reps,
                   use_batch=cfg.use_batch, use_plans=cfg.use_plans,
                   lowering=cfg.lowering)

    def effective_ways(self) -> int:
        """The LLC associativity the session currently believes — the
        platform's provisioning until topology probes; re-detected by
        :meth:`repair` after a CAT repartition event."""
        return (self._effective_ways if self._effective_ways is not None
                else self.platform.effective_ways)

    def _ensure_colors(self) -> None:
        if self._cf is None:
            self._vcol, self._cf = _build_colors(self.vm, self.platform,
                                                 self.config)
            self._note_probed_epoch()

    def _ensure_topology(self) -> None:
        if self._topo_ready:
            return
        plat, cfg, vm = self.platform, self.config, self.vm
        vev = self._vev()
        ways = self.effective_ways()
        target = cfg.resolve_vev_targets(plat)
        pool = vev.make_pool(0, ways=ways,
                             n_uncontrollable_rows=plat.n_llc_rows_per_offset,
                             n_slices=plat.llc.n_slices)
        results, _, _ = build_many(
            vm, [{"offset": 0, "pool": pool, "max_sets": target}],
            "llc", ways, votes=cfg.votes, seed=cfg.seed,
            use_batch=cfg.use_batch, prime_reps=cfg.prime_reps,
            use_plans=cfg.use_plans, lowering=cfg.lowering)
        self._llc_sets = results[0]
        assoc_pool = vev.make_pool(
            64, ways=ways, n_uncontrollable_rows=plat.n_llc_rows_per_offset,
            n_slices=plat.llc.n_slices)
        self._detected = vev.probe_associativity(assoc_pool, "llc",
                                                 seed=cfg.seed)
        self._topo_pool_pages = np.concatenate(
            [pool, assoc_pool]) >> PAGE_BITS     # drift-rebuild recycling
        if self._effective_ways is None:
            self._effective_ways = ways
        self._topo_ready = True
        self._note_probed_epoch()

    def _ensure_vscan(self) -> None:
        if self._vs is not None:
            return
        self._ensure_colors()
        self._vs, self.vscan_info, self._domain_vcpus = _build_vscan(
            self.vm, self.platform, self._vcol, self._cf, self.config,
            domain_vcpus=self._domain_vcpus, ways=self.effective_ways())
        self._add_l2_monitors()
        self._note_probed_epoch()

    def _add_l2_monitors(self) -> None:
        """Append per-core private-L2 monitored sets (level="l2") for
        ``ProbeConfig.l2_monitor_cores``.

        No extra probing: the VCOL color filters already *are* verified L2
        eviction sets (one per virtual color), and L2 congruence is an HPA
        property — the same lines index the same set of any core's L2, so
        a filter clone primed and probed from a vCPU on the target core
        measures that core's private L2.  Clones (not the filter objects)
        join the population so a monitored-slot repair never mutates the
        color filters."""
        from repro_torch.core.vscan import MonitoredSet
        cores = self.config.l2_monitor_cores
        if not cores or self._vs is None:
            return
        core_vcpu: Dict[int, int] = {}
        for v, c in enumerate(self.vm.vcpu_cores):
            core_vcpu.setdefault(int(c), v)
        new = []
        for core in cores:
            vcpu = core_vcpu.get(int(core))
            if vcpu is None:
                continue            # no vCPU scheduled on that core
            domain = int(core) // self.platform.cores_per_domain
            for color, es in enumerate(self._cf.filters):
                new.append(MonitoredSet(
                    es=EvictionSet(gvas=np.array(es.gvas, np.int64),
                                   offset=es.offset, level="l2",
                                   spares=np.array(es.spares, np.int64)),
                    color=color, domain=domain, vcpu=vcpu, level="l2"))
        self._vs.add_sets(new)
        self.vscan_info["l2_monitors"] = len(new)

    # -- queries -------------------------------------------------------------
    def topology(self) -> TopologyView:
        """Domains / effective ways / detected associativity (probes the
        VEV stage on first call)."""
        self._ensure_topology()
        plat = self.platform
        return TopologyView(
            n_domains=plat.n_domains,
            cores_per_domain=plat.cores_per_domain,
            domain_vcpus={d: list(v) for d, v in self.domain_vcpus().items()},
            effective_ways=self.effective_ways(),
            detected_associativity=self._detected,
            vev_target_sets=self.config.resolve_vev_targets(plat),
            vev_built_sets=len(self._llc_sets),
            epoch=self.epoch)

    def domain_vcpus(self) -> Dict[int, List[int]]:
        if self._domain_vcpus is None:
            self._domain_vcpus = _default_domain_vcpus(self.platform)
        return self._domain_vcpus

    def colors(self) -> ColorsView:
        """Virtual-color queries (builds the VCOL filters on first call)."""
        self._ensure_colors()
        return ColorsView(self)

    def llc_sets(self) -> List[EvictionSet]:
        """Minimal LLC eviction sets built by the topology stage."""
        self._ensure_topology()
        return list(self._llc_sets)

    def monitored_sets(self):
        """VSCAN's monitored-set list (builds the VSCAN stage on first
        call).  Read-only metadata for experiment harnesses; mutating it
        desynchronizes the monitor."""
        self._ensure_vscan()
        return list(self._vs.monitored)

    def contention(self, max_age_ms: Optional[float] = None) -> ContentionView:
        """Latest contention view, re-probing when stale.

        ``max_age_ms=None`` uses ``config.refresh_interval_ms`` (the
        interval-driven re-probe); ``float("inf")`` never re-probes (pure
        read of the last published view, probing once only if no interval
        has ever run)."""
        self._ensure_vscan()
        if self._last is None:
            return self.refresh()
        limit = (self.config.refresh_interval_ms
                 if max_age_ms is None else max_age_ms)
        if self._last.age_ms(self.vm.host.time_ms) > limit:
            return self.refresh()
        return self._last

    def refresh(self) -> ContentionView:
        """Run one monitoring interval now and publish it to subscribers.

        On the default config this is exactly ``execute(plan())``: the
        interval compiles to a ProbePlan and runs through the one
        executor; pre-plan configs keep the direct `monitor_once` route."""
        self._ensure_vscan()
        if self.config.use_plans and self.config.use_batch:
            plan = self.plan()
            return self.apply(plan, probeplan.execute(self.vm, plan))
        return self._publish(self._vs.monitor_once())

    # -- the plan surface ----------------------------------------------------
    def plan(self) -> ProbePlan:
        """Compile the next monitoring interval to a ProbePlan (fused
        prime Commit → Wait(window) → WarmTimer → timed probe Measure)
        without running it — callers can inspect it, re-run it, fuse it,
        or co-execute many sessions' plans in one vectorized program
        (`probeplan.execute_many`; `FleetSim` batches all guests' per-tick
        monitoring this way).  Builds the VSCAN stage on first call."""
        self._ensure_vscan()
        return self._vs.monitor_plan()

    def tuned_lowering(self, n_guests: int = 1, measure: bool = False,
                       force: bool = False):
        """Replace the session's lowering with the autotuner's choice for
        its monitoring plan (`repro_torch.core.plancost.tune_lowering`)
        and return the :class:`~repro_torch.core.plancost.TuneReport`.

        ``measure=False`` (the default) scans the candidate lowerings on
        the analytic cost model alone — microseconds, no probing —
        unless a *measured* result for (platform, plan signature,
        n_guests) is already cached, which is then reused as-is.
        ``measure=True`` times plan cutouts on scratch VMs on the session
        VM's device (cached afterwards).  ``n_guests`` sizes the lockstep
        knob for the co-running group the caller intends (`FleetSim.tune`
        passes the fleet size)."""
        from repro_torch.core import plancost
        plan = self.plan()
        report = plancost.tune_lowering(self.platform, plan,
                                        n_guests=n_guests,
                                        seed=self.config.seed,
                                        measure=measure, force=force,
                                        device=self.vm.host.device)
        self.config = self.config.replace(lowering=report.chosen)
        if self._vs is not None:
            self._vs.lowering = report.chosen
        return report

    def execute(self, plan: ProbePlan) -> Union[ContentionView, PlanResult]:
        """Execute a ProbePlan against this session's VM.  Monitoring
        plans (from :meth:`plan`) are applied and published, returning the
        resulting :class:`ContentionView`; any other plan returns the raw
        :class:`~repro_torch.core.probeplan.PlanResult`."""
        result = probeplan.execute(self.vm, plan)
        if plan.label == "vscan.monitor":
            return self.apply(plan, result)
        return result

    def apply(self, plan: ProbePlan, result: PlanResult) -> ContentionView:
        """Consume an externally executed monitoring plan (e.g. this
        session's slot of a multi-guest `execute_many`) and publish the
        view to subscribers — the result-application half of
        :meth:`execute`."""
        if plan.label != "vscan.monitor":
            raise ValueError(f"not a monitoring plan: {plan.label!r}")
        return self._publish(self._vs.apply_monitor(plan, result))

    def _publish(self, snap: VScanSnapshot) -> ContentionView:
        self._intervals += 1
        view = ContentionView(
            per_domain=self._vs.per_domain_rate(),
            per_color=self._vs.per_color_rate(),
            mean_rate=float(snap.rate.mean()) if len(snap.rate) else 0.0,
            window_ms=snap.window_ms,
            measured_at_ms=snap.time_ms,
            interval=self._intervals,
            epoch=self.epoch,
            per_level=self._vs.per_level_rate(),
            l2_cores=self._vs.l2_core_rate())
        self._last = view
        for fn in list(self._subs.values()):
            fn(view)
        # adversarial signal class: the shield classifies each window
        # BEFORE the drift machinery looks at it — an attack onset
        # quarantines the attacked sets, which both evicts their garbage
        # from the aggregates above and keeps their (attack-driven)
        # suspicion streaks out of the drift path below
        if self._shield is not None and self._attack_subs:
            verdict = self._shield.observe(snap)
            if verdict.onset is not None:
                self._vs.flag_sets(verdict.onset.set_indices, attack=True)
                for fn in list(self._attack_subs.values()):
                    fn(verdict.onset)
            elif verdict.cleared:
                # attacker went quiet: a zero-wait clean-confirm
                # (2 dispatches) un-quarantines the intact sets
                self._vs.confirm_clean()
        # sustained probe anomalies surface as an explicit DriftSignal:
        # when suspicion streaks mature, a zero-wait confirmation (2
        # dispatches, contention-proof) either quarantines the broken sets
        # and notifies drift subscribers, or resets the streaks
        if len(self._vs.drift_suspects()):
            sig = self._vs.confirm_drift()
            if sig is not None:
                self._emit_drift(sig)
        return view

    def _emit_drift(self, sig: DriftSignal) -> None:
        self._capacity_suspect = True
        for fn in list(self._drift_subs.values()):
            fn(sig)

    def subscribe(self, fn: Callable[[ContentionView], None],
                  replay: bool = False) -> int:
        """Register a contention consumer; called (in subscription order)
        with every published :class:`ContentionView`.  ``replay=True``
        immediately delivers the last view, if any.  Returns a token for
        :meth:`unsubscribe`."""
        sid = self._next_sub
        self._next_sub += 1
        self._subs[sid] = fn
        if replay and self._last is not None:
            fn(self._last)
        return sid

    def subscribe_drift(self, fn: Callable[[DriftSignal], None]) -> int:
        """Register a drift consumer; called with every confirmed
        :class:`~repro_torch.core.vscan.DriftSignal` (monitoring anomalies) —
        the hook a long-running deployment uses to trigger
        :meth:`repair` instead of polling :meth:`check_drift`.  Shares the
        token namespace with :meth:`subscribe`/:meth:`unsubscribe`."""
        sid = self._next_sub
        self._next_sub += 1
        self._drift_subs[sid] = fn
        return sid

    def subscribe_attack(self, fn: Callable[[AttackSignal], None],
                         shield: Optional[CacheShield] = None) -> int:
        """Register an attack consumer; called with every
        :class:`~repro_torch.core.shield.AttackSignal` onset (sustained
        Prime+Probe-shaped interference).  The first subscription
        activates the session's :class:`CacheShield` (pass ``shield`` to
        supply tuned parameters); with no subscribers the shield never
        runs, so attack detection costs nothing unless asked for.
        Shares the token namespace with :meth:`subscribe` /
        :meth:`unsubscribe`."""
        if shield is not None:
            self._shield = shield
        elif self._shield is None:
            self._shield = CacheShield(
                len(self._vs.monitored) if self._vs is not None else 0)
        sid = self._next_sub
        self._next_sub += 1
        self._attack_subs[sid] = fn
        return sid

    @property
    def shield(self) -> Optional[CacheShield]:
        """The active detector (None until `subscribe_attack`) — exposes
        live attack state (``under_attack``, ``attacked``, ``signals``)
        to closed-loop consumers like the fleet's defense policy."""
        return self._shield

    def unsubscribe(self, token: int) -> None:
        self._subs.pop(token, None)
        self._drift_subs.pop(token, None)
        self._attack_subs.pop(token, None)

    # -- drift: guest-side check & incremental repair ------------------------
    def check_drift(self) -> Dict:
        """Guest-side validity check of every stage probed so far — *no
        hypercalls, no repair*: one fused Validate dispatch per stage
        (`VEV.validate_sets` self-eviction lanes).  Returns per-stage
        bool arrays (``filters_valid`` / ``llc_valid`` / ``vscan_valid``,
        True = intact) plus ``any_broken``.  This is the polling
        counterpart of :meth:`subscribe_drift`; :meth:`repair` re-checks
        and fixes in one pass."""
        out: Dict = {"any_broken": False}
        vev = self._vev()
        if self._cf is not None:
            fv = vev.validate_sets(self._cf.filters, "l2")
            out["filters_valid"] = fv
            out["any_broken"] |= bool((~fv).any())
        if self._topo_ready:
            lv = vev.validate_sets(self._llc_sets, "llc")
            out["llc_valid"] = lv
            out["any_broken"] |= bool((~lv).any())
        if self._vs is not None:
            mon = self._vs.monitored
            mv = self._validate_monitored(vev, mon)
            # drift quarantine = broken until fixed; attack quarantine is
            # interference over an intact set — not a validity defect
            mv &= ~(self._vs.flagged & ~self._vs.attack_flagged)
            out["vscan_valid"] = mv
            out["any_broken"] |= bool((~mv).any())
        return out

    def _validate_monitored(self, vev: VEV, mon) -> np.ndarray:
        """Validate the monitored sets grouped by cache level — each
        level's group rides one fused Validate dispatch at *its* miss
        threshold, so an L2 sensor is never judged by LLC latencies
        (and vice versa)."""
        mv = np.ones(len(mon), bool)
        for lv in ("llc", "l2"):
            idx = [i for i, m in enumerate(mon) if m.level == lv]
            if idx:
                mv[idx] = vev.validate_sets(
                    [mon[i].es for i in idx], lv,
                    vcpus=[mon[i].vcpu for i in idx])
        return mv

    def repair(self) -> RepairReport:
        """Incrementally repair the probed abstraction after host drift.

        Validates every built stage guest-side and fixes only what broke:
        color filters and eviction sets rebuild from their surviving
        members + spares (two fused rounds for any number of broken sets,
        `VEV.repair_sets`); cached page colors are revalidated in one
        fused round and only the invalidated pages are re-identified;
        monitored sets are swapped back live (quarantine flags cleared,
        their EWMA restarted).  A structure drifted beyond incremental
        recovery (e.g. after live migration) falls back to a fresh-pool
        rebuild of its stage, recycling the old pool's guest pages.  If a
        :class:`~repro_torch.core.vscan.DriftSignal` arrived since the last
        repair, the LLC associativity is re-detected first — a CAT
        repartition changes the target size every set must shrink/grow to.

        Bumps the abstraction ``epoch`` (stamped on all views) when
        anything changed.  At a ≤25% partial remap the whole pass costs
        ≥5x fewer probe dispatches than re-attaching from scratch
        (asserted in tests/test_drift.py, recorded by
        ``benchmarks --only drift``)."""
        vm, plat, cfg = self.vm, self.platform, self.config
        d0 = vm.stat_passes
        vev = self._vev()
        counts = dict(filters_checked=0, filters_repaired=0,
                      filters_rebuilt=0, pages_checked=0, pages_recolored=0,
                      llc_checked=0, llc_repaired=0, llc_rebuilt=0,
                      vscan_checked=0, vscan_repaired=0, vscan_rebuilt=0)

        # -- guest-side validation of every built LLC-level stage ------------
        lvalid = (vev.validate_sets(self._llc_sets, "llc")
                  if self._topo_ready else None)
        mon = self._vs.monitored if self._vs is not None else []
        mon_llc = np.array([m.level == "llc" for m in mon], bool)
        mvalid = None
        if self._vs is not None:
            mvalid = self._validate_monitored(vev, mon)
            # drift-quarantined sets count as broken (rebuild lifts the
            # flag); attack-quarantined sets are intact — rebuilding them
            # would let an attacker force arbitrarily expensive repairs.
            # They stay flagged until `VScan.confirm_clean` clears them.
            mvalid &= ~(self._vs.flagged & ~self._vs.attack_flagged)

        # -- capacity re-detection --------------------------------------------
        # Triggered by a DriftSignal (a CAT *shrink* self-conflicts), or by
        # every LLC set reading broken at once — the signature of a CAT
        # *expansion*, where grown sets stop evicting without any
        # self-conflict to signal.  The probe pool is a broken set's
        # members + spares: still congruent after a pure repartition, so
        # `probe_associativity` reads the new allocation; after a
        # migration the pool is random and detection abstains (None).
        ways_changed = False
        # the CAT-expansion signature is an *LLC* phenomenon: L2 sensors
        # (private geometry, untouched by a repartition) stay out of it
        llc_valids = [x for x in (lvalid,
                                  mvalid[mon_llc] if mvalid is not None
                                  else None)
                      if x is not None and len(x)]
        all_llc_broken = bool(llc_valids) and not any(
            bool(x.any()) for x in llc_valids)
        if self._capacity_suspect or all_llc_broken:
            probe_sets = (list(self._llc_sets)
                          or [m.es for i, m in enumerate(mon)
                              if mon_llc[i]])
            if probe_sets:
                es = max(probe_sets, key=lambda e: len(e.spares))
                pool = np.concatenate([np.asarray(es.gvas, np.int64),
                                       np.asarray(es.spares, np.int64)])
                det = vev.probe_associativity(pool, "llc", seed=cfg.seed)
                if det and det != self.effective_ways():
                    self._effective_ways = int(det)
                    ways_changed = True
        ways = self.effective_ways()

        # -- colors: filters, then only the invalidated pages ---------------
        if self._cf is not None:
            filters = self._cf.filters
            counts["filters_checked"] = len(filters)
            fvalid = vev.validate_sets(filters, "l2")
            if (~fvalid).any():
                new_sets, repaired, failed = self._repair_pass(
                    vev, filters, fvalid, "l2", plat.l2.n_ways, cfg.seed)
                if not failed and not self._filters_distinct(vev, new_sets):
                    # after heavy drift a filter can legitimately
                    # reassemble on *another* filter's color (any 8
                    # same-color lines are a valid L2 set) — a duplicated
                    # color wrecks parallel identification, so the
                    # namespace must rebuild
                    failed = list(range(len(new_sets)))
                if failed:
                    # beyond incremental recovery: rebuild the VCOL stage
                    # from a fresh pool (every virtual color re-learns its
                    # cell, so every cached page color is void)
                    counts["filters_rebuilt"] = len(filters)
                    vm.free_pages(np.unique(self._vcol.pool_pages))
                    self._vcol, self._cf = _build_colors(vm, plat, cfg)
                else:
                    counts["filters_repaired"] = len(repaired)
                    self._cf.filters[:] = new_sets
            pages = sorted(self._page_colors)
            counts["pages_checked"] = len(pages)
            if pages:
                if counts["filters_rebuilt"]:
                    page_ok = np.zeros(len(pages), bool)
                else:
                    page_ok = self._vcol.validate_page_colors(
                        self._cf, pages,
                        [self._page_colors[p] for p in pages])
                bad = [p for p, ok in zip(pages, page_ok) if not ok]
                if bad:
                    got = self._vcol.identify_colors_parallel(
                        self._cf, np.asarray(bad, np.int64))
                    # only pages whose color actually moved count as
                    # recolored (a page that re-identifies to its old
                    # color — or stays uncolorable — is not a change and
                    # must not bump the abstraction epoch forever)
                    moved = 0
                    for p, c in zip(bad, got):
                        if self._page_colors[int(p)] != int(c):
                            self._page_colors[int(p)] = int(c)
                            moved += 1
                    counts["pages_recolored"] = moved
                    if moved:
                        self._refresh_free_lists()

        # -- topology: LLC eviction sets + detected associativity ------------
        if self._topo_ready:
            counts["llc_checked"] = len(self._llc_sets)
            if ways_changed:
                lvalid[:] = False     # every set re-minimalizes at new ways
            if (~lvalid).any():
                new_sets, repaired, failed = self._repair_pass(
                    vev, self._llc_sets, lvalid, "llc", ways, cfg.seed)
                if failed:
                    counts["llc_rebuilt"] = len(self._llc_sets)
                    vm.free_pages(np.unique(self._topo_pool_pages))
                    self._topo_ready = False
                    self._llc_sets = []
                    self._detected = None
                    self._ensure_topology()
                else:
                    counts["llc_repaired"] = len(repaired)
                    self._llc_sets = new_sets
                    if ways_changed:
                        self._detected = ways

        # -- vscan: monitored sets back live ---------------------------------
        if self._vs is not None:
            counts["vscan_checked"] = len(mon)
            if ways_changed:
                # a repartition resizes LLC sets only; private-L2 sensors
                # keep their geometry and their validation verdicts
                mvalid[mon_llc] = False
            if (~mvalid).any():
                # repair per level: each group rebuilds at its own level's
                # associativity (LLC at the detected ways, L2 at the
                # platform's private-L2 ways) — only the level that broke
                # costs dispatches
                new_sets = [m.es for m in mon]
                repaired: List[int] = []
                failed: List[int] = []
                for lv, lv_ways in (("llc", ways), ("l2", plat.l2.n_ways)):
                    idx = [i for i in range(len(mon))
                           if mon[i].level == lv and not mvalid[i]]
                    if not idx:
                        continue
                    grp = [i for i in range(len(mon))
                           if mon[i].level == lv]
                    sub, sub_rep, sub_fail = self._repair_pass(
                        vev, [mon[i].es for i in grp], mvalid[grp],
                        lv, lv_ways, cfg.seed,
                        vcpus=[mon[i].vcpu for i in grp])
                    for k, i in enumerate(grp):
                        new_sets[i] = sub[k]
                    repaired += [grp[k] for k in sub_rep]
                    failed += [grp[k] for k in sub_fail]
                if failed:
                    counts["vscan_rebuilt"] = len(mon)
                    vm.free_pages(np.unique(
                        self.vscan_info.get("pool_pages",
                                            np.empty(0, np.int64))))
                    self._vs = None
                    self._ensure_vscan()
                else:
                    counts["vscan_repaired"] = len(repaired)
                    for i in repaired:
                        self._vs.replace_set(i, new_sets[i])

        self._capacity_suspect = False
        changed = ways_changed or any(
            counts[k] for k in counts if "repaired" in k or "rebuilt" in k
            or k == "pages_recolored")
        if changed:
            self.epoch += 1
        self._note_probed_epoch(revalidated=True)
        return RepairReport(epoch=self.epoch, effective_ways=ways,
                            ways_changed=ways_changed,
                            dispatches=vm.stat_passes - d0, **counts)

    def _filters_distinct(self, vev: VEV, filters: List[EvictionSet]) -> bool:
        """One fused round checking repaired color filters are pairwise
        non-congruent (distinct virtual colors): filter j must NOT evict
        filter i's spare re-addressed at j's offset.  A spare-less filter
        cannot be checked and reads as non-distinct (conservative)."""
        tests = []
        for i, fi in enumerate(filters):
            if not len(fi.spares):
                return False
            page = (int(fi.spares[0]) >> PAGE_BITS) << PAGE_BITS
            for j, fj in enumerate(filters):
                if i != j:
                    tests.append((page | int(fj.offset), fj.gvas))
        if not tests:
            return True
        verdicts = vev._verdict_round(tests, [0] * len(tests), "l2")
        return not bool(np.asarray(verdicts).any())

    def _repair_pass(self, vev: VEV, sets, valid, level: str, ways: int,
                     seed: int, vcpus=None):
        """Two-pass incremental set repair: survivors + spares first; sets
        still failing retry once with fresh top-up candidates at their
        offset (a small allocation — the filter round discards off-cell
        extras, so mixing is safe).  Returns (sets, repaired, failed)."""
        out = vev.repair_sets(sets, valid, level, ways=ways, seed=seed,
                              vcpus=vcpus)
        if not out.failed:
            return out.sets, out.repaired, []
        topup = self.vm.alloc_pages(4 * ways)
        extras = {i: np.asarray(
            [self.vm.gva(int(p), out.sets[i].offset) for p in topup],
            np.int64) for i in out.failed}
        valid2 = np.ones(len(sets), bool)
        valid2[list(out.failed)] = False
        out2 = vev.repair_sets(out.sets, valid2, level, ways=ways,
                               seed=seed + 1, vcpus=vcpus,
                               extra_pools=extras)
        # top-up pages that did not join a repaired set (the common case:
        # most candidates are non-congruent) go back to the allocator —
        # repeated repairs must not bleed the guest page pool dry
        used = {int(g) >> PAGE_BITS
                for i in out.failed
                for g in np.concatenate([out2.sets[i].gvas,
                                         out2.sets[i].spares])}
        self.vm.free_pages([int(p) for p in topup if int(p) not in used])
        return (out2.sets, sorted(out.repaired + out2.repaired),
                out2.failed)

    def _refresh_free_lists(self) -> None:
        """Re-bucket the colored free lists after pages were recolored
        (allocation state is preserved — only the color keys move)."""
        if not self._free_lists:
            return
        pages = [p for lst in self._free_lists.values() for p in lst]
        lists: Dict[int, List[int]] = {c: []
                                       for c in range(self._cf.n_colors)}
        for p in pages:
            c = self._page_colors.get(int(p), -1)
            if c >= 0:
                lists[int(c)].append(int(p))
        self._free_lists = lists
        self._vcol.free_lists = lists

    # -- persistence ---------------------------------------------------------
    def export(self) -> Dict:
        """JSON-serializable snapshot of every stage probed so far.

        v2 exports are *epoch-stamped*: ``host_epoch`` records the host
        provisioning epoch the abstraction was probed under (via the
        validation hypercall — the same §6.2 boundary as
        :meth:`validate`), so :meth:`import_` can detect a snapshot gone
        stale against a drifted host; ``abstraction_epoch`` and
        ``effective_ways`` restore the session's repair lineage."""
        cfg = dataclasses.asdict(self.config)
        cfg["offsets"] = list(cfg["offsets"])
        cfg["l2_monitor_cores"] = list(cfg["l2_monitor_cores"])
        data: Dict = {"format": EXPORT_FORMAT,
                      "platform": self.platform.name, "config": cfg,
                      "host_epoch": (self._probed_host_epoch
                                     if self._probed_host_epoch is not None
                                     else self.vm.hypercall_host_epoch()),
                      "abstraction_epoch": self.epoch,
                      "effective_ways": self._effective_ways}
        if self._cf is not None:
            data["colors"] = {
                "filters": self._cf.state_dict(),
                "page_colors": {str(p): c
                                for p, c in self._page_colors.items()},
                "free_lists": {str(c): list(v)
                               for c, v in self._free_lists.items()},
            }
        if self._topo_ready:
            data["topology"] = {
                "detected_associativity": self._detected,
                "llc_sets": [es.state_dict() for es in self._llc_sets],
                "domain_vcpus": {str(d): list(v)
                                 for d, v in self.domain_vcpus().items()},
            }
        if self._vs is not None:
            data["vscan"] = self._vs.state_dict()
        return data

    def export_json(self, path: Optional[str] = None) -> str:
        js = json.dumps(self.export(), indent=1, sort_keys=True)
        if path is not None:
            with open(path, "w") as f:
                f.write(js + "\n")
        return js

    @classmethod
    def import_(cls, vm: GuestVM, data: Dict,
                config: Optional[ProbeConfig] = None,
                allow_stale: bool = False) -> "CacheXSession":
        """Re-attach an exported abstraction to a fresh VM *without
        re-probing* — valid when the VM's GPA→HPA backing matches the one
        probed (e.g. :meth:`GuestVM.reboot`: the hypervisor keeps the
        memory across a guest reboot).  Pages the abstraction references
        are re-reserved in the guest allocator.  Contention state is live
        data and starts empty — call :meth:`refresh` to re-measure with
        the imported monitored sets.

        Epoch awareness: a v2 snapshot records the host provisioning
        epoch it was probed under; if the host has drifted since
        (migration / CAT repartition / remapping), the snapshot is stale
        and import raises :class:`StaleAbstractionError`.  Pass
        ``allow_stale=True`` to attach it anyway and call :meth:`repair`
        to salvage the surviving structures — still far cheaper than
        re-probing from scratch after a partial remap.  v1 snapshots
        (pre-epoch) import unchecked."""
        if data.get("format") not in _ACCEPTED_FORMATS:
            # another backend's export (e.g. cachex-pod-abstraction/*):
            # route it to the backend that wrote it
            from repro_torch.core.backend import backend_for_format
            be = backend_for_format(data.get("format"))
            if be is not None and cls is CacheXSession:
                return be.import_(vm, data, config=config,
                                  allow_stale=allow_stale)
            raise ValueError(f"not a {EXPORT_FORMAT} export: "
                             f"{data.get('format')!r}")
        snap_epoch = data.get("host_epoch")
        if snap_epoch is not None and not allow_stale:
            now = vm.hypercall_host_epoch()
            if now != snap_epoch:
                raise StaleAbstractionError(
                    f"snapshot was probed at host epoch {snap_epoch}, but "
                    f"the host is now at epoch {now}: provisioning drifted "
                    f"(migration / CAT repartition / page remap) and the "
                    f"snapshot's colors and sets are no longer "
                    f"trustworthy.  Import with allow_stale=True and call "
                    f"repair() to salvage what survived.")
        plat = get_platform(data["platform"])
        if config is None:
            kw = dict(data["config"])
            kw["offsets"] = tuple(kw["offsets"])
            kw["l2_monitor_cores"] = tuple(kw.get("l2_monitor_cores", ()))
            if isinstance(kw.get("lowering"), dict):
                kw["lowering"] = PlanLowering(**kw["lowering"])
            config = ProbeConfig(**kw)
        session = cls(vm, plat, config)
        session.epoch = int(data.get("abstraction_epoch", 0))
        session._probed_host_epoch = snap_epoch
        if data.get("effective_ways") is not None:
            session._effective_ways = int(data["effective_ways"])
        reserve: set = set()
        if "colors" in data:
            sec = data["colors"]
            session._cf = ColorFilters.from_state(sec["filters"])
            session._vcol = VCOL(vm, vev=VEV(
                vm, votes=config.votes, prime_reps=config.prime_reps,
                use_batch=config.use_batch, use_plans=config.use_plans,
                lowering=config.lowering))
            session._page_colors = {int(p): int(c)
                                    for p, c in sec["page_colors"].items()}
            session._free_lists = {int(c): [int(p) for p in v]
                                   for c, v in sec["free_lists"].items()}
            session._vcol.free_lists = session._free_lists
            for es in session._cf.filters:
                reserve.update(int(g) >> PAGE_BITS for g in es.gvas)
            # every page the abstraction knows the color of — including
            # the colored free lists CAP allocates from — is part of the
            # imported state and must not be recycled by fresh allocations
            reserve.update(session._page_colors)
            for pages in session._free_lists.values():
                reserve.update(pages)
        if "topology" in data:
            sec = data["topology"]
            session._detected = sec["detected_associativity"]
            session._llc_sets = [EvictionSet.from_state(s)
                                 for s in sec["llc_sets"]]
            session._domain_vcpus = {int(d): [int(v) for v in vs]
                                     for d, vs in sec["domain_vcpus"].items()}
            session._topo_ready = True
            for es in session._llc_sets:
                reserve.update(int(g) >> PAGE_BITS for g in es.gvas)
        if "vscan" in data:
            session._vs = VScan.from_state(vm, data["vscan"],
                                           use_batch=config.use_batch,
                                           use_plans=config.use_plans,
                                           lowering=config.lowering)
            for m in session._vs.monitored:
                reserve.update(int(g) >> PAGE_BITS for g in m.es.gvas)
        vm.reserve_pages(sorted(reserve))
        return session

    @classmethod
    def import_json(cls, vm: GuestVM, js: str,
                    config: Optional[ProbeConfig] = None,
                    allow_stale: bool = False) -> "CacheXSession":
        return cls.import_(vm, json.loads(js), config=config,
                           allow_stale=allow_stale)

    # -- hypercall ground truth (tests / benchmarks / reports ONLY) ----------
    def validate(self, pages: Optional[Sequence[int]] = None) -> Dict:
        """Check the abstraction against host ground truth via the
        validation hypercalls (§6.2).  Never part of a decision path —
        report-building, tests, and benchmarks only.

        Returns ``vcol_accuracy`` (over ``pages``, default: every cached
        page), ``vev_built``/``vev_verified`` (sets whose lines are all
        congruent in one (set, slice) at the effective associativity),
        ``ways_match`` (detected == guest-effective associativity), and
        the drift-epoch stamps: ``host_epoch`` (the host's provisioning
        epoch now), ``probed_epoch`` (the epoch the session last probed or
        repaired under) and ``stale`` — True when the host drifted since,
        i.e. the silent-staleness condition a pre-drift session could
        never see (regression-tested in tests/test_drift.py)."""
        vm, plat = self.vm, self.platform
        host_epoch = vm.hypercall_host_epoch()
        out: Dict = {
            "host_epoch": host_epoch,
            "probed_epoch": self._probed_host_epoch,
            "stale": (self._probed_host_epoch is not None
                      and self._probed_host_epoch != host_epoch),
        }
        if self._cf is not None:
            if pages is None:
                pages = sorted(self._page_colors)
            pages = list(pages)
            if pages:
                virtual = self._colors_of(pages)
                out["vcol_accuracy"] = color_accuracy(
                    vm, pages, virtual, plat.n_l2_colors)
        if self._topo_ready:
            ways = self.effective_ways()
            verified = [
                es for es in self._llc_sets
                if len(es) == ways
                and len({vm.hypercall_llc_setslice(int(g))
                         for g in es.gvas}) == 1]
            out["vev_built"] = len(self._llc_sets)
            out["vev_verified"] = len(verified)
            out["ways_match"] = self._detected == ways
        return out

    # -- internals behind ColorsView ----------------------------------------
    def _colors_of(self, pages: Sequence[int]) -> np.ndarray:
        self._ensure_colors()
        pages = np.asarray(pages, np.int64)
        missing = [int(p) for p in pages if int(p) not in self._page_colors]
        if missing:
            got = self._vcol.identify_colors_parallel(
                self._cf, np.asarray(missing, np.int64))
            for p, c in zip(missing, got):
                self._page_colors[int(p)] = int(c)
        return np.array([self._page_colors[int(p)] for p in pages], np.int64)

    def _build_free_lists(self, pages: Sequence[int]) -> Dict[int, List[int]]:
        colors = self._colors_of(pages)
        lists: Dict[int, List[int]] = {c: []
                                       for c in range(self._cf.n_colors)}
        for p, c in zip(pages, colors):
            if int(c) >= 0:
                lists[int(c)].append(int(p))
        self._free_lists = lists
        self._vcol.free_lists = lists
        return lists
