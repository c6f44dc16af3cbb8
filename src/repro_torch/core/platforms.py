"""CachePlatform — the cloud-provisioning scenario matrix (paper §2/§6).

The paper's central claim is that CacheX works *without knowing* how the
cloud provisioned the VM's caches: the LLC may be dedicated, way-partitioned
with Intel CAT, slice-partitioned, or shared with noisy co-tenants, on CPUs
with different geometries and hidden slice hashes.  This module makes that
scenario space first-class: a :class:`CachePlatform` bundles

  * the cache **geometry** the guest actually lands on (per-core L2, LLC
    sets/ways/slices, LLC-domain topology),
  * the **replacement policy** (``lru`` | ``random``),
  * the hypervisor **provisioning** mode — ``dedicated`` (whole LLC),
    ``cat`` (way-partitioned: the guest's effective associativity shrinks to
    its allocation, paper Table 3), ``slice`` (a subset of slices), or
    ``shared`` (full LLC plus co-tenant noise described by
    :class:`NoiseSpec`s),
  * probing parameters that depend on the platform only through quantities
    the VM can *discover* (votes / prime repetitions for non-LRU policies).

Geometries are the scaled, structurally-faithful sizes used across
tests/benchmarks (a 256-set L2 keeps 4 page colors; see tests/conftest.py);
``*_ways_total`` records the unscaled hardware intent for reporting.

All registry entries are consumed by :func:`repro_torch.core.runner.run_cachex`,
the platform-parametrized tests (tests/test_platforms.py), and the
per-platform benchmark (`benchmarks/bench_paper_tables.py`).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.core.cachesim import BLOCKS_PER_PAGE, CacheGeometry, MachineGeometry
from repro_torch.core.host_model import (CotenantWorkload, GuestVM, HostEvent,
                                         SimHost, polluter_gen, zipf_gen)
from repro_torch.core.probeplan import PlanLowering


@dataclasses.dataclass(frozen=True)
class NoiseSpec:
    """A co-tenant VM's traffic, resolved lazily to a CotenantWorkload."""

    name: str
    domain: int
    rate_per_ms: float
    kind: str = "polluter"        # "polluter" | "zipf"
    region_pages: int = 2048
    base_page: int = 1 << 18

    def workload(self) -> CotenantWorkload:
        if self.kind == "polluter":
            gen = polluter_gen(region_pages=self.region_pages,
                               base_page=self.base_page)
        elif self.kind == "zipf":
            gen = zipf_gen(base_page=self.base_page,
                           region_pages=self.region_pages)
        else:
            raise ValueError(self.kind)
        return CotenantWorkload(self.name, self.domain, self.rate_per_ms, gen)


@dataclasses.dataclass(frozen=True)
class DriftSpec:
    """One scheduled provisioning change of a platform's drift scenario.

    Times are in *monitoring intervals* (scenario-relative); a harness
    converts them to host-timeline milliseconds so the resulting
    :class:`~repro_torch.core.host_model.HostEvent` lands mid-window
    (`FleetSim` schedules each event half a window into its interval's
    wait).  Kinds and parameters mirror ``HostEvent``.
    """

    at_interval: int
    kind: str                           # migrate | cat | remap | cotenant
    fraction: float = 1.0               # remap
    new_llc_ways: Optional[int] = None  # cat
    new_slice_seed: Optional[int] = None  # migrate
    note: str = ""

    def event(self, at_ms: float) -> HostEvent:
        """Materialize at an absolute host-timeline time."""
        return HostEvent(at_ms=at_ms, kind=self.kind,
                         fraction=self.fraction,
                         new_llc_ways=self.new_llc_ways,
                         new_slice_seed=self.new_slice_seed,
                         note=self.note or f"drift@interval{self.at_interval}")

    @property
    def geometry_preserving(self) -> bool:
        """Whether the event leaves :class:`MachineGeometry` untouched.

        ``remap`` moves guest pages and ``cotenant`` changes traffic —
        both mutate state the multi-guest lockstep path snapshots and
        restores exactly, so lockstep execution stays bit-identical
        across them.  ``migrate`` / ``cat`` re-provision the machine
        (slice hash, way count): co-running guests momentarily differ in
        geometry and `execute_many` must fall back to sequential
        execution around the interval where the event lands."""
        return self.kind in ("remap", "cotenant")


@dataclasses.dataclass(frozen=True)
class AttackSpec:
    """A platform's default adversarial-co-tenancy scenario.

    Consumed by ``FleetSim(attack=True)`` (and ``benchmarks --only
    attack``): a Prime+Probe `repro_torch.core.attacker.AttackerGuest` boots
    on the victim's host, profiles for ``profile_intervals`` monitoring
    intervals, then streams priming traffic at ``rate_factor`` accesses
    per target line per ms over ``n_targets`` sets in LLC ``domain``
    (default 1 = the fleet's quiet domain, where the sensitive task
    lives) from interval ``start_interval`` until ``stop_interval`` or
    until the defense ends it.  On ``defend_after`` consecutive
    under-attack intervals the fleet's defense schedules a ``cat``
    `HostEvent` shrinking the guest allocation to ``isolate_ways`` —
    Sprabery-et-al-style way isolation: the attacker's evictions can no
    longer reach the victim's ways, traded against capacity.
    """

    start_interval: int = 5
    stop_interval: int = 10 ** 6        # "until defended"
    profile_intervals: int = 2
    n_targets: int = 4
    rate_factor: float = 12.0
    domain: int = 1
    defend_after: int = 2
    isolate_ways: int = 6


@dataclasses.dataclass(frozen=True)
class ScaleSpec:
    """A platform's rack-scale fleet execution profile.

    Consumed by `repro_torch.core.fleet.ShardedFleet` (and ``benchmarks
    --only scale``): how to size the per-guest simulation loop when
    hundreds of guests co-execute on one platform, and which shard
    sizes the `repro_torch.core.fleetshard.choose_shard` cost model may
    consider.  ``max_guests_per_dispatch`` is the honest memory
    ceiling — the largest leading batch axis a single lockstep
    dispatch may carry before host-side padding buffers dominate;
    groups larger than it *must* shard.  The loop-sizing fields
    (``n_intervals`` … ``ws_pages``) trade per-guest fidelity for
    density: a scale run cares about fleet throughput curves, not
    12-interval drift timelines.
    """

    shard_candidates: Tuple[int, ...] = (8, 16, 32, 64)
    max_guests_per_dispatch: int = 64
    n_intervals: int = 6
    warmup: int = 2
    stream_len: int = 64
    ws_pages: int = 4


@dataclasses.dataclass(frozen=True)
class CachePlatform:
    """One provisioned-cache scenario a cloud VM may land on.

    Field reference (docs/ARCHITECTURE.md has the pipeline context):

    ``name``             registry key (``get_platform(name)``); appears in
                         every benchmark CSV row and report.
    ``description``      one-line human summary of the scenario.
    ``l2``               per-core private L2 geometry (sets x ways); sets /
                         blocks-per-page determines the page-color count
                         VCOL must discover (``n_l2_colors``).
    ``llc``              guest-*effective* LLC geometry — what probing
                         should discover, after provisioning: under ``cat``
                         its ``n_ways`` is the CAT allocation, under
                         ``slice`` its ``n_slices`` is the visible subset.
    ``provisioning``     how the hypervisor carved the LLC: ``dedicated``
                         (whole LLC), ``cat`` (way-partitioned),
                         ``slice`` (slice-partitioned), ``shared`` (full
                         LLC + co-tenant noise).
    ``llc_ways_total``   *hardware* associativity (== ``llc.n_ways`` unless
                         ``cat``); reporting-only — the guest cannot see it.
    ``llc_slices_total`` *hardware* slice count (== ``llc.n_slices`` unless
                         ``slice``); reporting-only.
    ``n_domains``        independent LLC domains (e.g. Milan CCXs); CAS
                         places tasks across domains.
    ``cores_per_domain`` private-L2 cores sharing each LLC domain.
    ``replacement``      per-set policy, ``lru`` | ``random``; construction
                         must not rely on LRU (the ``votes``/``prime_reps``
                         knobs exist for ``random``).
    ``slice_seed``       seed of the hidden slice hash (the uncontrollable
                         HPA bits of §3.1-3.2); unknown to the guest.
    ``inclusion``        hierarchy variant (``inclusive`` |
                         ``non_inclusive``): whether evicting an LLC /
                         directory entry back-invalidates the line from the
                         domain's private L2s (see
                         :class:`~repro_torch.core.cachesim.MachineGeometry` and
                         `repro_torch.core.hierarchy`).  All shipped platforms
                         model the inclusive-directory design (Skylake's
                         snoop filter); tests exercise the non-inclusive
                         variant via ``dataclasses.replace``.
    ``noise``            co-tenant traffic attached at boot
                         (:class:`NoiseSpec`, resolved lazily).
    ``votes``            majority votes per eviction test — what the VM
                         would pick after discovering a noisy/non-LRU
                         scenario (3 on the shared platform).
    ``prime_reps``       prime repetitions per test, same rationale.
    ``lowering``         optional per-platform ProbePlan lowering hints
                         (padding buckets etc.); :meth:`plan_lowering`
                         derives the effective hints, forcing unfused /
                         non-lockstep execution on non-LRU replacement
                         where fused trials would not replay the
                         sequential path bit for bit.
    ``attack``           the platform's default adversarial scenario
                         (:class:`AttackSpec`): when the attack starts,
                         how concentrated it is, and how many ways the
                         defensive CAT isolation leaves the guest.
                         Consumed by ``FleetSim(attack=True)`` and
                         ``benchmarks --only attack``.
    ``drift``            the platform's default drift scenario: the
                         :class:`DriftSpec` host events a long-running
                         deployment on this provisioning would plausibly
                         see (CAT platforms get repartitions, shared
                         platforms co-tenant churn, everyone partial
                         remaps and a live migration).  Consumed by
                         ``FleetSim(drift=True)`` and
                         ``benchmarks --only drift``.
    ``scale``            the platform's rack-scale execution profile
                         (:class:`ScaleSpec`): candidate shard sizes,
                         the per-dispatch guest ceiling, and the
                         scale-run loop sizing.  Consumed by
                         ``ShardedFleet`` and ``benchmarks --only
                         scale``.
    """

    name: str
    description: str
    l2: CacheGeometry
    llc: CacheGeometry
    provisioning: str = "dedicated"
    llc_ways_total: int = 0
    llc_slices_total: int = 0
    n_domains: int = 1
    cores_per_domain: int = 2
    replacement: str = "lru"
    slice_seed: int = 0x9E3779B9
    inclusion: str = "inclusive"
    noise: Tuple[NoiseSpec, ...] = ()
    votes: int = 1
    prime_reps: int = 1
    lowering: Optional[PlanLowering] = None
    drift: Tuple[DriftSpec, ...] = ()
    attack: AttackSpec = AttackSpec()
    scale: ScaleSpec = ScaleSpec()

    def __post_init__(self):
        if self.llc_ways_total == 0:
            object.__setattr__(self, "llc_ways_total", self.llc.n_ways)
        if self.llc_slices_total == 0:
            object.__setattr__(self, "llc_slices_total", self.llc.n_slices)

    # -- derived discovery targets (ground truth for tests/driver) ----------
    @property
    def n_l2_colors(self) -> int:
        """Page colors in the L2 (HPA bits above the page offset that index
        L2 sets): n_sets / blocks-per-page."""
        return max(1, self.l2.n_sets // BLOCKS_PER_PAGE)

    @property
    def n_llc_rows_per_offset(self) -> int:
        """Distinct LLC set indices reachable at one aligned page offset."""
        return max(1, self.llc.n_sets // BLOCKS_PER_PAGE)

    @property
    def effective_ways(self) -> int:
        """What VEV should detect as the minimal eviction-set size (paper
        Table 3: equals the CAT allocation under way-partitioning)."""
        return self.llc.n_ways

    @property
    def l2_filter_reliable(self) -> bool:
        """Whether L2 color filtering is noise-free on this scenario.

        Derived from the hierarchy model
        (:func:`repro_torch.core.hierarchy.l2_filter_reliable`): on an
        *inclusive* hierarchy, a guest-effective LLC associativity below
        the L2's (a small CAT allocation) means directory evictions
        back-invalidate L2 lines mid-filter and L2 eviction tests acquire
        systematic false positives; a non-inclusive hierarchy never
        back-invalidates, so the filter stays reliable regardless.  Real
        Skylake CAT partitions only *data* ways — the directory keeps
        full associativity — so hardware L2 filtering is unaffected; the
        flag marks where our abstraction diverges (documented in
        README)."""
        from repro_torch.core import hierarchy
        return hierarchy.l2_filter_reliable(self.inclusion, self.l2,
                                            self.llc)

    def plan_lowering(self) -> PlanLowering:
        """Default ProbePlan lowering hints for this scenario — a starting
        point, not law: `repro_torch.core.plancost.tune_lowering` overrides it
        with a measured choice per (platform, plan signature), and
        ``CacheXSession.tuned_lowering`` / ``FleetSim.tune`` install that
        override.  Fused
        committed segments and multi-guest lockstep execution replay the
        per-dispatch path access for access — exact under LRU; under
        non-deterministic replacement each fused/padded trial would draw a
        different (equally valid) replacement sequence, so both are
        disabled to keep results bit-comparable to the sequential path."""
        hints = self.lowering or PlanLowering()
        if self.replacement != "lru":
            hints = dataclasses.replace(hints, fuse_commits=False,
                                        lockstep=False)
        return hints

    def machine(self) -> MachineGeometry:
        return MachineGeometry(
            n_domains=self.n_domains, cores_per_domain=self.cores_per_domain,
            l2=self.l2, llc=self.llc, replacement=self.replacement,
            slice_seed=self.slice_seed, inclusion=self.inclusion)

    def make_host_vm(self, seed: int = 0, n_guest_pages: int = 1 << 13,
                     mapping: str = "fragmented",
                     n_host_pages: int = 1 << 14,
                     with_noise: bool = True,
                     device=None) -> Tuple[SimHost, GuestVM]:
        """Boot the scenario: host machine + one probing guest, with the
        platform's co-tenants attached (``with_noise=False`` boots the same
        hardware quiesced, e.g. for accuracy baselines).  ``device`` holds
        the machine state (None: the CUDA card, see `SimHost`)."""
        host = SimHost(self.machine(), n_host_pages=n_host_pages, seed=seed,
                       device=device)
        if with_noise:
            for spec in self.noise:
                host.add_cotenant(spec.workload())
        vm = GuestVM(host, n_guest_pages=n_guest_pages, mapping=mapping,
                     vcpu_cores=list(range(self.machine().n_cores)),
                     seed=seed)
        return host, vm


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: Dict[str, CachePlatform] = {}


def register_platform(platform: CachePlatform) -> CachePlatform:
    if platform.name in _REGISTRY:
        raise ValueError(f"platform {platform.name!r} already registered")
    _REGISTRY[platform.name] = platform
    return platform


def get_platform(name: str) -> CachePlatform:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown platform {name!r}; have {sorted(_REGISTRY)}")


def list_platforms() -> List[str]:
    return sorted(_REGISTRY)


def all_platforms() -> List[CachePlatform]:
    return [_REGISTRY[n] for n in list_platforms()]


# -- built-in scenario matrix -------------------------------------------------

SMALL_L2 = CacheGeometry(n_sets=256, n_ways=8)

# The paper's evaluation platform (Table 1), scaled: sliced + shared LLC,
# whole LLC dedicated to the guest's domain.
SKYLAKE_SP = register_platform(CachePlatform(
    name="skylake_sp",
    description="Skylake-SP-like: sliced non-inclusive LLC, dedicated",
    l2=SMALL_L2,
    llc=CacheGeometry(n_sets=512, n_ways=8, n_slices=2),
    drift=(DriftSpec(at_interval=5, kind="remap", fraction=0.2,
                     note="page compaction rebacks 20% of guest memory"),
           DriftSpec(at_interval=7, kind="migrate", new_slice_seed=0x51C37,
                     note="live migration to a host with a different "
                          "slice hash")),
))

# Ice-Lake-SP-like: fewer, bigger slices modelled as a single non-sliced
# LLC domain with higher associativity (12-way in hardware).
ICELAKE_SP = register_platform(CachePlatform(
    name="icelake_sp",
    description="Ice-Lake-SP-like: non-sliced 12-way LLC, dedicated",
    l2=SMALL_L2,
    llc=CacheGeometry(n_sets=256, n_ways=12, n_slices=1),
    drift=(DriftSpec(at_interval=5, kind="remap", fraction=0.2),
           DriftSpec(at_interval=7, kind="migrate")),
    attack=AttackSpec(isolate_ways=9),
))

# Milan-like: small CCX LLC domains (several per socket), non-sliced,
# 16-way; VMs see multiple small LLC domains instead of one big one.
MILAN_CCX = register_platform(CachePlatform(
    name="milan_ccx",
    description="Milan-like: two 16-way CCX LLC domains, dedicated",
    l2=SMALL_L2,
    llc=CacheGeometry(n_sets=128, n_ways=16, n_slices=1),
    n_domains=2,
    # small CCX LLC: monitored-set probe lanes are short (16 lines), so a
    # finer lane bucket wastes far less padded work per Measure dispatch
    lowering=PlanLowering(lane_bucket=64),
    drift=(DriftSpec(at_interval=5, kind="remap", fraction=0.25,
                     note="NUMA balancing rebacks a quarter of the guest"),),
    attack=AttackSpec(isolate_ways=12),
))

# CAT way-partitioned Skylake: the hypervisor allocates 4 of 8 ways to this
# VM — effective associativity (and thus minimal eviction sets) shrinks to
# the allocation, which VEV must *discover* (paper Table 3).
SKYLAKE_CAT = register_platform(CachePlatform(
    name="skylake_cat",
    description="Skylake-SP with CAT: guest allocated 4 of 8 LLC ways",
    l2=SMALL_L2,
    llc=CacheGeometry(n_sets=512, n_ways=4, n_slices=2),
    provisioning="cat",
    llc_ways_total=8,
    drift=(DriftSpec(at_interval=5, kind="cat", new_llc_ways=6,
                     note="runtime CAT repartition grants 2 more ways"),
           DriftSpec(at_interval=7, kind="remap", fraction=0.15)),
    attack=AttackSpec(isolate_ways=3),
))

# Slice-partitioned: the guest's pages only ever land in one of the two
# slices (harvested-LLC-style provisioning); slice bits stop mattering.
SKYLAKE_SLICEPART = register_platform(CachePlatform(
    name="skylake_slicepart",
    description="Skylake-SP slice-partitioned: guest confined to 1 of 2 slices",
    l2=SMALL_L2,
    llc=CacheGeometry(n_sets=512, n_ways=8, n_slices=1),
    provisioning="slice",
    llc_slices_total=2,
    drift=(DriftSpec(at_interval=5, kind="remap", fraction=0.2),
           DriftSpec(at_interval=7, kind="migrate")),
))

# Co-tenant-shared Skylake: full geometry, but noisy neighbours keep the
# LLC under moderate pressure in domain 0 (the paper's public-cloud case;
# probing must survive the noise via majority voting).
SKYLAKE_SHARED = register_platform(CachePlatform(
    name="skylake_shared",
    description="Skylake-SP shared with a moderate co-tenant polluter",
    l2=SMALL_L2,
    llc=CacheGeometry(n_sets=512, n_ways=8, n_slices=2),
    provisioning="shared",
    noise=(NoiseSpec("steady_polluter", domain=0, rate_per_ms=30.0,
                     region_pages=1024),),
    votes=3,
    drift=(DriftSpec(at_interval=5, kind="remap", fraction=0.25,
                     note="ballooning under co-tenant memory pressure"),),
))
