"""Closed-loop CAS/CAP fleet simulator (paper §4, §6.3-6.4, Fig 10).

`run_cachex` exercises the probing stack one stage at a time; this module
closes the loop the paper's payoff sections describe: the probed cache
abstraction *changes scheduling and page-cache decisions*, and those
decisions change what the next probe measures.

One :class:`FleetSim` boots a :class:`~repro_torch.core.platforms.CachePlatform`
(widened to >= 2 LLC domains so placement matters, Fig 10's setup),
attaches the same :class:`~repro_torch.core.abstraction.CacheXSession` that
`run_cachex` drives, then iterates a genuine probe→decide→act→measure loop:

  * **probe** — `CacheXSession.refresh()` runs a windowed Prime+Probe
    interval (one fused `access_streams_batched` dispatch over every
    monitored set); whatever traffic the fleet's own placement routed into
    each domain during the wait window is what gets measured,
  * **decide** — the refreshed :class:`~repro_torch.core.abstraction.
    ContentionView` is *published* to the session's subscribers: CAS's
    :class:`~repro_torch.core.cas.TierTracker` consumes the measured per-domain
    rates and CAP's :class:`~repro_torch.core.cap.CapAllocator` the measured
    per-color ranking (`subscribe()`d hooks — the policies never poll
    VScan),
  * **act** — each guest workload is (re)placed by the active policy
    (``cas`` | ``rusty`` | ``eevdf`` via :func:`repro_torch.core.cas.policy_place`)
    and its LLC traffic is retargeted into its new domain
    (`SimHost.retarget_cotenant`); the page-cache streamer allocates its
    interval's pages from CAP's colored lists (or the vanilla mixed-color
    order when CAP is off) and streams them through the simulated caches,
  * **measure** — per-workload progress for the interval is computed by
    one batched torch function on the guest's device
    (`fleet_interval_progress`): per-tick contention accounting sums every
    workload's duty-cycled traffic into its domain, and one row per
    workload integrates the paper's IPC model
    ``ipc / (1 + sensitivity * contention)``; the cache-sensitive workload
    is additionally slowed by its *measured* working-set latency (one
    batched timed probe per interval), which is how CAP's protection shows
    up in throughput.

Asymmetric contention (Fig 10): a polluter co-tenant pins LLC pressure on
domain 0, where every workload is born.  CAS discovers the asymmetry from
VSCAN's measured rates and steers the fleet to the quiet domain after the
3-interval hysteresis; EEVDF/rusty-style affinity keeps tasks on their
birth domain.  A congruent-set poisoner keeps one virtual color's monitored
sets saturated so CAP's measured ranking steers page-cache streams into the
already-thrashed zone, away from the sensitive working set (§4.2).

`run_fleet_matrix()` sweeps policy x platform x seed in one call;
`fig10_summary` / `speedup_summary` reduce the reports to the paper's
Fig 10 domain-residency claim and Table 7/8-style speedup deltas
(the JAX package's `benchmarks/bench_paper_tables.py --only fleet` emits
them as CSV).

Every simulator of a fleet keeps its machine state on one device:
``FleetSim``, ``run_fleet``, ``run_fleet_matrix`` and ``ShardedFleet``
take ``device`` (None: the CUDA card, ``"cpu"``: the plain engine), as
`run_cachex` does.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core import hierarchy
from repro_torch.core.abstraction import CacheXSession, ProbeConfig
from repro_torch.core.attacker import AttackerGuest
from repro_torch.core.cachesim import BLOCKS_PER_PAGE, LAT_L2
from repro_torch.core.cap import CapAllocator, L2HarvestTier
from repro_torch.core.cas import TierTracker, policy_place
from repro_torch.core import fleetshard
from repro_torch.core.fleetshard import (FleetMetrics, P2Quantile,
                                         ResidencyPhases, choose_shard,
                                         device_groups, on_device)
from repro_torch.core.host_model import (CotenantWorkload, HostEvent,
                                         congruent_gen, polluter_gen,
                                         shard_slices)
from repro_torch.core.platforms import (AttackSpec, CachePlatform, DriftSpec,
                                        get_platform)
from repro_torch.core import probeplan
from repro_torch.core.probeplan import (Commit, Measure, ProbePlan, Segment,
                                        WarmTimer)
from repro_torch.core.runner import dataclass_csv_header, dataclass_csv_row

FLEET_POLICIES = ("eevdf", "rusty", "cas")
#: (policy, cap) combinations swept by default: the three policies with CAP
#: on, plus CAS with CAP off for the Table 8-style CAP-on-vs-off delta.
DEFAULT_COMBOS = (("eevdf", "on"), ("rusty", "on"),
                  ("cas", "on"), ("cas", "off"))
POLLUTED_DOMAIN = 0   # the polluter is always pinned here; quiet = 1


@dataclasses.dataclass
class FleetWorkload:
    """One guest workload co-running on the fleet.

    ``sensitivity``     IPC penalty slope vs domain contention (Fig 2a/10).
    ``llc_rate_per_ms`` LLC accesses/ms it injects into its current domain
                        while bursting (routed as real simulator traffic).
    ``duty_period``     ticks per burst cycle; ``duty_frac`` the fraction of
                        the cycle spent bursting (traffic + the IPC model
                        integrate the same duty cycle).
    ``mem_frac``        fraction of its cycles stalled on the working set;
                        > 0 only for the page-cache-sensitive workload,
                        whose measured working-set latency scales its IPC.
    """

    name: str
    sensitivity: float
    llc_rate_per_ms: float
    duty_period: int = 8
    duty_frac: float = 1.0
    mem_frac: float = 0.0
    vcpu: Optional[int] = None
    done_work: float = 0.0


def default_workloads() -> List[FleetWorkload]:
    """The Fig 10-style trio: a cache-sensitive task with a hot working
    set, a page-cache streamer, and a bursty batch task."""
    return [
        FleetWorkload("ws_sensitive", sensitivity=1.0, llc_rate_per_ms=15.0,
                      duty_period=8, duty_frac=1.0, mem_frac=0.35),
        FleetWorkload("pc_streamer", sensitivity=0.1, llc_rate_per_ms=10.0,
                      duty_period=8, duty_frac=0.75),
        FleetWorkload("batch_load", sensitivity=0.3, llc_rate_per_ms=20.0,
                      duty_period=16, duty_frac=0.5),
    ]


def fleet_view(plat: CachePlatform, n_workloads: int) -> CachePlatform:
    """Widen a platform to the fleet topology: >= 2 LLC domains (so
    placement decisions exist) with enough cores per domain that the whole
    fleet fits in the quiet domain.  Geometry, provisioning, replacement,
    noise and probing parameters are untouched."""
    return dataclasses.replace(
        plat,
        n_domains=max(2, plat.n_domains),
        cores_per_domain=max(plat.cores_per_domain, n_workloads))


def fleet_interval_progress(domain_idx, rates, duty_period, duty_on, sens,
                            ipc0, slowdown, noise_dom, scale, *,
                            n_domains: int, ticks: int):
    """One monitoring interval of per-tick progress + contention accounting
    for all workloads, as one batched torch computation on the inputs'
    device (f32, as the JAX package computes it).

    Shapes: ``domain_idx/rates/duty_period/duty_on/sens/ipc0/slowdown`` are
    (B,) over workloads (``domain_idx``, ``duty_period`` and ``duty_on``
    int32, the rest f32); ``noise_dom`` is (D,) f32 non-fleet co-tenant
    traffic per domain (accesses/ms); ``scale`` converts accesses/ms to the
    dimensionless contention index (100 / LLC lines per domain, i.e. the
    %-of-LLC-touched-per-ms scale VSCAN's rates live on).

    Per tick t: workload w is bursting iff ``t % duty_period[w] <
    duty_on[w]``; domain traffic is the sum of bursting workloads' rates
    plus ``noise_dom``; per-tick progress of each workload is
    ``ipc0 / ((1 + sens * contention[domain]) * slowdown)``.
    Returns (per-workload progress summed over ticks, per-domain mean
    contention index).

    The per-domain sum is a masked reduction over workloads rather than
    ``index_add_``: on a CUDA tensor ``index_add_`` adds by atomics, whose
    order (and so the last bit of a three-way sum) changes from run to
    run, while this reduction gives the same bits every time.
    """
    dev = rates.device
    t = torch.arange(ticks, dtype=torch.int32, device=dev)
    active = (t[None, :] % duty_period[:, None]) < duty_on[:, None]   # (B,T)
    inj = rates[:, None] * active                                      # (B,T)
    member = (domain_idx[:, None]
              == torch.arange(n_domains, dtype=domain_idx.dtype,
                              device=dev)[None, :])                    # (B,D)
    traffic = ((member[:, :, None] * inj[:, None, :]).sum(dim=0)
               + noise_dom[:, None])                                   # (D,T)
    cont = traffic * scale
    dom = domain_idx.long()
    per_tick = ipc0[:, None] / ((1.0 + sens[:, None] * cont[dom])
                                * slowdown[:, None])                   # (B,T)
    return per_tick.sum(dim=1), cont.mean(dim=1)


@dataclasses.dataclass
class FleetReport:
    """Result of one closed-loop fleet run (one platform x policy x cap).

    ``quiet_residency``  post-warmup fraction of intervals the
                         cache-sensitive workload spent in the quiet domain
                         (Fig 10's metric; 1.0 = always steered away).
    ``throughput``       post-warmup done work summed over workloads (IPC
                         model units; ratios across runs are the Table 7/8
                         speedups).
    ``ws_lat_cycles``    mean measured working-set latency (simulated
                         cycles) post-warmup — CAP's protection shows here.
    ``hot_rate``/``quiet_rate``  mean *measured* VSCAN EWMA rates
                         (%-lines/ms) of the polluted / quiet domain.
    ``drift_events``/``repairs``/``repair_dispatches``  drift-scenario
                         accounting: host events that fired, repair passes
                         that actually fixed something, and the probe
                         dispatches all repair passes cost.
    ``attack_*``/``defenses``/``false_drift``/``residency_*``
                         adversarial-scenario accounting (attack runs
                         only): attacker-active intervals, whether the
                         shield detected, intervals from attack start to
                         detection, defensive CAT isolations scheduled,
                         DriftSignals raised while the attack ran with no
                         host event or defense to explain them (must be
                         0 — attack is not drift), and the sensitive
                         task's quiet-domain residency before / during /
                         after the attack+defense episode.
    ``recovery_max_intervals``  worst-case intervals from a host event
                         until the *measured* per-domain ranking again
                         identified the polluted domain (and, under CAS,
                         the sensitive task sat in a quiet domain);
                         -1 = a drift scenario ran but never re-converged.
    ``harvest*``/``l2_*_rate``  L2-harvest-scenario accounting (harvest
                         runs only): the knob ("off" = same thrashed
                         scenario without the routing), intervals the
                         working set actually ran on a granted quiet core,
                         the tier's grant / revocation / promotion
                         counters, and the mean measured per-core L2 rates
                         of the sensitive task's (thrashed) core vs the
                         chosen harvest core.
    ``guests_per_sec``   fleet throughput: guests completed per wall
                         second.  Standalone runs report ``1 / wall_s``;
                         co-executed runs (`_run_lockstep` /
                         :class:`ShardedFleet`) stamp the *fleet-level*
                         rate ``n_guests / fleet_wall`` on every report —
                         the scaling-curve metric BENCH records.
    ``serve_*``          serving-guest accounting (``serving=True`` runs
                         only): requests routed post-warmup and the
                         p50/p99 request latency (ms, P² sketches) the
                         :class:`ServingGuest`'s router achieved — CAS
                         placement shows up here as a p99 drop.
    """

    platform: str
    policy: str
    cap: str                     # "on" | "off"
    seed: int
    n_intervals: int
    warmup: int
    throughput: float
    per_workload: Dict[str, float]
    quiet_residency: float
    hot_rate: float
    quiet_rate: float
    tiers: Dict[int, int]
    ws_lat_cycles: float
    recolor_events: int
    reclaims: int
    cap_allocated: int
    dispatches: int
    accesses: int
    wall_s: float
    drift_events: int = 0
    repairs: int = 0
    repair_dispatches: int = 0
    recovery_max_intervals: int = 0
    attack_windows: int = 0
    attack_detected: bool = False
    attack_detect_intervals: int = -1
    defenses: int = 0
    false_drift: int = 0
    residency_pre: float = 0.0
    residency_during: float = 0.0
    residency_post: float = 0.0
    harvest: str = "none"        # "none" | "off" | "on"
    harvest_intervals: int = 0
    harvest_grants: int = 0
    harvest_revocations: int = 0
    harvest_promotions: int = 0
    l2_hot_rate: float = 0.0
    l2_quiet_rate: float = 0.0
    guests_per_sec: float = 0.0
    serve_requests: int = 0
    serve_p50_ms: float = 0.0
    serve_p99_ms: float = 0.0

    @classmethod
    def csv_header(cls) -> str:
        """Headered-CSV contract: columns are exactly the fields above."""
        return dataclass_csv_header(cls)

    def csv_row(self) -> str:
        return dataclass_csv_row(self)


class ServingGuest:
    """`repro_torch.serve.engine` Request stream as a fleet guest workload.

    Closes the serving loop on the LLC side (paper §4.1's CAS-TPU
    routing, driven by the *measured* abstraction): each monitoring
    interval the guest issues a burst of decode requests and routes them
    across per-domain model replicas with the serve engine's
    :class:`~repro_torch.serve.engine.ReplicaRouter` — one replica per LLC
    domain, so "route to the least-contended replica" is exactly a CAS
    placement decision.  Decisions come from measurement: the router's
    tier tracker is `CacheXSession.subscribe`'d to the published
    ContentionViews (``placement=True``; off = the tiers never learn and
    the router degenerates to least-loaded spreading, which keeps landing
    requests on the polluted domain).  Outcomes come from ground truth:
    each request's decode latency is charged from the fleet kernel's
    per-domain contention (`fleet_interval_progress`'s second return) at
    the replica it actually ran on — ``tokens x base_ms x (1 + sens x
    contention[domain])`` — so a router that measures well moves the p99,
    not just a synthetic IPC index.  Latencies stream into P² sketches
    (`~repro_torch.core.fleetshard.P2Quantile`): O(1) memory at any request
    rate, the same posture as the fleet's other streaming metrics."""

    def __init__(self, n_domains: int, thresholds: Sequence[float],
                 placement: bool = True, rate: int = 6, tokens: int = 16,
                 base_ms: float = 1.0, sensitivity: float = 2.0,
                 seed: int = 0):
        from repro_torch.serve.engine import ReplicaRouter
        self.router = ReplicaRouter(
            n_domains, tiers=TierTracker(keys=list(range(n_domains)),
                                         thresholds=list(thresholds)))
        self.placement = placement
        self.rate = int(rate)
        self.tokens = int(tokens)
        self.base_ms = float(base_ms)
        self.sens = float(sensitivity)
        self.rng = np.random.default_rng(seed + 0x5E12)
        self.p50 = P2Quantile(0.50)
        self.p99 = P2Quantile(0.99)
        self.requests = 0
        self._rid = 0

    def step(self, cont: np.ndarray) -> None:
        """One interval of request traffic: route ``rate`` requests, then
        charge each its replica-domain's ground-truth decode latency for
        this interval (``cont`` is the kernel's per-domain mean contention
        index).  Requests are assigned before any completes — the burst is
        in flight together, so the router's load tie-breaker spreads it —
        and completed at interval end (decode finishes within the
        window)."""
        from repro_torch.serve.engine import Request
        reqs = []
        for _ in range(self.rate):
            req = Request(rid=self._rid, prompt=np.zeros(4, np.int32),
                          max_new=self.tokens
                          + int(self.rng.integers(0, self.tokens // 2 + 1)))
            self._rid += 1
            self.router.assign(req)
            reqs.append(req)
        for req in reqs:
            lat = (req.max_new * self.base_ms
                   * (1.0 + self.sens * float(cont[req.replica])))
            self.p50.add(lat)
            self.p99.add(lat)
            self.requests += 1
            self.router.complete(req)


class FleetSim:
    """Closed-loop co-run harness over one platform (see module docstring)."""

    def __init__(self, platform: Union[str, CachePlatform],
                 policy: str = "cas", cap: str = "on",
                 workloads: Optional[List[FleetWorkload]] = None,
                 seed: int = 0, use_batch: bool = True,
                 use_plans: bool = True,
                 n_intervals: int = 12, warmup: int = 4,
                 ticks_per_interval: int = 32, stream_len: int = 192,
                 ws_pages: int = 8, thresholds: Sequence[float] = (1.0, 4.0),
                 drift: Union[bool, Sequence[DriftSpec]] = False,
                 repair_on_drift: bool = True, revalidate_every: int = 4,
                 attack: Union[bool, AttackSpec] = False,
                 defend: bool = True, with_poisoner: bool = True,
                 harvest: Optional[str] = None,
                 harvest_threshold: float = 0.25,
                 keep_history: bool = False,
                 sim_seed: Optional[int] = None,
                 session_import: Optional[Dict] = None,
                 page_pool: Optional[Sequence[int]] = None,
                 serving: bool = False, serving_placement: bool = True,
                 serving_rate: int = 6, device=None):
        # keep_history materializes the per-interval metric series (the
        # pre-scale behaviour) for timeline consumers and parity tests;
        # off (the default) the sim streams — O(series) floats per run,
        # independent of n_intervals.  sim_seed diversifies a guest's
        # *simulation* randomness (placement wakeup order, serving
        # arrivals) without changing the boot seed — `ShardedFleet`
        # clones share one boot (identical hosts, one exported
        # abstraction) but must not move in lockstep as a policy input.
        # session_import boots from an exported abstraction (zero
        # re-probing; the donor's page_pool rides along so the colored
        # free lists come straight from the imported page colors).  device
        # holds the machine state (None: the CUDA card; the attacker guest
        # boots on the same host, so on the same device).
        if policy not in FLEET_POLICIES:
            raise ValueError(f"policy must be one of {FLEET_POLICIES}")
        if harvest not in (None, "off", "on"):
            raise ValueError("harvest must be None, 'off' or 'on'")
        plat0 = get_platform(platform) if isinstance(platform, str) else platform
        self.tasks = workloads if workloads is not None else default_workloads()
        self.plat = fleet_view(plat0, len(self.tasks))
        self.policy = policy
        self.cap_on = (cap == "on")
        self.seed = seed if sim_seed is None else sim_seed
        self.boot_seed = seed
        self.keep_history = keep_history
        self.metrics = FleetMetrics(keep_history=keep_history)
        self.use_batch = use_batch
        # use_plans drives every per-interval probe through ProbePlan
        # programs (`steps()` yields them; `run_fleet_matrix` co-executes
        # all guests' plans in lockstep); False keeps the pre-plan
        # per-dispatch loop as the parity/benchmark reference.  Plans are
        # inherently batched, so the seed use_batch=False reference keeps
        # the per-dispatch loop too (same gate as session.refresh /
        # VScan.monitor_once).
        self.use_plans = use_plans
        self._plan_route = use_plans and use_batch
        self.n_intervals = n_intervals
        self.warmup = warmup
        self.ticks = ticks_per_interval
        self.stream_len = stream_len
        self.n_ws_pages = ws_pages
        self.rng = np.random.default_rng(self.seed + 99)

        self.host, self.vm = self.plat.make_host_vm(seed=seed, device=device)
        self.vcpu_domain = {v: c // self.plat.cores_per_domain
                            for v, c in enumerate(self.vm.vcpu_cores)}

        # -- probing stack: the same session API run_cachex drives ----------
        cfg = ProbeConfig.for_platform(self.plat, use_batch=use_batch,
                                       use_plans=use_plans, seed=seed,
                                       prune_self_conflicts=True)
        if harvest is not None:
            # harvest scenarios monitor every core's private L2 (VSCAN
            # clones the color filters per core) so the tier's quiet-core
            # probe covers the whole machine
            n_cores = self.plat.n_domains * self.plat.cores_per_domain
            cfg = dataclasses.replace(
                cfg, l2_monitor_cores=tuple(range(n_cores)))
        if session_import is not None:
            # boot from a donor guest's exported abstraction: same boot
            # seed => identical host backing, so colors / monitored sets
            # import with zero re-probing (`ShardedFleet`'s O(1)-per-guest
            # construction).  import_ resolves the registry platform;
            # re-widen it to the fleet view so domain_vcpus spans the
            # fleet topology exactly like the attach path.
            self.session = CacheXSession.import_(self.vm, session_import,
                                                 config=cfg)
            self.session.platform = self.plat
        else:
            self.session = CacheXSession.attach(self.vm, self.plat, cfg)
        self.lowering = self.session.config.lowering
        self.colors = self.session.colors()          # VCOL color filters
        self.session.monitored_sets()                # VSCAN monitor build
        self.domain_vcpus = self.session.domain_vcpus()
        self.tt = TierTracker(keys=sorted(self.domain_vcpus),
                              thresholds=list(thresholds))
        # decide-edge consumers ride session publications, never poll VScan
        self.session.subscribe(self.tt.on_contention)

        # -- drift scenario: scheduled host events + repair-on-signal -------
        # drift=True uses the platform's default DriftSpec schedule; an
        # explicit sequence overrides it.  `repair_on_drift` closes the
        # recovery loop: DriftSignals (and a `revalidate_every`-interval
        # validation cadence, which catches silent remaps that never
        # self-conflict) trigger `session.repair()` before the next probe.
        self.drift_specs: Tuple[DriftSpec, ...] = (
            tuple(plat0.drift) if drift is True else tuple(drift or ()))
        # intervals where a geometry-*changing* event (migrate/cat) can
        # land mid-window: multi-guest lockstep execution falls back to
        # per-guest execution for exactly these rounds (geometry-preserving
        # remap/cotenant drift keeps lockstep everywhere — see
        # DriftSpec.geometry_preserving)
        self._seq_only_intervals = {spec.at_interval
                                    for spec in self.drift_specs
                                    if not spec.geometry_preserving}
        self.repair_on_drift = repair_on_drift
        self.revalidate_every = revalidate_every
        self._repair_pending = False
        self._outstanding: List[Tuple[int, object]] = []  # (interval, event)
        self.stat_drift_events = 0
        self.stat_repairs = 0
        self.stat_repair_dispatches = 0
        self._recoveries: List[int] = []

        # -- adversarial scenario: attacker guest + shield + defense --------
        # attack=True uses the platform's AttackSpec; defense (on by
        # default) schedules the CAT way isolation on sustained detection.
        self.attack_spec: Optional[AttackSpec] = (
            plat0.attack if attack is True
            else (attack if isinstance(attack, AttackSpec) else None))
        self.defend = defend
        self.with_poisoner = with_poisoner
        self.attacker: Optional[AttackerGuest] = None
        self._attack_activity: Optional[np.ndarray] = None
        self._cur_interval = -1
        self._under_attack_intervals = 0
        self._defended = False
        self._defended_at: Optional[int] = None
        self.stat_attack_windows = 0
        self.stat_defenses = 0
        self.stat_false_drift = 0
        self._detect_interval = -1
        # streaming pre/during/post residency (replaces the materialized
        # (interval, in_quiet) history list): classified online, O(1)
        # memory with the shipped AttackSpecs
        self._resid: Optional[ResidencyPhases] = None
        if self.attack_spec is not None:
            self._resid = ResidencyPhases(
                warmup=warmup, start=self.attack_spec.start_interval,
                stop=self.attack_spec.stop_interval,
                n_intervals=n_intervals, defend=defend)
            self.attacker = AttackerGuest(self.host, self.plat, seed=seed)
            self.session.subscribe_attack(self._on_attack_signal)

        if ((self.drift_specs or self.attack_spec is not None)
                and self.repair_on_drift):
            self.session.subscribe_drift(self._on_drift_signal)

        # -- serving guest: serve-engine Request stream as a workload --------
        # placement=True subscribes the router's tiers to the session's
        # published views (the decide edge); placement=False keeps the
        # tiers blind — the on-vs-off p99 delta isolates CAS routing.
        self.serving: Optional[ServingGuest] = None
        if serving:
            self.serving = ServingGuest(
                n_domains=self.plat.n_domains, thresholds=thresholds,
                placement=serving_placement, rate=serving_rate,
                seed=self.seed)
            if serving_placement:
                self.session.subscribe(self.serving.router.on_contention)

        # -- asymmetric contention (Fig 10): pollute domain 0 ---------------
        llc = self.plat.llc
        self.host.add_cotenant(CotenantWorkload(
            "fig10_polluter", POLLUTED_DOMAIN,
            rate_per_ms=0.6 * llc.n_sets * llc.n_slices,
            gen=polluter_gen(region_pages=2048)))

        self.harvest_mode = harvest
        self.harvest_on = harvest == "on"
        self._page_pool = list(page_pool) if page_pool is not None else None
        self._setup_page_cache()

        # -- the fleet: every workload born on the polluted domain ----------
        for i, task in enumerate(self.tasks):
            task.vcpu = (POLLUTED_DOMAIN * self.plat.cores_per_domain + i
                         if task.vcpu is None else task.vcpu)
            self.host.add_cotenant(CotenantWorkload(
                f"fleet:{task.name}", self.vcpu_domain[task.vcpu],
                rate_per_ms=task.llc_rate_per_ms * task.duty_frac,
                gen=polluter_gen(region_pages=1024,
                                 base_page=(1 << 19) + i * (1 << 15))))
        # convention: the first workload owns the measured working set, the
        # second drives the page-cache stream
        self._sens = self.tasks[0]
        self._streamer = self.tasks[min(1, len(self.tasks) - 1)]

        # -- L2 harvest scenario: an SMT-sibling co-tenant thrashes
        #    the sensitive task's private L2 wherever it runs.  The working
        #    set's latency is measured *residually* (before the interval's
        #    re-traversal, after a full co-tenant window) so it reflects
        #    what actually survived in the L2.  harvest="on" routes the
        #    working set to the tier's measured-quiet core; harvest="off"
        #    runs the identical scenario without the routing — the on-vs-off
        #    delta isolates the harvest decision itself.
        self.harvest_tier: Optional[L2HarvestTier] = None
        self.stat_harvest_intervals = 0
        if harvest is not None:
            spec = hierarchy.HierarchySpec.of(self.plat)
            self.harvest_tier = self.cap.attach_harvest(L2HarvestTier(
                spec, quiet_threshold=harvest_threshold))
            if not self.cap_on:
                # cap-off runs still step the tier on every publication
                self.session.subscribe(self.harvest_tier.on_contention)
            # the sibling's working set conflicts with the sensitive
            # working set in the *L2* (same set residues, enough aliases
            # to roll the L2's ways) but barely touches its LLC sets —
            # per residue the aliases spread across the LLC's extra index
            # bits, so the LLC copies (and back-invalidation) are left
            # alone and the damage is genuinely L2-local.  Target
            # residues come from the hypercall side, like `_true_color`:
            # scenario instrumentation, not the decision stack.
            l2 = self.plat.l2
            ws_blocks = {self.vm.hypercall_hpa_page(int(p))
                         * BLOCKS_PER_PAGE + b
                         for p in self.ws_pages for b in (0, 1)}
            l2_sets = sorted({int(b) % l2.n_sets for b in ws_blocks})
            aliases = l2.n_ways + 4
            sens_core = int(self.vm.vcpu_cores[self._sens.vcpu])
            self.host.add_cotenant(CotenantWorkload(
                "l2_thrasher", sens_core // self.plat.cores_per_domain,
                rate_per_ms=50.0 * len(l2_sets),
                gen=congruent_gen(
                    l2_sets, l2.n_sets, base_page=1 << 18,
                    span_pages=max(1, aliases * l2.n_sets
                                   // BLOCKS_PER_PAGE)),
                core=sens_core, l2_local=True))

    # ----------------------------------------------------------------- tune
    def tune(self, n_guests: int = 1, measure: bool = True,
             force: bool = False):
        """Autotune this sim's plan lowering
        (``CacheXSession.tuned_lowering``): time candidate lowerings on
        plan cutouts and install the winner for every plan the sim yields.
        ``n_guests`` sizes the lockstep knob for the co-running group
        (`run_fleet_matrix` passes the fleet size; later sims of the same
        platform hit the tune cache and pay nothing)."""
        report = self.session.tuned_lowering(n_guests=n_guests,
                                             measure=measure, force=force)
        self.lowering = report.chosen
        return report

    def install_lowering(self, lowering: probeplan.PlanLowering) -> None:
        """Install an explicit lowering for every plan this sim yields —
        the sim's own traverse/ws_lat plans *and* the session's monitor
        plans (the same wiring ``tuned_lowering`` uses).  `ShardedFleet`
        threads the chosen ``shard_size`` through here so the whole
        co-running group dispatches in reused-shape guest shards."""
        self.lowering = lowering
        self.session.config = self.session.config.replace(lowering=lowering)
        if self.session._vs is not None:
            self.session._vs.lowering = lowering

    # ------------------------------------------------------------------ CAP
    def _true_color(self, pages: Sequence[int]) -> int:
        """Host-truth L2 color label of a virtual-color group (experiment
        instrumentation, mirroring §6.2's validation hypercall use — the
        guest-side decision stack only ever sees measured rates)."""
        n = self.plat.n_l2_colors
        truths = [self.vm.hypercall_hpa_page(int(p)) % n for p in pages]
        vals, counts = np.unique(truths, return_counts=True)
        return int(vals[np.argmax(counts)])

    def _rows_of_true_color(self, t: int) -> List[int]:
        """LLC set-index rows (at aligned offset 0) that pages of true L2
        color ``t`` can land on."""
        n_rows = self.plat.n_llc_rows_per_offset
        n_col = self.plat.n_l2_colors
        return sorted({h % n_rows for h in range(n_rows * n_col)
                       if h % n_col == t})

    def _setup_page_cache(self) -> None:
        """Colored free lists, the sensitive working set, the vanilla
        stream order, and the congruent-set poisoner that keeps the stream
        target color's monitored sets hot.

        A donor-provided ``page_pool`` (`ShardedFleet` clones) replaces
        the fresh allocation: the pool's pages are exactly the ones the
        imported abstraction already knows the colors of, so the free
        lists build without a single classification probe."""
        if self._page_pool is not None:
            pool = list(self._page_pool)
        else:
            pool = self.vm.alloc_pages(
                min(240 * max(1, self.colors.n_colors), 1024))
        self.pool_pages = list(pool)
        lists = self.colors.build_free_lists(pool)
        truths = {c: self._true_color(ps) for c, ps in lists.items() if ps}
        d0_colors = {m.color for m in self.session.monitored_sets()
                     if m.domain == POLLUTED_DOMAIN}

        # stream color P: has monitored sets in the polluted domain (so the
        # poisoner is measurable) and a deep free list; working-set color W:
        # LLC rows disjoint from P's where the geometry allows
        cands = [c for c in sorted(lists, key=lambda c: -len(lists[c]))
                 if lists[c]]
        p_cands = [c for c in cands if c in d0_colors] or cands
        self.stream_color = p_cands[0]
        p_rows = set(self._rows_of_true_color(truths[self.stream_color]))

        def disjointness(c):
            return (len(set(self._rows_of_true_color(truths[c])) - p_rows),
                    len(lists[c]))
        w_cands = [c for c in cands if c != self.stream_color]
        if self.harvest_mode is not None:
            # harvest scenarios keep the working set's L2 sets clear of
            # the color filters': the ws lines live at block offsets 0/1
            # of their pages, and a filter built at offset 0 or 64 would
            # occupy those exact L2 sets — its per-core L2 monitor clone
            # then primes the promoted lines out of the harvest core
            # every interval
            clear = [c for c in w_cands
                     if self.session._cf.filters[c].offset not in (0, 64)]
            w_cands = clear or w_cands
        self.ws_color = max(w_cands, key=disjointness)

        ws = [lists[self.ws_color].pop()
              for _ in range(min(self.n_ws_pages,
                                 len(lists[self.ws_color]) - 1))]
        self.ws_pages = ws
        self.ws_lines = np.array([self.vm.gva(p, off)
                                  for p in ws for off in (0, 64)])
        self.free_lists = lists
        self.cap = CapAllocator({c: list(v) for c, v in lists.items()},
                                use_contention=True)
        if self.cap_on:
            self.session.subscribe(self.cap.on_contention)
        # vanilla order: interleave colors round-robin (the kernel's
        # color-oblivious allocator), truncated to the stream length
        depth = max(len(v) for v in lists.values())
        mixed = [lists[c][j] for j in range(depth) for c in sorted(lists)
                 if j < len(lists[c])]
        self.vanilla_order = mixed[:self.stream_len]

        # congruent-set poisoner: saturates P's offset-0 monitored rows in
        # the polluted domain so the measured per-color ranking stays put.
        # Skipped for adversarial scenarios (with_poisoner=False): the
        # poisoner is physically attack-shaped — concentrated congruent
        # whole-set traffic — and would both trip the shield and inflate
        # its burst baseline.
        if not self.with_poisoner:
            return
        rows = self._rows_of_true_color(truths[self.stream_color])
        target_sets = [r * BLOCKS_PER_PAGE for r in rows]
        n_cells = max(1, len(rows) * self.plat.llc.n_slices)
        self.host.add_cotenant(CotenantWorkload(
            "color_poisoner", POLLUTED_DOMAIN,
            rate_per_ms=12.0 * n_cells,
            gen=congruent_gen(target_sets, self.plat.llc.n_sets,
                              base_page=1 << 17)))

    # ------------------------------------------------------------- drift
    def _on_drift_signal(self, sig) -> None:
        """`subscribe_drift` hook: queue a repair for the next interval
        (the signal arrives mid-publish; repairing inline would race the
        consumers of the same view).

        Adversarial accounting: a DriftSignal raised while the attack
        stream is live and *no* host event is in flight has nothing real
        behind it — the only cache-state change is the attacker's priming,
        so it is the attack masquerading as drift.  The shield exists to
        keep this count at zero (attack != drift)."""
        if (self.attacker is not None and self.attacker.active
                and not self._outstanding):
            self.stat_false_drift += 1
        self._repair_pending = True

    def _on_attack_signal(self, sig) -> None:
        """`subscribe_attack` hook: record detection latency (intervals
        from attack start to the first AttackSignal).  The defense itself
        runs from the loop (`_maybe_defend`) once detection *sustains*."""
        if self._detect_interval < 0 and self.attack_spec is not None:
            self._detect_interval = max(
                0, self._cur_interval - self.attack_spec.start_interval)

    def _schedule_due_events(self, interval: int) -> None:
        """Materialize this interval's DriftSpecs on the host timeline,
        half a monitoring window into the upcoming wait — the event lands
        *mid-probe*, exactly the silent-invalidation the paper warns
        about."""
        for spec in self.drift_specs:
            if spec.at_interval != interval:
                continue
            at = self.host.time_ms + 0.5 * self.session._vs.window_ms
            self.host.schedule_event(spec.event(at))
            self._outstanding.append((interval, spec))
            self.stat_drift_events += 1

    def _maybe_repair(self, interval: int) -> None:
        """Repair-on-signal plus the periodic validation cadence (silent
        remaps never self-conflict, so signals alone cannot catch them —
        this is the 'vSCAN monitors continuously' production posture)."""
        if not ((self.drift_specs or self.attack_spec is not None)
                and self.repair_on_drift):
            return
        due = (self._repair_pending
               or (self.revalidate_every
                   and interval and interval % self.revalidate_every == 0))
        if not due:
            return
        self._repair_pending = False
        d0 = self.vm.stat_passes
        rep = self.session.repair()
        self.stat_repair_dispatches += self.vm.stat_passes - d0
        if rep.anything_broken:
            self.stat_repairs += 1
            if rep.pages_recolored or rep.filters_rebuilt:
                # CAP's buckets reflect the old colors: re-sync them
                self.cap.rebucket(self.session.colors().known_pages())

    # ----------------------------------------------------------- attack
    def _maybe_defend(self, interval: int) -> None:
        """Defense policy: once the shield reports *sustained* attack
        (``defend_after`` consecutive intervals), schedule a ``cat`` host
        event shrinking the guest-effective ways to ``isolate_ways`` —
        the CAT re-carve that takes the victim's ways out of the
        attacker's reach — and silence the attack stream (its evictions
        no longer land).  The way change is a genuine geometry change, so
        it flows through the normal drift path: DriftSignal → repair →
        CAP rebucket, and `_note_recovery` closes the episode when the
        measured ranking steers correctly again."""
        spec, atk = self.attack_spec, self.attacker
        if spec is None or atk is None or not self.defend or self._defended:
            return
        shield = self.session.shield
        if shield is not None and shield.under_attack:
            self._under_attack_intervals += 1
        else:
            self._under_attack_intervals = 0
        if self._under_attack_intervals < spec.defend_after:
            return
        at = self.host.time_ms + 0.5 * self.session._vs.window_ms
        self.host.schedule_event(HostEvent(
            at_ms=at, kind="cat", new_llc_ways=spec.isolate_ways,
            note="defense: CAT way isolation"))
        # the re-carve is geometry-changing: this interval must execute
        # per guest in lockstep mode (same rule as cat/migrate DriftSpecs)
        self._seq_only_intervals.add(interval)
        atk.stop()
        self._outstanding.append((interval, "defense"))
        self._defended = True
        self._defended_at = interval
        self.stat_defenses += 1

    def _attack_pre(self, k: int) -> bool:
        """Attack lifecycle ahead of interval ``k``'s monitor probe:
        profiling primes (the victim's own priming overwrites them — the
        measurement happens in `_attack_post`), and the attack stream's
        begin/stop edges.  Returns True on profiling intervals."""
        spec, atk = self.attack_spec, self.attacker
        if spec is None or atk is None:
            return False
        profiling = (spec.start_interval - spec.profile_intervals
                     <= k < spec.start_interval)
        if profiling:
            atk.prime(list(range(len(atk._sets()))))
        if k == spec.start_interval and not self._defended:
            if not atk.targets:
                atk.choose_targets(k=spec.n_targets, domain=spec.domain)
            blocks = atk.target_blocks()
            atk.begin(rate_per_ms=spec.rate_factor * len(blocks),
                      domain=spec.domain)
        if k == spec.stop_interval and atk.active:
            atk.stop()
        if atk.active:
            self.stat_attack_windows += 1
        return profiling

    def _attack_post(self, k: int) -> None:
        """Profiling probe after the victim's window: accumulate per-cell
        victim activity; pick the attack targets on the last profiling
        interval (most-active cells in the target domain)."""
        spec, atk = self.attack_spec, self.attacker
        idxs = list(range(len(atk._sets())))
        frac = atk.probe(idxs)
        self._attack_activity = (frac if self._attack_activity is None
                                 else self._attack_activity + frac)
        if k == spec.start_interval - 1:
            atk.activity = (self._attack_activity
                            / max(1, spec.profile_intervals))
            atk.choose_targets(k=spec.n_targets, domain=spec.domain)

    def _residency_phases(self) -> Tuple[float, float, float]:
        """Quiet-domain residency of the sensitive task before / during /
        after the attack+defense episode (post-warmup intervals only for
        the pre phase; the episode ends at the defense, or at the attack's
        stop/run end when undefended).  Streamed: intervals classify into
        their phase bucket as they happen
        (`~repro_torch.core.fleetshard.ResidencyPhases`) instead of filtering a
        materialized history at report time."""
        if self._resid is None:
            return (0.0, 0.0, 0.0)
        self._resid.finish(self._defended_at is not None,
                           self._defended_at
                           if self._defended_at is not None else -1)
        return self._resid.means()

    def _note_recovery(self, interval: int,
                       dom_rates: Dict[int, float]) -> None:
        """Close out outstanding events once the *measured* abstraction
        steers correctly again: the per-domain ranking re-identifies the
        polluted domain (all domains measured) and, under CAS, the
        sensitive task sits in a quiet domain."""
        if not self._outstanding or not dom_rates:
            return
        measured_ok = (len(dom_rates) == self.plat.n_domains
                       and max(dom_rates, key=dom_rates.get)
                       == POLLUTED_DOMAIN)
        placed_ok = (self.policy != "cas"
                     or self.vcpu_domain[self._sens.vcpu] != POLLUTED_DOMAIN)
        if measured_ok and placed_ok:
            self._recoveries.extend(interval - ev_interval
                                    for ev_interval, _ in self._outstanding)
            self._outstanding.clear()

    def _recovery_max(self) -> int:
        if not (self.drift_specs or self.stat_defenses):
            return 0
        if self._outstanding:
            return -1            # never re-converged before the run ended
        return int(max(self._recoveries, default=0))

    def _stream_pages(self) -> List[int]:
        if not self.cap_on:
            return list(self.vanilla_order)
        pages = [self.cap.allocate() for _ in range(self.stream_len)]
        return [p for p in pages if p is not None]

    # ----------------------------------------------------------------- loop
    def _noise_per_domain(self) -> np.ndarray:
        # L2-local co-tenants are core-private pressure: their effect
        # reaches the fleet through the *measured* working-set latency
        # (and the measured per-core L2 rates), not the LLC contention
        # term of the IPC model
        out = np.zeros(self.plat.n_domains)
        for wl in self.host.cotenants:
            if (wl.enabled and not wl.name.startswith("fleet:")
                    and not wl.l2_local):
                out[wl.domain] += wl.rate_per_ms
        return out

    def run(self) -> FleetReport:
        """Run the closed loop standalone: drive :meth:`steps`, executing
        each yielded ProbePlan against this sim's own guest.  A matrix
        harness co-executes many sims' plans instead
        (:func:`run_fleet_matrix` lockstep mode)."""
        gen = self.steps()
        try:
            plan = gen.send(None)
            while True:
                plan = gen.send(probeplan.execute(self.vm, plan))
        except StopIteration as e:
            return e.value

    def steps(self):
        """Generator form of the closed loop: yields one ProbePlan per
        probe point — the windowed VSCAN monitoring interval
        (``session.plan()``), the committed working-set + page-cache-stream
        traversal, the timed working-set measurement — and receives each
        plan's PlanResult.  Every sim on one platform yields structurally
        congruent plans in the same order, which is what lets the matrix
        driver batch all guests' per-tick probing into single vectorized
        executions.  With ``use_plans=False`` (or the seed
        ``use_batch=False`` reference) nothing is yielded: the loop runs
        the pre-plan per-dispatch calls inline (parity reference).
        Returns the :class:`FleetReport`."""
        t0 = time.perf_counter()
        plat, vm, tasks = self.plat, self.vm, self.tasks
        vcpus = sorted(self.vcpu_domain)
        scale = 100.0 / plat.llc.n_lines     # accesses/ms -> contention idx

        f32 = dict(dtype=torch.float32, device=self.host.device)
        i32 = dict(dtype=torch.int32, device=self.host.device)
        sens_v = torch.tensor([t.sensitivity for t in tasks], **f32)
        rate_v = torch.tensor([t.llc_rate_per_ms for t in tasks], **f32)
        period_v = torch.tensor([t.duty_period for t in tasks], **i32)
        duty_on_v = torch.tensor([int(round(t.duty_period * t.duty_frac))
                                  for t in tasks], **i32)
        ipc_v = torch.ones(len(tasks), **f32)

        quiet_hits = scored = 0
        work_post = np.zeros(len(tasks))
        # post-warmup interval metrics stream into self.metrics (running
        # sums, O(1) per series; keep_history=True additionally
        # materializes the full series for timeline consumers) — the
        # report means below are sum/n, computed online
        metrics = self.metrics
        for k in range(self.n_intervals):
            # drift scenario: host events land mid-window; repairs run
            # before the probe so this interval measures with a (possibly
            # just-)repaired abstraction
            self._cur_interval = k
            self._schedule_due_events(k)
            self._maybe_repair(k)
            # adversarial scenario: defend on sustained detection, then
            # the attack lifecycle edges (profiling primes, begin/stop)
            self._maybe_defend(k)
            profiling = self._attack_pre(k)
            # act (from last interval's decision): route each workload's
            # traffic into its current domain
            for task in tasks:
                self.host.retarget_cotenant(f"fleet:{task.name}",
                                            domain=self.vcpu_domain[task.vcpu])
            if self.harvest_mode is not None:
                # the SMT-sibling thrasher is co-scheduled with the
                # sensitive task: it follows its core (one interval behind
                # placement, like a real sibling pair).  Only that core is
                # excluded a priori — it hosts known L2-local pressure;
                # every other core's L2 stands or falls by its measured
                # rate (fleet tasks are LLC-rate workloads whose cores'
                # private L2s are exactly the idle capacity to harvest)
                sens_core = int(vm.vcpu_cores[self._sens.vcpu])
                self.host.retarget_cotenant(
                    "l2_thrasher", core=sens_core,
                    domain=sens_core // plat.cores_per_domain)
                # also exclude the probe's own home cores: the windowed
                # LLC monitor primes stream through those cores' L2s every
                # tick, so anything promoted there is evicted within one
                # window — and the monitors can't see it, because the
                # prime traffic refreshes its own lines (those cores
                # measure quiet).  Structural knowledge only the probing
                # layer has, so the fleet feeds it to the tier.
                mon_cores = {int(vm.vcpu_cores[v])
                             for vs in self.domain_vcpus.values()
                             for v in vs}
                self.harvest_tier.exclude_cores = tuple(sorted(
                    {sens_core} | mon_cores))
            # probe + decide: one windowed Prime+Probe interval over every
            # domain; the published ContentionView drives the subscribed
            # CAS tiers and CAP ranking (decision stack never polls VScan)
            seq_only = k in self._seq_only_intervals
            if self._plan_route:
                mplan = self.session.plan()
                if seq_only:
                    mplan.meta["seq_only"] = True
                view = self.session.apply(mplan, (yield mplan))
            else:
                view = self.session.refresh()
            dom_rates = view.per_domain
            if profiling:
                self._attack_post(k)
            # act: policy placement (wakeup order randomized per interval)
            free = set(vcpus)
            for ti in self.rng.permutation(len(tasks)):
                task = tasks[ti]
                v = policy_place(self.policy, sorted(free), self.vcpu_domain,
                                 self.tt.tier, task.vcpu, rr_index=int(ti))
                task.vcpu = v
                free.discard(v)
            # act: this interval's page-cache stream through the real caches
            stream = self._stream_pages()
            stream_lines = np.array([vm.gva(p, off)
                                     for p in stream for off in (0, 64)])
            # harvest decision: route the working set's traversal (and its
            # timed measurement) to the tier's quietest granted L2 — the
            # probe→decide→act edge of the harvest loop.  harvest="off"
            # keeps the sensitive task's own (thrashed) core.
            ws_vcpu = self._sens.vcpu
            if self.harvest_on and self.harvest_tier.granted:
                hc = int(self.harvest_tier.granted[0])
                ws_vcpu = next((v for v, c in enumerate(vm.vcpu_cores)
                                if int(c) == hc), ws_vcpu)
                self.stat_harvest_intervals += 1
            # measure: the working set's latency (batched timed lanes;
            # uncommitted measurement probe).  Harvest scenarios measure
            # *residually* — before this interval's re-traversal, so the
            # latency reflects what survived the co-tenant window in the
            # L2 — everything else keeps the after-the-stream order.
            if self._plan_route:
                meta = {"seq_only": True} if seq_only else {}
                traverse = ProbePlan(
                    ops=(Commit(segments=(
                        Segment(gvas=self.ws_lines, vcpu=ws_vcpu),
                        Segment(gvas=stream_lines,
                                vcpu=self._streamer.vcpu))),),
                    label="fleet.traverse", hints=self.lowering,
                    meta=dict(meta))
                ws_lat = ProbePlan(
                    ops=(WarmTimer(),
                         Measure(lanes=(self.ws_lines,),
                                 vcpus=(ws_vcpu,))),
                    label="fleet.ws_lat", hints=self.lowering,
                    meta=dict(meta))
                if self.harvest_mode is not None:
                    lres = yield ws_lat
                    lat = float(np.mean(lres.last[0]))
                    yield traverse
                else:
                    yield traverse
                    lres = yield ws_lat
                    lat = float(np.mean(lres.last[0]))
            else:
                if self.harvest_mode is not None:
                    vm.warm_timer()
                    lat = float(np.mean(vm.timed_access_batch(
                        [self.ws_lines], vcpu=[ws_vcpu])[0]))
                    vm.access(self.ws_lines, vcpu=ws_vcpu)
                    vm.access(stream_lines, vcpu=self._streamer.vcpu)
                else:
                    vm.access(self.ws_lines, vcpu=ws_vcpu)
                    vm.access(stream_lines, vcpu=self._streamer.vcpu)
                    vm.warm_timer()
                    lat = float(np.mean(vm.timed_access_batch(
                        [self.ws_lines], vcpu=[ws_vcpu])[0]))
            if self.harvest_tier is not None:
                # heat feed: the working set is the hot page-cache set the
                # tier ranks promotion candidates from
                for p in self.ws_pages:
                    self.cap.touch(p)
            if self.cap_on:
                self.cap.reclaim_all()   # interval end: page cache dropped
                #                          under memory pressure (mechanism
                #                          only — not a recolor event)
            # measure: vectorized per-tick progress + contention accounting
            slow_v = torch.tensor([1.0 + t.mem_frac * max(0.0, lat - LAT_L2)
                                   / LAT_L2 for t in tasks], **f32)
            dom_idx = torch.tensor([self.vcpu_domain[t.vcpu] for t in tasks],
                                   **i32)
            prog, cont = fleet_interval_progress(
                dom_idx, rate_v, period_v, duty_on_v, sens_v, ipc_v, slow_v,
                torch.tensor(self._noise_per_domain(), **f32), scale,
                n_domains=plat.n_domains, ticks=self.ticks)
            prog = prog.cpu().numpy()
            for t_, p in zip(tasks, prog):
                t_.done_work += float(p)
            self._note_recovery(k, dom_rates)
            in_quiet = int(self.vcpu_domain[self._sens.vcpu]
                           != POLLUTED_DOMAIN)
            if self._resid is not None:
                self._resid.add(k, float(in_quiet),
                                defended=self._defended_at is not None,
                                defended_at=self._defended_at
                                if self._defended_at is not None else -1)
            if k >= self.warmup:
                scored += 1
                # any unpolluted domain counts as quiet (>2-domain views)
                quiet_hits += in_quiet
                work_post += prog
                metrics.add("ws_lat", lat)
                metrics.add("hot_rate", dom_rates.get(POLLUTED_DOMAIN, 0.0))
                metrics.add("quiet_rate",
                            _mean([v for d, v in dom_rates.items()
                                   if d != POLLUTED_DOMAIN]))
                if self.harvest_mode is not None and view.l2_cores:
                    sc = int(vm.vcpu_cores[self._sens.vcpu])
                    metrics.add("l2_hot_rate", view.l2_cores.get(sc, 0.0))
                    if self.harvest_tier.granted:
                        metrics.add("l2_quiet_rate", view.l2_cores.get(
                            int(self.harvest_tier.granted[0]), 0.0))
                if self.serving is not None:
                    # serving loop outcome edge: this interval's requests
                    # run at the ground-truth contention of whatever
                    # domain the (measurement-fed) router picked
                    self.serving.step(cont.cpu().numpy())

        wall = time.perf_counter() - t0
        return FleetReport(
            platform=self.plat.name, policy=self.policy,
            cap="on" if self.cap_on else "off", seed=self.seed,
            n_intervals=self.n_intervals, warmup=self.warmup,
            throughput=float(work_post.sum()),
            per_workload={t.name: float(w)
                          for t, w in zip(tasks, work_post)},
            quiet_residency=quiet_hits / max(1, scored),
            hot_rate=metrics.mean("hot_rate"),
            quiet_rate=metrics.mean("quiet_rate"),
            tiers=dict(self.tt.tier),
            ws_lat_cycles=metrics.mean("ws_lat"),
            recolor_events=self.cap.stats.recolor_events,
            reclaims=self.cap.stats.reclaims,
            cap_allocated=self.cap.stats.allocated,
            dispatches=vm.stat_passes,
            accesses=vm.stat_accesses,
            wall_s=wall,
            drift_events=self.stat_drift_events,
            repairs=self.stat_repairs,
            repair_dispatches=self.stat_repair_dispatches,
            recovery_max_intervals=self._recovery_max(),
            attack_windows=self.stat_attack_windows,
            attack_detected=self._detect_interval >= 0,
            attack_detect_intervals=self._detect_interval,
            defenses=self.stat_defenses,
            false_drift=self.stat_false_drift,
            residency_pre=(resid := self._residency_phases())[0],
            residency_during=resid[1],
            residency_post=resid[2],
            harvest=self.harvest_mode or "none",
            harvest_intervals=self.stat_harvest_intervals,
            harvest_grants=(self.harvest_tier.stats.core_grants
                            if self.harvest_tier else 0),
            harvest_revocations=(self.harvest_tier.stats.core_revocations
                                 if self.harvest_tier else 0),
            harvest_promotions=(self.harvest_tier.stats.promotions
                                if self.harvest_tier else 0),
            l2_hot_rate=metrics.mean("l2_hot_rate"),
            l2_quiet_rate=metrics.mean("l2_quiet_rate"),
            guests_per_sec=1.0 / max(wall, 1e-9),
            serve_requests=self.serving.requests if self.serving else 0,
            serve_p50_ms=self.serving.p50.value() if self.serving else 0.0,
            serve_p99_ms=self.serving.p99.value() if self.serving else 0.0,
        )


def run_fleet(platform: Union[str, CachePlatform], policy: str = "cas",
              cap: str = "on", device=None, **kw) -> FleetReport:
    """Run one closed-loop fleet scenario end to end (``device``: see
    :class:`FleetSim`)."""
    return FleetSim(platform, policy=policy, cap=cap, device=device,
                    **kw).run()


def _run_lockstep(sims: List[FleetSim]) -> List[FleetReport]:
    """Advance co-running sims' :meth:`FleetSim.steps` generators in
    lockstep: at each step the sims' yielded (structurally congruent)
    ProbePlans execute as ONE vectorized program over all guests
    (`probeplan.execute_many`) — one dispatch per probe point per tick for
    the whole fleet, instead of one per guest.  Per-guest results, and
    therefore every report metric, are bit-identical to running each sim
    alone (each guest keeps its own host state, rng and TSC noise).

    Rounds whose plans are tagged ``meta["seq_only"]`` (intervals where a
    geometry-changing drift event can land mid-window — see
    ``DriftSpec.geometry_preserving``) execute per guest instead: a
    cat/migrate event firing inside one guest's Wait would change that
    guest's machine geometry mid-program, and a multi-guest dispatch
    needs one shared geometry.  All sims run the same drift schedule, so
    geometries re-converge by the next round and lockstep resumes."""
    t0 = time.perf_counter()
    gens = {i: sim.steps() for i, sim in enumerate(sims)}
    reports: List[Optional[FleetReport]] = [None] * len(sims)
    pending: Dict[int, ProbePlan] = {}
    for i, gen in gens.items():
        try:
            pending[i] = gen.send(None)
        except StopIteration as e:
            reports[i] = e.value
    while pending:
        order = sorted(pending)
        if any(pending[i].meta.get("seq_only") for i in order):
            results = [probeplan.execute(sims[i].vm, pending[i])
                       for i in order]
        else:
            results = probeplan.execute_many([sims[i].vm for i in order],
                                             [pending[i] for i in order])
        nxt: Dict[int, ProbePlan] = {}
        for i, res in zip(order, results):
            try:
                nxt[i] = gens[i].send(res)
            except StopIteration as e:
                reports[i] = e.value
        pending = nxt
    # fleet-level throughput: the cohort finished together, so every
    # guest's rate is the shared n/wall (per-guest wall_s stays the
    # per-generator number for latency-style reporting)
    gps = len(sims) / max(time.perf_counter() - t0, 1e-9)
    for r in reports:
        if r is not None:
            r.guests_per_sec = gps
    return reports


def run_fleet_matrix(platforms: Optional[List[str]] = None,
                     combos: Sequence[Tuple[str, str]] = DEFAULT_COMBOS,
                     seeds: Sequence[int] = (0,),
                     lockstep: bool = True,
                     tune: bool = False, device=None,
                     **kw) -> List[FleetReport]:
    """The policy x platform x seed sweep behind Fig 10 / Tables 7-8: every
    (platform, policy, cap, seed) combination through the full closed loop.
    Every sim of a platform boots on ``device`` (one cohort shares one
    device); results feed :func:`fig10_summary` and
    :func:`speedup_summary`.

    ``lockstep`` (default) co-executes each platform's combo x seed guests
    through :func:`_run_lockstep`: all guests' per-tick VSCAN monitoring
    (and the other per-interval probes) batch into one vectorized plan
    execution, cutting physical probe dispatches by ~the guest count while
    reproducing the sequential reports bit for bit.  Falls back to
    sequential runs when plans are disabled or the platform's lowering
    hints forbid lockstep (non-LRU replacement); drift scenarios keep
    lockstep, dropping to per-guest execution only for the intervals
    where a geometry-changing event can land (see :func:`_run_lockstep`).

    ``tune=True`` runs the measured lowering autotuner per platform
    (`FleetSim.tune`; the first sim pays the cutout timing, the rest hit
    the tune cache) and runs the sweep under the tuned lowering — which
    may legitimately differ from the hinted one, including disabling
    lockstep where the model says vectorized-over-guests dispatch does
    not pay on the measuring machine."""
    from repro_torch.core.platforms import list_platforms
    names = platforms if platforms is not None else list_platforms()
    reports: List[FleetReport] = []
    for n in names:
        sims = [FleetSim(n, policy=pol, cap=cap, seed=s, device=device, **kw)
                for pol, cap in combos for s in seeds]
        if tune:
            for sim in sims:
                sim.tune(n_guests=len(sims))
        hints = sims[0].lowering or probeplan.DEFAULT_LOWERING
        if (lockstep and len(sims) > 1 and hints.lockstep
                and all(s.use_plans and s.use_batch for s in sims)):
            reports.extend(_run_lockstep(sims))
        else:
            reports.extend(sim.run() for sim in sims)
    return reports


@dataclasses.dataclass
class FleetScaleResult:
    """Outcome of one :class:`ShardedFleet` run (``--only scale``'s
    headline row): how the fleet was carved (shard size / shard count /
    device count), where the wall went (boot vs run), and the fleet
    throughput ``guests_per_sec = n_guests / wall_s`` — the scaling-curve
    metric BENCH.csv records per (platform, n_guests)."""

    platform: str
    n_guests: int
    shard_size: Optional[int]
    n_shards: int
    n_devices: int
    boot_s: float
    run_s: float
    wall_s: float
    guests_per_sec: float
    reports: List[FleetReport]


class ShardedFleet:
    """Rack-scale fleet execution: N-hundred co-running guests on one
    platform, sublinear wall in guest count.

    Three mechanisms stack (this is the ROADMAP's
    hundreds-to-thousands-of-guests item; Com-CAS / Sprabery-style fleet
    density for the closed loop):

      * **O(1)-per-guest construction** — the first guest (the donor)
        attaches and probes normally; every other guest boots the same
        host seed and imports the donor's exported abstraction
        (`CacheXSession.import_` + the donor's page pool), so colors,
        monitored sets and free lists arrive with *zero* probing.
        Per-guest diversity comes from ``sim_seed`` (placement wakeup
        order, serving arrivals), not from re-probing identical hosts.
      * **Sharded lockstep dispatch** — all guests advance through
        :func:`_run_lockstep`, and `~repro_torch.core.fleetshard.choose_shard`
        threads a ``shard_size`` through every plan's lowering: each
        probe point dispatches as ``ceil(n/S)`` reused-shape ``(S, ...)``
        stacked kernels instead of one fresh ``(n, ...)`` compile per
        fleet size (and instead of ``n`` per-guest dispatches), with
        ``ScaleSpec.max_guests_per_dispatch`` capping per-dispatch
        padding memory.  Results stay bit-identical at any shard size.
      * **Device mapping** — `~repro_torch.core.fleetshard.device_groups`
        deals contiguous shard runs to the visible CUDA cards; each
        group's guests boot on their card (the donor on the first) and
        its lockstep cohort runs there.  With one card, or on the CPU,
        this is one group, shards back-to-back.  The shard choice that
        places the guests is made once the donor has booted, and
        :meth:`run` reuses it from the shard cache.

    Guest loop sizing defaults to the platform's
    :class:`~repro_torch.core.platforms.ScaleSpec` profile (fewer, shorter
    intervals than the 4-guest paper sweeps — scale runs chart
    throughput curves, not drift timelines); any ``FleetSim`` kwarg
    overrides it.  Memory stays O(guests): guests default to streaming
    metrics (``keep_history=False``) and the per-dispatch footprint is
    bounded by the shard size, not the fleet size."""

    def __init__(self, platform: Union[str, CachePlatform], n_guests: int,
                 policy: str = "cas", cap: str = "on", seed: int = 0,
                 serving: bool = False, serving_placement: bool = True,
                 keep_history: bool = False,
                 shard_size: Optional[int] = None, device=None, **kw):
        if n_guests < 1:
            raise ValueError("n_guests must be >= 1")
        plat0 = get_platform(platform) if isinstance(platform, str) \
            else platform
        spec = plat0.scale
        loop = dict(n_intervals=spec.n_intervals, warmup=spec.warmup,
                    stream_len=spec.stream_len, ws_pages=spec.ws_pages)
        loop.update(kw)
        guest_kw = dict(policy=policy, cap=cap, seed=seed,
                        keep_history=keep_history, serving=serving,
                        serving_placement=serving_placement, **loop)
        self.n_guests = int(n_guests)
        self.shard_size = shard_size          # None = auto (choose_shard)
        self.device = device
        t0 = time.perf_counter()
        donor = FleetSim(plat0, sim_seed=seed,
                         device=fleetshard._group_device(0, device),
                         **guest_kw)
        self.sims = [donor]
        if self.n_guests > 1:
            snapshot = donor.session.export()
            pool = donor.pool_pages
            groups = device_groups(self.n_guests,
                                   self._choice(donor).shard_size, device)
            for index, sl in groups:
                dev = fleetshard._group_device(index, device)
                self.sims.extend(
                    FleetSim(plat0, sim_seed=seed + i,
                             session_import=snapshot, page_pool=pool,
                             device=dev, **guest_kw)
                    for i in range(max(1, sl.start), sl.stop))
        self.boot_s = time.perf_counter() - t0
        self.plat = donor.plat

    def _choice(self, donor: FleetSim):
        choice = choose_shard(donor.plat, donor.session.plan(),
                              n_guests=self.n_guests)
        if self.shard_size is not None:       # explicit override
            choice = dataclasses.replace(
                choice, shard_size=self.shard_size,
                n_shards=len(shard_slices(self.n_guests, self.shard_size)),
                lowering=dataclasses.replace(choice.lowering,
                                             shard_size=self.shard_size))
        return choice

    def run(self) -> FleetScaleResult:
        t0 = time.perf_counter()
        choice = self._choice(self.sims[0])
        reports: List[FleetReport] = []
        groups = device_groups(self.n_guests, choice.shard_size, self.device)
        if not choice.lowering.lockstep or self.n_guests == 1:
            # non-LRU lowerings cannot stack guests (same rule as
            # run_fleet_matrix): sequential per-guest execution
            reports = [sim.run() for sim in self.sims]
        else:
            for sim in self.sims:
                sim.install_lowering(choice.lowering)
            for index, sl in groups:
                with on_device(index, self.device):
                    reports.extend(_run_lockstep(self.sims[sl]))
        run_s = time.perf_counter() - t0
        wall = self.boot_s + run_s
        gps = self.n_guests / max(wall, 1e-9)
        for r in reports:
            r.guests_per_sec = gps            # end-to-end fleet rate
        return FleetScaleResult(
            platform=self.plat.name, n_guests=self.n_guests,
            shard_size=choice.shard_size, n_shards=choice.n_shards,
            n_devices=len(groups), boot_s=self.boot_s, run_s=run_s,
            wall_s=wall, guests_per_sec=gps, reports=reports)


def _mean(vals: List[float]) -> float:
    return float(np.mean(vals)) if vals else float("nan")


def fig10_summary(reports: List[FleetReport],
                  threshold: float = 0.5) -> Dict:
    """Reduce a matrix sweep to the Fig 10 claim: per platform, the mean
    quiet-domain residency of the cache-sensitive task under each policy
    (CAP-on runs), plus the count of platforms where CAS steers it to the
    quiet domain (residency >= threshold) while EEVDF does not."""
    res: Dict[str, Dict[str, float]] = {}
    for plat in sorted({r.platform for r in reports}):
        res[plat] = {pol: _mean([r.quiet_residency for r in reports
                                 if r.platform == plat and r.policy == pol
                                 and r.cap == "on"])
                     for pol in FLEET_POLICIES}
    n = len(res)
    cas_ok = sum(1 for v in res.values() if v.get("cas", 0) >= threshold)
    eevdf_ok = sum(1 for v in res.values() if v.get("eevdf", 1) < threshold)
    both = sum(1 for v in res.values()
               if v.get("cas", 0) >= threshold
               and v.get("eevdf", 1) < threshold)
    return {"residency": res, "n_platforms": n, "cas_quiet": cas_ok,
            "eevdf_pinned": eevdf_ok, "separated": both}


def harvest_summary(reports: List[FleetReport]) -> Dict:
    """Harvest-on-vs-off deltas per platform (CAS + CAP runs of the L2
    harvest scenario): measured residual working-set latency with the
    harvest routing vs without, the latency improvement, and the
    throughput delta — the L2-tier companion of
    :func:`speedup_summary`'s ``cap_on_vs_off``."""
    out: Dict[str, Dict[str, float]] = {}
    for plat in sorted({r.platform for r in reports}):
        def pick(h, field):
            return _mean([getattr(r, field) for r in reports
                          if r.platform == plat and r.harvest == h])
        lat_on, lat_off = pick("on", "ws_lat_cycles"), pick("off", "ws_lat_cycles")
        row = {"ws_lat_on": lat_on, "ws_lat_off": lat_off,
               "lat_improvement": lat_off / lat_on - 1.0,
               "throughput_delta": (pick("on", "throughput")
                                    / pick("off", "throughput") - 1.0),
               "harvest_intervals": pick("on", "harvest_intervals"),
               "l2_hot_rate": pick("on", "l2_hot_rate"),
               "l2_quiet_rate": pick("on", "l2_quiet_rate")}
        out[plat] = {k: float(v) for k, v in row.items()}
    return out


def speedup_summary(reports: List[FleetReport]) -> Dict:
    """Table 7/8-style deltas per platform: CAS throughput vs each baseline
    (CAP on), and CAP-on vs CAP-off under CAS."""
    out: Dict[str, Dict[str, float]] = {}
    for plat in sorted({r.platform for r in reports}):
        def thr(pol, cap):
            return _mean([r.throughput for r in reports
                          if r.platform == plat and r.policy == pol
                          and r.cap == cap])
        cas_on = thr("cas", "on")
        row = {"cas_vs_eevdf": cas_on / thr("eevdf", "on") - 1.0,
               "cas_vs_rusty": cas_on / thr("rusty", "on") - 1.0,
               "cap_on_vs_off": cas_on / thr("cas", "off") - 1.0}
        out[plat] = {k: float(v) for k, v in row.items()}
    return out
