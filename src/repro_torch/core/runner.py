"""run_cachex — end-to-end CacheX pipeline against any registered platform.

One call attaches a :class:`~repro_torch.core.abstraction.CacheXSession` to a
freshly booted scenario and executes the full paper pipeline — VEV
(eviction sets + associativity detection), VCOL (virtual colors), VSCAN
(windowed Prime+Probe monitoring), CAS (contention tiers) and CAP (colored
page-cache allocation) — then reports per-scenario success metrics.  The
point (paper §1) is that the *same guest-side code* succeeds across the
whole provisioning matrix without being told which scenario it landed on;
the report quantifies that per platform.

`run_cachex` is a thin report-builder: all probing goes through the
session's query API (`topology()` / `colors()` / `refresh()`), and the CAS
/ CAP stages consume `subscribe()`d contention updates.  Success metrics
mirror the paper's validation methodology (§6.2): the guest-side results
are checked against host ground truth through the validation hypercalls
only (`CacheXSession.validate`).

Reports serialize as headered machine-readable CSV straight from
``dataclasses.fields`` (:func:`dataclass_csv_header` /
:func:`dataclass_csv_row`), so benchmark columns cannot drift from the
dataclass.
"""

from __future__ import annotations

import csv
import dataclasses
import io
import json
import time
from typing import Dict, List, Optional, Tuple, Union

import numpy as np

from repro_torch.core.abstraction import CacheXSession, ProbeConfig
from repro_torch.core.cap import CapAllocator
from repro_torch.core.cas import TierTracker
from repro_torch.core.host_model import CotenantWorkload, GuestVM, SimHost, \
    polluter_gen
from repro_torch.core.platforms import CachePlatform, get_platform


# ---------------------------------------------------------------------------
# dataclass -> CSV (headered, machine-readable; columns == fields)
# ---------------------------------------------------------------------------

def _csv_cell(value) -> str:
    """One CSV cell: dicts/lists as canonical JSON, None empty."""
    if value is None:
        return ""
    if isinstance(value, (dict, list, tuple)):
        return json.dumps(value, sort_keys=True)
    if isinstance(value, float):
        return f"{value:.6g}"
    return str(value)


def dataclass_csv_header(cls) -> str:
    """CSV header straight from ``dataclasses.fields`` — the column set
    cannot drift from the report dataclass."""
    return ",".join(f.name for f in dataclasses.fields(cls))


def dataclass_csv_row(obj) -> str:
    """One properly quoted CSV row, field order == header order."""
    buf = io.StringIO()
    csv.writer(buf, lineterminator="").writerow(
        [_csv_cell(getattr(obj, f.name))
         for f in dataclasses.fields(obj)])
    return buf.getvalue()


@dataclasses.dataclass
class CacheXReport:
    """Per-scenario result of one :func:`run_cachex` execution.

    Every column of the benchmark CSV comes from a field here (via
    :func:`dataclass_csv_header`/:func:`dataclass_csv_row`), so units are
    documented per field (docs/EXPERIMENTS.md maps fields to paper tables).
    """

    platform: str                 # CachePlatform.name (registry key)
    provisioning: str             # dedicated | cat | slice | shared
    # VEV (paper §3.1, Tables 2-3)
    vev_target_sets: int          # minimal eviction sets requested
    vev_built_sets: int           # sets the construction pipeline returned
    vev_verified_sets: int        # hypercall-validated: every line congruent
    #                               in ONE (set, slice) and |set| == ways
    vev_success_rate: float       # verified / target, in [0, 1] (Table 2 %)
    detected_ways: Optional[int]  # probed associativity; equals the CAT
    #                               allocation under way-partitioning (Table 3)
    # VCOL (paper §3.2, Table 4)
    n_colors: int                 # virtual colors built (L2 page colors)
    vcol_accuracy: float          # fraction of pages whose virtual color is
    #                               consistent with host truth up to label
    #                               permutation, in [0, 1] (§6.2's "100%")
    # VSCAN (paper §3.3) — rates are % of a monitored set's lines evicted
    # per millisecond of wait window (EWMA-smoothed), averaged over sets
    vscan_sets: int               # monitored sets built (f per partition)
    vscan_idle_rate: float        # %-lines/ms with co-tenants quiesced
    vscan_contended_rate: float   # %-lines/ms under the platform noise + a
    #                               polluter burst (must exceed idle)
    # CAS / CAP (paper §4)
    cas_tiers: Dict[int, int]     # committed tier per LLC domain after the
    #                               contention phase (0 = least contended)
    cap_allocated: int            # page-cache pages served from colored lists
    cap_rollovers: int            # times allocation moved to the next color
    # cost accounting (hardware-independent work measures)
    dispatches: int               # engine probe dispatches issued by the VM:
    #                               each untimed/timed/batched access-stream
    #                               call counts 1 (GuestVM.stat_passes)
    accesses: int                 # simulated memory accesses issued
    #                               (GuestVM.stat_accesses)
    wall_s: float                 # host wall-clock seconds for the scenario

    @classmethod
    def csv_header(cls) -> str:
        """Headered-CSV contract: columns are exactly the fields above."""
        return dataclass_csv_header(cls)

    def csv_row(self) -> str:
        return dataclass_csv_row(self)


# ---------------------------------------------------------------------------
# the one-shot driver
# ---------------------------------------------------------------------------
# (The PR-3 `build_color_stage`/`build_vscan_stage` DeprecationWarning shims
# are gone — docs/MIGRATION.md maps the old stage drivers to session
# queries and, since the ProbePlan redesign, to plan()/execute().)

def run_cachex(platform: Union[str, CachePlatform],
               seed: Optional[int] = None,
               use_batch: Optional[bool] = None, monitor_intervals: int = 3,
               config: Optional[ProbeConfig] = None,
               host_vm: Optional[Tuple[SimHost, GuestVM]] = None,
               tune: bool = False, device=None) -> CacheXReport:
    """Execute VEV -> VCOL -> VSCAN -> CAS/CAP against one scenario.

    All probing routes through one :class:`CacheXSession`; this function
    only sequences the experiment (quiesce / burst phases) and builds the
    hypercall-validated report.  ``config`` overrides the platform-default
    :class:`ProbeConfig`; explicitly passed ``seed``/``use_batch``
    arguments take precedence over it (left unset they default to the
    config's values, i.e. seed 0 / batched).  ``host_vm`` reuses an
    already-booted pair instead of booting a fresh scenario: the host is
    left clean (the measurement burst this driver attaches is removed
    again, co-tenant enabled states are restored) and the report's cost
    counters are deltas for this run only.  ``tune=True`` replaces the
    platform's hinted plan lowering with the autotuner's choice for the
    session's monitoring plan before any monitoring runs
    (``CacheXSession.tuned_lowering``; model-only — no cutout timing).
    ``device`` holds the freshly booted machine's state (None: the CUDA
    card; ``"cpu"`` runs the plain engine)."""
    plat = get_platform(platform) if isinstance(platform, str) else platform
    cfg = config if config is not None else ProbeConfig.for_platform(plat)
    overrides = {}
    if seed is not None:
        overrides["seed"] = seed
    if use_batch is not None:
        overrides["use_batch"] = use_batch
    if overrides:
        cfg = cfg.replace(**overrides)
    host, vm = (host_vm if host_vm is not None
                else plat.make_host_vm(seed=cfg.seed, device=device))
    passes0, accesses0 = vm.stat_passes, vm.stat_accesses
    cotenant_enabled = {wl.name: wl.enabled for wl in host.cotenants}
    session = CacheXSession.attach(vm, plat, cfg)
    if tune:
        session.tuned_lowering()
    t0 = time.perf_counter()

    # ---- VCOL: color filters + virtual-color accuracy (§3.2) --------------
    colors = session.colors()
    check_pages = vm.alloc_pages(16 * max(1, colors.n_colors))
    colors.colors_of(check_pages)
    vcol_acc = (session.validate(pages=check_pages)["vcol_accuracy"]
                if colors.n_colors else 0.0)

    # ---- VEV: minimal LLC eviction sets + associativity (§3.1) ------------
    topo = session.topology()
    vev_check = session.validate(pages=[])

    # ---- VSCAN: windowed Prime+Probe monitoring (§3.3) --------------------
    session.monitored_sets()         # build the monitor before quiescing
    for wl in host.cotenants:        # quiesce for the idle baseline
        wl.enabled = False
    idle = np.mean([session.refresh().mean_rate
                    for _ in range(monitor_intervals)])
    for wl in host.cotenants:        # platform noise back on (as the caller
        #                              had it), plus a burst
        wl.enabled = cotenant_enabled.get(wl.name, True)
    host.add_cotenant(CotenantWorkload("runner_burst", 0, 150.0,
                                       polluter_gen(region_pages=2048)))
    contended = np.mean([session.refresh().mean_rate
                         for _ in range(monitor_intervals)])

    # ---- CAS: per-domain contention tiers (§4.1) --------------------------
    tt = TierTracker(keys=list(topo.domain_vcpus), thresholds=[0.5, 4.0])
    cas_sub = session.subscribe(tt.on_contention)
    for _ in range(3):
        session.refresh()
    session.unsubscribe(cas_sub)
    # the burst was a measurement phase, not platform noise: remove it so
    # the CAP stage (and any later reuse of this host) sees the platform's
    # own baseline again
    host.remove_cotenant("runner_burst")

    # ---- CAP: colored page-cache allocation (§4.2) ------------------------
    free_pages = vm.alloc_pages(32 * max(1, colors.n_colors))
    cap = CapAllocator(colors.build_free_lists(free_pages))
    cap.update_contention(session.contention(max_age_ms=float("inf"))
                          .per_color or
                          {c: 0.0 for c in range(colors.n_colors)})
    allocated = sum(cap.allocate() is not None
                    for _ in range(16 * max(1, colors.n_colors)))

    return CacheXReport(
        platform=plat.name,
        provisioning=plat.provisioning,
        vev_target_sets=topo.vev_target_sets,
        vev_built_sets=topo.vev_built_sets,
        vev_verified_sets=vev_check["vev_verified"],
        vev_success_rate=vev_check["vev_verified"] / max(
            1, topo.vev_target_sets),
        detected_ways=topo.detected_associativity,
        n_colors=colors.n_colors,
        vcol_accuracy=vcol_acc,
        vscan_sets=len(session.monitored_sets()),
        vscan_idle_rate=float(idle),
        vscan_contended_rate=float(contended),
        cas_tiers=dict(tt.tier),
        cap_allocated=int(allocated),
        cap_rollovers=cap.stats.color_rollovers,
        dispatches=vm.stat_passes - passes0,
        accesses=vm.stat_accesses - accesses0,
        wall_s=time.perf_counter() - t0,
    )


def run_matrix(platforms: Optional[List[str]] = None, seed: int = 0,
               use_batch: bool = True, device=None) -> List[CacheXReport]:
    """run_cachex across the whole registry (or a named subset)."""
    from repro_torch.core.platforms import list_platforms
    names = platforms if platforms is not None else list_platforms()
    return [run_cachex(n, seed=seed, use_batch=use_batch, device=device)
            for n in names]
