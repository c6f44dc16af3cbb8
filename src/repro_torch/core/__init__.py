"""CacheX core on PyTorch + CUDA: the port of `repro.core`.

The same module names and the same session-first public surface as the
JAX package (every name here is also in `repro.core.__all__`):

  cachesim     bit-exact L2 + sliced/directory LLC simulator; the engine
               behind its four entry points is `csrc/cachesim_engine.cu`
               on the card and plain PyTorch / Python on the CPU
  host_model   SimHost (hypervisor ground truth, drift timeline, the
               machine state on its device) / GuestVM (the guest surface)
  platforms    CachePlatform registry: the scenario matrix
  probeplan    ProbePlan IR + its executor
  plancost     the analytic plan cost model (`plan_cost`) + the measured
               lowering autotuner (`tune_lowering`), with cost constants
               measured for the CUDA engine
  hierarchy    the two-level L2+LLC model and per-level attribution
  eviction     VEV (§3.1)      color   VCOL (§3.2)
  vtop         vCPU -> LLC-domain inference by transfer latency
  vscan        VSCAN (§3.3)    shield  CacheShield attack detection
  attacker     AttackerGuest — an adversarial co-tenant running windowed
               Prime+Probe / Evict+Time through its own CacheXSession
  backend      the probe-backend seam (the ``llc`` backend)
  abstraction  CacheXSession — the probed abstraction as a query API
  cas / cap    CAS tiers and placement (§4.1) / CAP colored allocation
               (§4.2)
  runner       run_cachex: the one-shot pipeline report
  fleet        the closed-loop CAS/CAP fleet (Fig 10 / Tables 7-8 via
               `run_fleet_matrix`) and rack-scale `ShardedFleet`
  fleetshard   shard sizing (`choose_shard`), CUDA device groups and the
               fleet's streaming metrics
"""

from repro_torch.core.abstraction import (CacheXSession, ColorsView,
                                          ContentionView, ProbeConfig,
                                          RepairReport,
                                          StaleAbstractionError,
                                          TopologyView, VSCAN_POOL_CAP_PAGES)
from repro_torch.core.backend import (LLCBackend, ProbeBackend, ProbeTarget,
                                      backend_for_format, get_backend,
                                      list_backends, register_backend)
from repro_torch.core.cap import (CapAllocator, CapStats, HarvestStats,
                                  L2HarvestTier)
from repro_torch.core.cas import (TierTracker, allow_pull, policy_place,
                                  select_vcpu)
from repro_torch.core.color import VCOL, ColorFilters, color_accuracy
from repro_torch.core.eviction import VEV, EvictionSet
from repro_torch.core.fleet import (FleetReport, FleetScaleResult, FleetSim,
                                    FleetWorkload, ServingGuest,
                                    ShardedFleet, fig10_summary,
                                    harvest_summary, run_fleet,
                                    run_fleet_matrix, speedup_summary)
from repro_torch.core.fleetshard import (EWMA, FleetMetrics, P2Quantile,
                                         RingWindow, ShardChoice,
                                         StreamingMean, choose_shard,
                                         clear_shard_cache, device_groups)
from repro_torch.core.hierarchy import (HierarchySpec, attribute_levels,
                                        attribute_residency,
                                        attribution_accuracy,
                                        directory_aliasing,
                                        l2_filter_reliable, quiet_l2_colors)
from repro_torch.core.host_model import (CotenantWorkload, GuestVM,
                                         HostEvent, SimHost,
                                         probe_dispatch_count)
from repro_torch.core.plancost import (PlanCost, TuneReport,
                                       clear_tune_cache, plan_cost,
                                       tune_lowering)
from repro_torch.core.attacker import (AttackerGuest, AttackObservation,
                                       AttackReport, attack_gen)
from repro_torch.core.platforms import (AttackSpec, CachePlatform, DriftSpec,
                                        ScaleSpec, all_platforms,
                                        get_platform, list_platforms,
                                        register_platform)
from repro_torch.core.shield import (AttackSignal, CacheShield,
                                     WindowVerdict, classify_trace)
from repro_torch.core.probeplan import PlanLowering, PlanResult, ProbePlan
from repro_torch.core.runner import (CacheXReport, dataclass_csv_header,
                                     dataclass_csv_row, run_cachex,
                                     run_matrix)
from repro_torch.core.vscan import (DriftSignal, MonitoredSet, VScan,
                                    theoretical_coverage)

__all__ = [
    "AttackObservation",
    "AttackReport",
    "AttackSignal",
    "AttackSpec",
    "AttackerGuest",
    "CachePlatform",
    "CacheShield",
    "CacheXReport",
    "CacheXSession",
    "CapAllocator",
    "CapStats",
    "ColorFilters",
    "ColorsView",
    "ContentionView",
    "CotenantWorkload",
    "DriftSignal",
    "DriftSpec",
    "EWMA",
    "EvictionSet",
    "FleetMetrics",
    "FleetReport",
    "FleetScaleResult",
    "FleetSim",
    "FleetWorkload",
    "GuestVM",
    "HarvestStats",
    "HierarchySpec",
    "HostEvent",
    "L2HarvestTier",
    "LLCBackend",
    "MonitoredSet",
    "P2Quantile",
    "PlanCost",
    "PlanLowering",
    "PlanResult",
    "ProbeBackend",
    "ProbeConfig",
    "ProbePlan",
    "ProbeTarget",
    "RepairReport",
    "RingWindow",
    "ScaleSpec",
    "ServingGuest",
    "ShardChoice",
    "ShardedFleet",
    "SimHost",
    "StaleAbstractionError",
    "StreamingMean",
    "TierTracker",
    "TopologyView",
    "TuneReport",
    "VCOL",
    "VEV",
    "VSCAN_POOL_CAP_PAGES",
    "VScan",
    "WindowVerdict",
    "all_platforms",
    "allow_pull",
    "attack_gen",
    "attribute_levels",
    "attribute_residency",
    "attribution_accuracy",
    "backend_for_format",
    "choose_shard",
    "classify_trace",
    "clear_shard_cache",
    "clear_tune_cache",
    "color_accuracy",
    "dataclass_csv_header",
    "dataclass_csv_row",
    "device_groups",
    "directory_aliasing",
    "fig10_summary",
    "get_backend",
    "get_platform",
    "harvest_summary",
    "l2_filter_reliable",
    "list_backends",
    "list_platforms",
    "plan_cost",
    "policy_place",
    "probe_dispatch_count",
    "quiet_l2_colors",
    "register_backend",
    "register_platform",
    "run_cachex",
    "run_fleet",
    "run_fleet_matrix",
    "run_matrix",
    "select_vcpu",
    "speedup_summary",
    "theoretical_coverage",
    "tune_lowering",
]
