"""CacheX core on PyTorch + CUDA: the port of `repro.core`.

The same module names and the same session-first public surface as the
JAX package, for the part of it that is ported (every name here is also
in `repro.core.__all__`):

  cachesim     bit-exact L2 + sliced/directory LLC simulator; the engine
               behind its four entry points is `csrc/cachesim_engine.cu`
               on the card and a plain PyTorch loop on the CPU
  host_model   SimHost (hypervisor ground truth, drift timeline, the
               machine state on its device) / GuestVM (the guest surface)
  platforms    CachePlatform registry: the scenario matrix
  probeplan    ProbePlan IR + its executor
  plancost     dispatch and padded-work counts of a plan (`plan_cost`)
  hierarchy    the two-level L2+LLC model and per-level attribution
  eviction     VEV (§3.1)      color   VCOL (§3.2)
  vscan        VSCAN (§3.3)    shield  CacheShield attack detection
  backend      the probe-backend seam (the ``llc`` backend)
  abstraction  CacheXSession — the probed abstraction as a query API
  cas / cap    CAS tiers and placement (§4.1) / CAP colored allocation
               (§4.2)
  runner       run_cachex: the one-shot pipeline report

Not ported yet (ROADMAP.md): the fleet simulators (`fleet`,
`fleetshard`), the attacker guest (`attacker`) and the lowering
autotuner (`plancost.tune_lowering`).
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
from repro_torch.core.hierarchy import (HierarchySpec, attribute_levels,
                                        attribute_residency,
                                        attribution_accuracy,
                                        directory_aliasing,
                                        l2_filter_reliable, quiet_l2_colors)
from repro_torch.core.host_model import (CotenantWorkload, GuestVM,
                                         HostEvent, SimHost,
                                         probe_dispatch_count)
from repro_torch.core.plancost import PlanCost, plan_cost
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
    "AttackSignal",
    "AttackSpec",
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
    "EvictionSet",
    "GuestVM",
    "HarvestStats",
    "HierarchySpec",
    "HostEvent",
    "L2HarvestTier",
    "LLCBackend",
    "MonitoredSet",
    "PlanCost",
    "PlanLowering",
    "PlanResult",
    "ProbeBackend",
    "ProbeConfig",
    "ProbePlan",
    "ProbeTarget",
    "RepairReport",
    "ScaleSpec",
    "SimHost",
    "StaleAbstractionError",
    "TierTracker",
    "TopologyView",
    "VCOL",
    "VEV",
    "VSCAN_POOL_CAP_PAGES",
    "VScan",
    "WindowVerdict",
    "all_platforms",
    "allow_pull",
    "attribute_levels",
    "attribute_residency",
    "attribution_accuracy",
    "backend_for_format",
    "classify_trace",
    "color_accuracy",
    "dataclass_csv_header",
    "dataclass_csv_row",
    "directory_aliasing",
    "get_backend",
    "get_platform",
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
    "run_matrix",
    "select_vcpu",
    "theoretical_coverage",
]
