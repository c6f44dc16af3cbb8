"""Multi-level cache hierarchy model (L2 + LLC) behind per-level probing.

The probing stack was LLC-only until PR 8: ``CachePlatform.l2`` existed as
a passive color-filter parameter, and everything two-level — directory
back-invalidation noise, the milan_ccx repair aliasing, the reliability of
L2 color filters under CAT — was hand-waved where it leaked through.  This
module makes the hierarchy first-class:

  * :class:`HierarchySpec` — the two-level model (inclusion variant +
    per-level geometry), derivable from any object carrying ``l2`` /
    ``llc`` / ``inclusion`` (:class:`~repro_torch.core.cachesim.MachineGeometry`,
    :class:`~repro_torch.core.platforms.CachePlatform`).
  * Inclusion consequences as named predicates the rest of the stack keys
    off instead of re-deriving ad hoc:
    :meth:`~HierarchySpec.back_invalidates` (does evicting an LLC /
    directory entry invalidate L2 copies — Yan et al.'s inclusive-directory
    effect), :func:`directory_aliasing` (can a *pool of L2-congruent
    lines* evict lines of other L2 sets through a shared directory set —
    the milan_ccx case: an LLC with fewer sets than the L2), and
    :func:`l2_filter_reliable` (is L2 color filtering free of
    back-invalidation false positives — what
    ``CachePlatform.l2_filter_reliable`` now derives from).
  * Per-level **attribution**: classify probe latencies into residency
    levels (:func:`attribute_levels`, codes shared with the
    :func:`~repro_torch.core.cachesim.resident_level` oracle), probe a VM's
    lines one uncommitted lane each (:func:`attribute_residency`), and
    score the probe against hypercall ground truth
    (:func:`attribution_accuracy` — §6.2 validation only, never a
    decision input).
  * **Harvest** helpers for CAP's L2 tier (Jalili & Erez, "Harvesting L2
    Caches in Server Processors"): rank L2 page colors quietest-first
    from measured per-color eviction rates (:func:`quiet_l2_colors`) so
    the allocator can steer hot page-cache pages into idle private-L2
    capacity and retreat when a co-tenant wakes up.

Guest/host boundary: everything here except the two ``attribution_*``
hypercall consumers is computable from guest-discoverable quantities —
per-level associativity (`VEV.probe_associativity`), color counts (VCOL),
and measured eviction rates (VSCAN).  The :meth:`HierarchySpec.of`
constructor reads them off the platform/geometry object for convenience,
exactly like ``ways`` and ``n_l2_colors`` are threaded everywhere else.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Sequence

import numpy as np

from repro_torch.core.cachesim import (CacheGeometry, L2_MISS_THRESHOLD, LAT_L2,
                                       LAT_LLC, LLC_MISS_THRESHOLD,
                                       BLOCKS_PER_PAGE)

#: Inclusion variants a :class:`~repro_torch.core.cachesim.MachineGeometry` /
#: :class:`~repro_torch.core.platforms.CachePlatform` may declare.
INCLUSIVE = "inclusive"
NON_INCLUSIVE = "non_inclusive"
INCLUSION_KINDS = (INCLUSIVE, NON_INCLUSIVE)

#: Probe-able cache levels, inner to outer.
LEVELS = ("l2", "llc")

#: Residency codes shared with :func:`repro_torch.core.cachesim.resident_level`
#: and ``GuestVM.hypercall_resident_level``: 2 = private L2, 3 = LLC,
#: 0 = neither (DRAM).
LEVEL_CODES = {"l2": 2, "llc": 3, "dram": 0}


def miss_threshold(level: str) -> int:
    """Latency threshold separating a hit at ``level`` from an eviction
    (the ``L2_MISS_THRESHOLD`` / ``LLC_MISS_THRESHOLD`` split, centralized
    so every per-level consumer keys off the level name)."""
    if level == "l2":
        return L2_MISS_THRESHOLD
    if level == "llc":
        return LLC_MISS_THRESHOLD
    raise ValueError(f"unknown cache level {level!r}")


def hit_latency(level: str) -> int:
    """Nominal hit latency at ``level`` (cycles)."""
    if level == "l2":
        return LAT_L2
    if level == "llc":
        return LAT_LLC
    raise ValueError(f"unknown cache level {level!r}")


@dataclasses.dataclass(frozen=True)
class HierarchySpec:
    """The two-level hierarchy model of one machine/platform.

    Frozen and hashable; build one with :meth:`of` from anything carrying
    ``l2`` / ``llc`` / ``inclusion`` attributes.
    """

    inclusion: str
    l2: CacheGeometry
    llc: CacheGeometry

    def __post_init__(self):
        if self.inclusion not in INCLUSION_KINDS:
            raise ValueError(f"unknown inclusion {self.inclusion!r}; "
                             f"expected one of {INCLUSION_KINDS}")

    @classmethod
    def of(cls, obj) -> "HierarchySpec":
        """Derive the spec from a ``MachineGeometry`` or ``CachePlatform``
        (duck-typed: anything with ``l2``, ``llc`` and ``inclusion``)."""
        return cls(inclusion=getattr(obj, "inclusion", INCLUSIVE),
                   l2=obj.l2, llc=obj.llc)

    def geometry(self, level: str) -> CacheGeometry:
        if level == "l2":
            return self.l2
        if level == "llc":
            return self.llc
        raise ValueError(f"unknown cache level {level!r}")

    @property
    def back_invalidates(self) -> bool:
        """Does evicting an LLC/directory entry invalidate the line from
        the domain's private L2s?  True exactly on inclusive hierarchies
        (the gate around cachesim's back-invalidation block)."""
        return self.inclusion == INCLUSIVE

    @property
    def n_l2_colors(self) -> int:
        """L2 page colors (HPA bits above the page offset indexing L2
        sets) — the granularity of the CAP harvest tier's free lists."""
        return max(1, self.l2.n_sets // BLOCKS_PER_PAGE)

    def directory_aliasing(self, level: str) -> bool:
        """Can a pool of lines congruent at ``level`` evict lines of
        *other* sets of that level through the shared directory?

        Only an L2-level pool can: when the hierarchy back-invalidates
        and the LLC exposes fewer set indices than the L2, several L2
        sets (page colors differing in the bits the LLC drops) share one
        directory row — a big single-color pool over-fills that row and
        back-invalidates L2-non-congruent lines, so an L2 eviction test
        reads false congruence.  This is the physical effect the
        milan_ccx repair fallback used to fake before the hierarchy was
        modelled (LLC 128 sets < L2 256 sets)."""
        return (level == "l2" and self.back_invalidates
                and self.llc.n_sets < self.l2.n_sets)

    @property
    def filter_reliable(self) -> bool:
        """Whether L2 color filtering is free of back-invalidation false
        positives — see :func:`l2_filter_reliable`."""
        return (not self.back_invalidates
                or self.llc.n_ways >= self.l2.n_ways)


def l2_filter_reliable(inclusion: str, l2: CacheGeometry,
                       llc: CacheGeometry) -> bool:
    """Derive ``CachePlatform.l2_filter_reliable`` from the hierarchy.

    On an inclusive hierarchy, a guest-effective LLC associativity below
    the L2's (a small CAT allocation) means an L2-sized working set
    already overflows its directory set: directory evictions
    back-invalidate L2 lines mid-filter, and L2 eviction tests acquire
    systematic false positives.  A non-inclusive hierarchy never
    back-invalidates, so the filter stays reliable at any allocation."""
    return HierarchySpec(inclusion, l2, llc).filter_reliable


def directory_aliasing(obj, level: str) -> bool:
    """Module-level convenience for :meth:`HierarchySpec.directory_aliasing`
    (``obj`` is any geometry/platform carrying ``l2``/``llc``/
    ``inclusion``)."""
    return HierarchySpec.of(obj).directory_aliasing(level)


# ---------------------------------------------------------------------------
# per-level attribution
# ---------------------------------------------------------------------------

def attribute_levels(lats: np.ndarray) -> np.ndarray:
    """Classify probe latencies into residency levels.

    Returns :data:`LEVEL_CODES` codes per latency: ``<= L2 threshold`` →
    2 (L2-resident), ``<= LLC threshold`` → 3 (LLC-resident), else → 0
    (DRAM) — directly comparable to the
    :func:`~repro_torch.core.cachesim.resident_level` oracle and the
    ``hypercall_resident_level`` validation hypercall."""
    lats = np.asarray(lats)
    return np.where(lats <= L2_MISS_THRESHOLD, LEVEL_CODES["l2"],
                    np.where(lats <= LLC_MISS_THRESHOLD,
                             LEVEL_CODES["llc"], LEVEL_CODES["dram"]))


def attribute_residency(vm, gvas: Sequence[int], vcpu: int = 0) -> np.ndarray:
    """Probe where each line currently resides, without disturbing it.

    One single-access *uncommitted* measurement lane per line (each lane
    runs against a snapshot of machine state, so probing line ``i`` can
    never evict line ``j`` before it is measured), latencies classified
    by :func:`attribute_levels`.  Purely guest-side — the hypercall-free
    attribution the ground-truth tests validate."""
    gvas = [int(g) for g in gvas]
    if not gvas:
        return np.zeros(0, np.int64)
    vm.warm_timer()
    lanes = [np.asarray([g], np.int64) for g in gvas]
    lats = vm.timed_access_batch(lanes, vcpu=[vcpu] * len(lanes),
                                 lane_bucket=1, batch_bucket=1)
    return attribute_levels(np.asarray([int(l[0]) for l in lats]))


def attribution_accuracy(vm, gvas: Sequence[int], vcpu: int = 0) -> float:
    """Fraction of lines whose probed residency level matches the
    ``hypercall_resident_level`` ground truth (§6.2 validation — tests,
    benchmarks and reports only, never a decision input)."""
    gvas = [int(g) for g in gvas]
    if not gvas:
        return 1.0
    probed = attribute_residency(vm, gvas, vcpu=vcpu)
    truth = np.asarray([vm.hypercall_resident_level(g, vcpu=vcpu)
                        for g in gvas])
    return float(np.mean(probed == truth))


# ---------------------------------------------------------------------------
# harvest (quiet private-L2 capacity discovery for CAP's L2 tier)
# ---------------------------------------------------------------------------

def quiet_l2_colors(per_l2_color_rate: Mapping[int, float],
                    threshold: float) -> List[int]:
    """L2 page colors measured quiet enough to harvest, quietest first.

    ``per_l2_color_rate`` is VSCAN's per-color L2 eviction-rate dict
    (%-lines/ms EWMA over L2-level monitored sets); a color at or below
    ``threshold`` holds idle private-L2 capacity the CAP harvest tier may
    promote hot page-cache pages into.  Unmeasured colors are *not*
    returned — no measurement, no harvest (the conservative twin of
    CAP's coldest-known-last allocation order)."""
    return sorted((c for c, r in per_l2_color_rate.items()
                   if r <= threshold),
                  key=lambda c: (per_l2_color_rate[c], c))


def harvest_cores(l2_core_rate: Mapping[int, float], threshold: float,
                  exclude: Sequence[int] = ()) -> List[int]:
    """Cores whose private L2 is measured quiet (rate ≤ ``threshold``),
    quietest first, excluding ``exclude`` (e.g. the cores the guest's own
    hot tasks run on).  The per-core companion of
    :func:`quiet_l2_colors`: on dedicated platforms "quiet" means the
    guest's own idle cores; on shared platforms it means the co-tenant
    sharing that core's L2 has gone quiet."""
    ex = set(int(c) for c in exclude)
    return sorted((int(c) for c, r in l2_core_rate.items()
                   if r <= threshold and int(c) not in ex),
                  key=lambda c: (l2_core_rate[c], c))
