"""CAP — virtual-color-aware page-cache management (paper §4.2).

SRM-Buffer-style page-cache coloring driven by CacheX's virtual colors and
VSCAN's per-color contention:

  * page-cache allocations are served from VCOL's colored free-page lists,
    one color at a time (proceeding to the next color when the current one
    is exhausted, instead of constraining allocatable memory to one fixed
    color — the paper's refinement of SRM-Buffer),
  * colors are *ranked hottest-first* by per-color eviction rate, steering
    low-temporal-locality page-cache traffic into the LLC zones already
    being thrashed by co-located VMs, so it absorbs inter-VM interference
    that would otherwise evict high-locality workload data,
  * allocated pages are pinned ("non-movable") so their color stays valid,
  * adaptive recoloring: when the previously-hottest color has been
    out-ranked by a new hottest color for **three consecutive monitoring
    intervals**, all file-backed page-cache pages are reclaimed so that
    subsequent allocations land in the now-hotter zone.

PR 8 adds a second, *inner* tier on top of the LLC coloring:
:class:`L2HarvestTier` probes for quiet private-L2 capacity (the guest's
own idle cores, or cores whose co-tenant sharing the L2 has gone quiet —
VSCAN's per-core L2 eviction rates from ``ContentionView.l2_cores``) and
promotes the *hottest* page-cache pages into it, per-L2-color so the
promoted set never self-conflicts.  Where the LLC tier steers
low-locality traffic into already-thrashed zones, the harvest tier does
the dual: it moves the highest-locality pages into idle inner capacity,
and retreats the moment the measured rate says the capacity's owner woke
up.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Mapping, Optional, Sequence

import numpy as np

from repro_torch.core import hierarchy
from repro_torch.core.cas import HYSTERESIS_INTERVALS


@dataclasses.dataclass
class CapStats:
    """Counters exposed by :class:`CapAllocator`.

    ``allocated``       pages handed out over the allocator's lifetime.
    ``color_rollovers`` times allocation proceeded to the next color because
                        the current one was exhausted.
    ``recolor_events``  adaptive recolorings: the committed hottest color
                        changed after the 3-interval rule and the page cache
                        was dropped.  Counted by :meth:`CapAllocator.
                        step_interval` (the policy), *not* by
                        :meth:`CapAllocator.reclaim_all` (the mechanism),
                        which also serves plain memory-pressure reclaim.
    ``reclaims``        total :meth:`CapAllocator.reclaim_all` invocations,
                        whatever the reason (recolor or memory pressure).
    ``fallback_allocs`` allocation requests that found every colored list
                        empty (caller falls back to the default allocator).
    """

    allocated: int = 0
    color_rollovers: int = 0
    recolor_events: int = 0
    reclaims: int = 0
    fallback_allocs: int = 0


class CapAllocator:
    """Page-cache page allocator over colored free lists."""

    def __init__(self, free_lists: Dict[int, List[int]],
                 hysteresis: int = HYSTERESIS_INTERVALS,
                 use_contention: bool = True):
        # pop() from the end is cheapest; keep lists as stacks
        self.free_lists = {c: list(p) for c, p in free_lists.items()}
        self.use_contention = use_contention
        self.hysteresis = hysteresis
        self.ranking: List[int] = sorted(self.free_lists)     # hottest first
        self._cursor = 0
        self.committed_hottest: Optional[int] = self.ranking[0] if self.ranking else None
        self._challenger: Optional[int] = None
        self._challenger_count = 0
        self.allocated_pages: List[int] = []   # file-backed, non-movable
        self.page_color: Dict[int, int] = {}
        self.stats = CapStats()
        self.harvest: Optional["L2HarvestTier"] = None

    # -- contention feed (per monitoring interval) ------------------------------
    def update_contention(self, per_color_rate: Dict[int, float]) -> bool:
        """Re-rank colors hottest-first; trigger recoloring per the paper's
        3-interval rule.  Returns True if a recolor event fired."""
        if not self.use_contention or not per_color_rate:
            return False
        self.ranking = sorted(per_color_rate, key=per_color_rate.get,
                              reverse=True)
        hottest = self.ranking[0]
        if hottest == self.committed_hottest:
            self._challenger, self._challenger_count = None, 0
            return False
        if hottest == self._challenger:
            self._challenger_count += 1
        else:
            self._challenger, self._challenger_count = hottest, 1
        if self._challenger_count >= self.hysteresis:
            self.committed_hottest = hottest
            self._challenger, self._challenger_count = None, 0
            self._cursor = 0
            return True
        return False

    # -- allocation --------------------------------------------------------------
    def _order(self) -> List[int]:
        if not self.use_contention:
            return sorted(self.free_lists)
        # committed hottest first, then current ranking order; colors with
        # no contention measurement (e.g. their monitored sets were pruned)
        # go last — coldest-known assumption
        order = [c for c in self.ranking if c in self.free_lists]
        order += sorted(c for c in self.free_lists if c not in order)
        if self.committed_hottest in order:
            order.remove(self.committed_hottest)
            order.insert(0, self.committed_hottest)
        return order

    def allocate(self) -> Optional[int]:
        """Allocate one page-cache page (kernel page-cache miss path)."""
        order = self._order()
        n = len(order)
        for step in range(n):
            color = order[(self._cursor + step) % n]
            lst = self.free_lists.get(color, [])
            if lst:
                if step > 0:
                    self._cursor = (self._cursor + step) % n
                    self.stats.color_rollovers += 1
                page = lst.pop()
                self.allocated_pages.append(page)
                self.page_color[page] = color
                self.stats.allocated += 1
                return page
        self.stats.fallback_allocs += 1
        return None  # caller falls back to the default allocator

    # -- reclaim (recolor event / memory pressure) ---------------------------------
    def reclaim_all(self) -> List[int]:
        """Drop all file-backed page-cache pages back into their colored
        lists.  This is a *mechanism*, invoked both by the paper's adaptive
        recoloring (via :meth:`step_interval`, which is what counts
        ``recolor_events``) and by plain memory-pressure reclaim — so it
        only bumps the reason-agnostic ``reclaims`` counter itself."""
        self.stats.reclaims += 1
        for p in self.allocated_pages:
            self.free_lists.setdefault(self.page_color[p], []).append(p)
        dropped = self.allocated_pages
        self.allocated_pages = []
        if self.harvest is not None:
            self.harvest.forget(dropped)
        return dropped

    def step_interval(self, per_color_rate: Dict[int, float]) -> bool:
        """One monitoring interval: update ranks; reclaim on recolor.  This
        is the only place a reclaim counts as a ``recolor_event``."""
        if self.update_contention(per_color_rate):
            self.stats.recolor_events += 1
            self.reclaim_all()
            return True
        return False

    def rebucket(self, page_color: Dict[int, int]) -> int:
        """Drift-repair hook: re-bucket pages after a recoloring pass
        changed their virtual colors (`CacheXSession.repair`).  Free pages
        move to their new color's list and allocated pages' color tags are
        rewritten (so a later reclaim returns them to the right list);
        allocation statistics and the committed-hottest state are
        untouched.  Returns the number of pages whose color changed."""
        changed = 0
        new_lists: Dict[int, List[int]] = {c: [] for c in self.free_lists}
        for c, lst in self.free_lists.items():
            for p in lst:
                nc = int(page_color.get(p, c))
                changed += int(nc != c)
                new_lists.setdefault(nc, []).append(p)
        self.free_lists = new_lists
        for p, c in list(self.page_color.items()):
            nc = int(page_color.get(p, c))
            changed += int(nc != c)
            self.page_color[p] = nc
        return changed

    def on_contention(self, view) -> bool:
        """`CacheXSession.subscribe` hook: consume one published
        contention update (anything with a ``per_color`` rate dict) as a
        monitoring interval — the page cache sits on the session's
        published abstraction instead of polling VScan.  When an
        :class:`L2HarvestTier` is attached and the view carries per-core
        L2 rates, the tier steps on the same update."""
        recolored = self.step_interval(view.per_color)
        if self.harvest is not None:
            self.harvest.on_contention(view)
        return recolored

    # -- L2 harvest tier ---------------------------------------------------------
    def attach_harvest(self, tier: "L2HarvestTier") -> "L2HarvestTier":
        """Attach the inner tier; it steps on every contention update this
        allocator consumes, and its page heat is fed by :meth:`touch`."""
        self.harvest = tier
        return tier

    def touch(self, page: int, n: int = 1) -> None:
        """Record ``n`` accesses to an allocated page-cache page — the
        heat signal the harvest tier ranks promotion candidates by.  A
        no-op without an attached tier (the LLC tier is heat-oblivious by
        design: it *wants* low-locality traffic)."""
        if self.harvest is not None:
            self.harvest.touch(page, n)


#: Per-core L2 eviction rate (fraction of monitored lines/interval) at or
#: below which a private L2 counts as quiet enough to harvest.
HARVEST_QUIET_THRESHOLD = 0.05


@dataclasses.dataclass
class HarvestStats:
    """Counters exposed by :class:`L2HarvestTier`.

    ``intervals``    monitoring intervals consumed.
    ``promotions``   pages promoted into quiet private-L2 capacity.
    ``demotions``    pages demoted (outranked, or their core revoked).
    ``core_grants``  cores admitted to the harvest set after the
                     hysteresis streak of quiet intervals.
    ``core_revocations`` cores dropped — *immediately*, no hysteresis —
                     when their measured L2 rate crossed the threshold
                     (the owner woke up; retreat beats thrashing them).
    """

    intervals: int = 0
    promotions: int = 0
    demotions: int = 0
    core_grants: int = 0
    core_revocations: int = 0


class L2HarvestTier:
    """Quiet private-L2 capacity prober + hot-page promoter (CAP inner tier).

    Capacity discovery is measurement-driven end to end: a core is only
    harvested after its VSCAN-measured L2 eviction rate has stayed at or
    below ``quiet_threshold`` for ``hysteresis`` consecutive intervals
    (:func:`repro_torch.core.hierarchy.harvest_cores` ranks the candidates),
    and is revoked — instantly, no streak — the first interval the rate
    exceeds ``revoke_threshold`` (default 4x the quiet threshold) or the
    core stops being measured.  The band between the two thresholds is
    deliberate: the harvested load *itself* raises the core's measured
    rate a little (promoted lines displace monitor lines), and a tier
    that revokes at the grant threshold revokes its own footprint; only
    owner-scale pressure crosses the revoke edge.  The retreat stays
    hysteresis-free because a wrong promotion costs the capacity's
    owner.

    Promotion is per-L2-color (``spec.n_l2_colors`` colored budgets of
    ``color_ways`` pages each per core), so the promoted working set is
    spread across L2 sets and never self-conflicts.  The tier only
    *decides* — :meth:`assignments` says which page goes to which core —
    and the fleet/driver acts by routing that page's traffic there."""

    def __init__(self, spec: hierarchy.HierarchySpec,
                 quiet_threshold: float = HARVEST_QUIET_THRESHOLD,
                 hysteresis: int = HYSTERESIS_INTERVALS,
                 exclude_cores: Sequence[int] = (),
                 color_ways: Optional[int] = None,
                 heat_decay: float = 0.5,
                 revoke_threshold: Optional[float] = None):
        self.spec = spec
        self.quiet_threshold = float(quiet_threshold)
        self.revoke_threshold = (4.0 * self.quiet_threshold
                                 if revoke_threshold is None
                                 else float(revoke_threshold))
        self.hysteresis = int(hysteresis)
        self.exclude_cores = tuple(int(c) for c in exclude_cores)
        # pages promotable per (core, color): default half the L2 ways —
        # leave headroom so a waking owner isn't fully cold even before
        # the revoke lands
        self.color_ways = (max(1, spec.l2.n_ways // 2)
                           if color_ways is None else int(color_ways))
        self.heat_decay = float(heat_decay)
        self._quiet_streak: Dict[int, int] = {}
        self.granted: List[int] = []            # committed harvest cores
        self.page_heat: Dict[int, float] = {}   # EWMA touches/interval
        self._touches: Dict[int, float] = {}    # touches this interval
        self.page_l2_color: Dict[int, int] = {}
        self.promoted: Dict[int, int] = {}      # page -> core
        self.stats = HarvestStats()

    # -- heat feed ---------------------------------------------------------------
    def touch(self, page: int, n: int = 1) -> None:
        self._touches[int(page)] = self._touches.get(int(page), 0.0) + n

    def set_page_color(self, page: int, l2_color: int) -> None:
        """Register a page's L2 color (HPA set-index bits above the page
        offset — ``vcol`` knows it for every guest page).  Pages without
        a registered color are assumed color ``page % n_l2_colors``."""
        self.page_l2_color[int(page)] = int(l2_color) % self.spec.n_l2_colors

    def _color_of(self, page: int) -> int:
        return self.page_l2_color.get(int(page),
                                      int(page) % self.spec.n_l2_colors)

    # -- capacity ----------------------------------------------------------------
    def capacity(self) -> int:
        """Promotable pages across the currently-granted cores."""
        return len(self.granted) * self.spec.n_l2_colors * self.color_ways

    def assignments(self) -> Dict[int, List[int]]:
        """Current promotion map: harvest core → promoted pages."""
        out: Dict[int, List[int]] = {c: [] for c in self.granted}
        for p, c in self.promoted.items():
            out.setdefault(c, []).append(p)
        return out

    # -- the per-interval policy -------------------------------------------------
    def _update_cores(self, l2_core_rate: Mapping[int, float]) -> None:
        quiet = set(hierarchy.harvest_cores(l2_core_rate,
                                            self.quiet_threshold,
                                            exclude=self.exclude_cores))
        # revoke instantly: a loud (rate past the revoke edge of the
        # band), excluded, or no-longer-measured core is gone now
        rates = {int(c): float(r) for c, r in l2_core_rate.items()}
        ex = set(int(c) for c in self.exclude_cores)
        for c in list(self.granted):
            if (c not in rates or c in ex
                    or rates[c] > self.revoke_threshold):
                self.granted.remove(c)
                self._quiet_streak.pop(c, None)
                self.stats.core_revocations += 1
        # grant only after a full quiet streak
        for c in sorted(quiet, key=lambda c: (l2_core_rate[c], c)):
            if c in self.granted:
                continue
            self._quiet_streak[c] = self._quiet_streak.get(c, 0) + 1
            if self._quiet_streak[c] >= self.hysteresis:
                self.granted.append(c)
                self.stats.core_grants += 1
        for c in list(self._quiet_streak):
            if c not in quiet:
                del self._quiet_streak[c]

    def _rebalance(self) -> None:
        """Fill each granted core's per-color budgets with the hottest
        registered pages; demote whatever no longer fits."""
        hot = sorted(self.page_heat, key=lambda p: (-self.page_heat[p], p))
        slots: Dict[tuple, int] = {(c, k): self.color_ways
                                   for c in self.granted
                                   for k in range(self.spec.n_l2_colors)}
        target: Dict[int, int] = {}
        for p in hot:
            k = self._color_of(p)
            for c in self.granted:
                if slots.get((c, k), 0) > 0:
                    slots[(c, k)] -= 1
                    target[p] = c
                    break
        for p in list(self.promoted):
            if target.get(p) != self.promoted[p]:
                del self.promoted[p]
                self.stats.demotions += 1
        for p, c in target.items():
            if p not in self.promoted:
                self.promoted[p] = c
                self.stats.promotions += 1

    def step_interval(self, l2_core_rate: Mapping[int, float]) -> Dict[int, List[int]]:
        """One monitoring interval: fold this interval's touches into the
        heat EWMA, update the granted-core set from the measured per-core
        L2 rates, re-fill the promotion map; returns :meth:`assignments`."""
        self.stats.intervals += 1
        d = self.heat_decay
        for p in set(self.page_heat) | set(self._touches):
            self.page_heat[p] = (d * self.page_heat.get(p, 0.0)
                                 + (1.0 - d) * self._touches.get(p, 0.0))
        self._touches = {}
        self._update_cores(l2_core_rate)
        self._rebalance()
        return self.assignments()

    def forget(self, pages: Sequence[int]) -> None:
        """Drop reclaimed pages from heat tracking and the promotion map
        (reclaim-side hook; demotions here are bookkeeping, not policy)."""
        for p in pages:
            p = int(p)
            self.page_heat.pop(p, None)
            self._touches.pop(p, None)
            self.page_l2_color.pop(p, None)
            if self.promoted.pop(p, None) is not None:
                self.stats.demotions += 1

    def on_contention(self, view) -> bool:
        """`CacheXSession.subscribe` hook: consume a published view's
        per-core L2 rates (``ContentionView.l2_cores``) as one interval.
        Returns True if the promotion map changed."""
        rates = getattr(view, "l2_cores", None) or {}
        before = dict(self.promoted)
        self.step_interval(rates)
        return self.promoted != before
