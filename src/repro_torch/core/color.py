"""VCOL — virtual page-color identification (paper §3.2).

Although HPA color bits are hidden from the VM, pages can be grouped by
testing which minimal L2 eviction set ("color filter") evicts them.  Each
group gets a *virtual color* — sufficient for page-coloring optimizations.

Implements:
  * color-filter construction: all minimal L2 eviction sets at page offset
    0x0 (up to 2^(color bits) filters; 16 on the paper's Skylake-SP),
  * filter replication to distinct aligned page offsets (a filter shifted
    within its pages keeps its color, since color bits sit above the page
    offset),
  * **parallel color filtering**: one fused pass tests a page against all
    filters simultaneously — page lines at every offset are accessed first,
    all (offset-shifted) filters are primed, then the page lines are probed;
    exactly the line whose offset matches the page's color filter has been
    evicted.  We additionally batch multiple pages per pass (pages do not
    interfere: a page line only shares an L2 set with the filter of its own
    color at that offset),
  * colored free-page lists (consumed by CAP, §4.2).

LLC color filters are *infeasible* (paper §3.2): slice bits are
uncontrollable, so two minimal LLC eviction sets at one offset may share a
color but live in different slices.  `test_color.py` demonstrates this
failure mode against the simulator.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.cachesim import L2_MISS_THRESHOLD, PAGE_BITS
from repro_torch.core.eviction import VEV, EvictionSet
from repro_torch.core.host_model import GuestVM
from repro_torch.core import probeplan
from repro_torch.core.probeplan import Measure, ProbePlan, Vote


def replicate_filter(es: EvictionSet, offset: int) -> np.ndarray:
    """Shift a color filter's lines to another aligned page offset.
    Offset must have GVA bits [5:0] == 0 (aligned, paper §3.1)."""
    assert offset % 64 == 0 and 0 <= offset < (1 << PAGE_BITS)
    page_base = (es.gvas >> PAGE_BITS) << PAGE_BITS
    return page_base | offset


@dataclasses.dataclass
class ColorFilters:
    """The VM's set of color filters and the virtual-color namespace."""

    filters: List[EvictionSet]          # index == virtual color id
    offsets: np.ndarray                 # offset assigned to each filter

    @property
    def n_colors(self) -> int:
        return len(self.filters)

    def state_dict(self) -> Dict:
        """JSON-serializable form (`CacheXSession` export contract)."""
        return {"offsets": [int(o) for o in self.offsets],
                "filters": [es.state_dict() for es in self.filters]}

    @classmethod
    def from_state(cls, state: Dict) -> "ColorFilters":
        return cls(filters=[EvictionSet.from_state(s)
                            for s in state["filters"]],
                   offsets=np.asarray(state["offsets"], np.int64))


class VCOL:
    def __init__(self, vm: GuestVM, vev: Optional[VEV] = None, vcpu: int = 0):
        self.vm = vm
        self.vev = vev or VEV(vm, vcpu=vcpu)
        self.vcpu = vcpu
        self.free_lists: Dict[int, List[int]] = {}
        # guest pages backing the last build_color_filters pool — a drift
        # repair that rebuilds the filters frees them back to the allocator
        self.pool_pages: np.ndarray = np.empty(0, np.int64)

    # -- filter construction (paper §3.2 "Constructing Color Filters") --------
    def build_color_filters(self, n_colors: int, ways: int,
                            scale: int = 3, seed: int = 0) -> ColorFilters:
        pool = self.vev.make_pool(offset=0, ways=ways,
                                  n_uncontrollable_rows=n_colors,
                                  n_slices=1, scale=scale)
        self.pool_pages = np.asarray(pool, np.int64) >> PAGE_BITS
        sets = self.vev.build_for_offset(0, pool, ways=ways, level="l2",
                                         max_sets=n_colors, seed=seed)
        # Replicate each filter to its own aligned page offset so that all
        # filters can be tested in parallel without interference (§3.2).
        # Spares shift with their filter (color bits sit above the page
        # offset, so a shifted spare keeps its verified congruence).
        offsets = np.arange(len(sets), dtype=np.int64) * 64
        filters = []
        for es, off in zip(sets, offsets):
            shifted = EvictionSet(gvas=replicate_filter(es, int(off)),
                                  offset=int(off), level="l2")
            if len(es.spares):
                spare_pages = (es.spares >> PAGE_BITS) << PAGE_BITS
                shifted.spares = spare_pages | int(off)
            filters.append(shifted)
        return ColorFilters(filters=filters, offsets=offsets)

    # -- color identification ---------------------------------------------------
    def identify_color_sequential(self, cf: ColorFilters, page: int) -> int:
        """Test the page against filters one by one (worst case all of them —
        the baseline that motivates parallel filtering)."""
        for color, es in enumerate(cf.filters):
            line = self.vm.gva(page, es.offset)
            if self.vev.evicts(line, es.gvas, "l2"):
                return color
        return -1

    def identify_colors_parallel(self, cf: ColorFilters,
                                 pages: Sequence[int],
                                 batch: int = 16) -> np.ndarray:
        """Parallel color filtering (§3.2), batched over pages.

        Per page (one lane / one chunk position):
          [page lines at every filter offset]  (install)
          [all filters' lines]                 (prime — evicts matching lines)
          [page lines again, timed]            (probe)

        With the batched probe engine (``vev.use_batch``, the default) every
        page becomes one lane of a single fused multi-set Prime+Probe
        dispatch — emitted as a one-op Measure ProbePlan (or the pre-plan
        direct batched call when ``vev.use_plans`` is off); the legacy path
        issues one fused stream per ``batch`` pages (the seed Table 4 path).
        """
        pages = np.asarray(pages, np.int64)
        n_colors = cf.n_colors
        out = np.full(len(pages), -1, np.int64)
        filter_lines = np.concatenate([es.gvas for es in cf.filters])
        if self.vev.use_batch and len(pages):
            # one lane per `batch`-page chunk (pages in a chunk share the
            # filter prime, exactly like the seed fused stream); all chunks
            # ride a single dispatch
            lanes = []
            spans = []
            for s in range(0, len(pages), batch):
                chunk = pages[s:s + batch]
                flat = np.array(
                    [self.vm.gva(int(p), int(off)) for p in chunk
                     for off in cf.offsets], np.int64)   # (len(chunk)*colors)
                lanes.append(np.concatenate([flat, filter_lines, flat]))
                spans.append((s, len(chunk), len(flat)))
            if self.vev.use_plans:
                plan = ProbePlan(
                    ops=(Measure(lanes=tuple(lanes),
                                 vcpus=(self.vcpu,) * len(lanes)),),
                    label="vcol.identify", hints=self.vev.lowering)
                lat_lanes = probeplan.execute(self.vm, plan).last
            else:
                lat_lanes = self.vm.timed_access_batch(lanes, vcpu=self.vcpu)
            for (s, n, flen), lats in zip(spans, lat_lanes):
                probe = lats[flen + len(filter_lines):].reshape(n, n_colors)
                evicted = probe > L2_MISS_THRESHOLD
                out[s:s + n] = np.argmax(probe, axis=1)
                bad = evicted.sum(axis=1) != 1
                for i in np.nonzero(bad)[0]:
                    out[s + i] = self.identify_color_sequential(
                        cf, int(pages[s + i]))
            return out
        for s in range(0, len(pages), batch):
            chunk = pages[s:s + batch]
            page_lines = np.stack(
                [[self.vm.gva(int(p), int(off)) for off in cf.offsets]
                 for p in chunk])                       # (B, n_colors)
            flat = page_lines.reshape(-1)
            stream = np.concatenate([flat, filter_lines, flat])
            lats = self.vm.timed_access(stream, vcpu=self.vcpu)
            probe = lats[len(flat) + len(filter_lines):].reshape(len(chunk),
                                                                 n_colors)
            evicted = probe > L2_MISS_THRESHOLD
            # exactly one line per page should be evicted; noise -> argmax
            out[s:s + len(chunk)] = np.argmax(probe, axis=1)
            # (argmax of latency == the evicted offset; ties impossible in
            #  the quiet case, majority re-test handles noisy cases)
            bad = evicted.sum(axis=1) != 1
            for i in np.nonzero(bad)[0]:
                out[s + i] = self.identify_color_sequential(cf, int(chunk[i]))
        return out

    # -- drift revalidation (recolor only what broke) ---------------------------
    def validate_page_colors(self, cf: ColorFilters, pages: Sequence[int],
                             colors: Sequence[int]) -> np.ndarray:
        """Check previously identified virtual colors in ONE fused round.

        Per page, one Prime+Probe lane against *its recorded color's
        filter only*: ``[page line @ filter offset, filter lines, page
        line]`` — the line is evicted iff the page still shares that
        filter's L2 set, i.e. its GPA→HPA backing did not drift.  Returns
        one bool per page (True = color still valid).  This is what makes
        drift recovery cheap on the VCOL axis: a full re-identification
        tests every page against *every* filter, while revalidation is one
        lane per page, and only the pages that fail are re-identified
        (`CacheXSession.repair`).  Pages recorded as uncolorable (-1) are
        reported invalid and go through full re-identification.
        """
        pages = np.asarray(pages, np.int64)
        colors = np.asarray(colors, np.int64)
        ok = np.zeros(len(pages), bool)
        idx = [i for i in range(len(pages)) if 0 <= colors[i] < cf.n_colors]
        if not idx:
            return ok
        tests = []
        for i in idx:
            es = cf.filters[int(colors[i])]
            tests.append((self.vm.gva(int(pages[i]), es.offset), es.gvas))
        if self.vev.use_batch:
            from repro_torch.core.eviction import _probe_lanes
            lanes = _probe_lanes(tests, self.vev.prime_reps)
            if self.vev.use_plans:
                plan = ProbePlan(
                    ops=(Vote(lanes=tuple(lanes),
                              vcpus=(self.vcpu,) * len(lanes),
                              threshold=L2_MISS_THRESHOLD,
                              votes=self.vev.votes),),
                    label="vcol.validate", hints=self.vev.lowering)
                verdicts = probeplan.execute(self.vm, plan).last
            else:
                from repro_torch.core.eviction import _majority_verdicts
                verdicts = _majority_verdicts(self.vm, lanes, self.vcpu,
                                              L2_MISS_THRESHOLD,
                                              self.vev.votes)
        else:
            verdicts = [self.vev.evicts(t, c, "l2") for t, c in tests]
        ok[np.asarray(idx, int)] = np.asarray(verdicts, bool)
        return ok

    # -- colored free lists (consumed by CAP) -----------------------------------
    def build_free_lists(self, cf: ColorFilters, pages: Sequence[int],
                         batch: int = 16) -> Dict[int, List[int]]:
        colors = self.identify_colors_parallel(cf, pages, batch=batch)
        lists: Dict[int, List[int]] = {c: [] for c in range(cf.n_colors)}
        for p, c in zip(pages, colors):
            if int(c) >= 0:
                lists[int(c)].append(int(p))
        self.free_lists = lists
        return lists


# -- validation helpers (hypercall-based, tests/benchmarks only) ---------------

def color_accuracy(vm: GuestVM, pages: Sequence[int], virtual: np.ndarray,
                   n_colors: int) -> float:
    """Fraction of pages whose virtual color is consistent with the true
    HPA color, up to the (unknowable) label permutation."""
    true = np.array([vm.hypercall_hpa_page(int(p)) % n_colors for p in pages])
    # majority-vote label mapping virtual -> true
    ok = 0
    for v in np.unique(virtual):
        mask = virtual == v
        vals, counts = np.unique(true[mask], return_counts=True)
        ok += counts.max()
    return ok / len(pages)


def gpa_color_spread(vm: GuestVM, pages: Sequence[int],
                     n_colors: int) -> Dict[int, np.ndarray]:
    """For each GPA-derived color, the histogram of true HPA-derived colors
    (paper Fig 3b: fragmentation spreads one GPA color over many HPA
    colors)."""
    out: Dict[int, np.ndarray] = {}
    for p in pages:
        g = int(p) % n_colors
        h = vm.hypercall_hpa_page(int(p)) % n_colors
        out.setdefault(g, np.zeros(n_colors, np.int64))[h] += 1
    return out
