"""Simulated virtualized host: GPA->HPA translation, co-tenants, timers.

This module is the boundary between "what the VM can see" and "host ground
truth".  The probing code in `eviction.py` / `color.py` / `vscan.py` only
ever talks to :class:`GuestVM` — guest-visible addresses, timed accesses,
and simulated wall-clock waits.  Host internals (the page table, the slice
hash, cache-resident ground truth) are reachable only through the
``hypercall_*`` methods, mirroring the custom hypercall the paper adds for
*validation only* (§6.2: "Accuracy is verified via the custom hypercall
exposing GPA-to-HPA mappings").

Timing model.  The guest reads a TSC whose first readings after an idle
period carry large spikes — the guest-TSC instability the paper reports in
§3.1 ("latency spikes even when the target resides in L1/L2 caches ...
caused by unstable guest TSC readings via RDTSC").  `GuestVM.warm_timer()`
performs dummy timer reads, reproducing the paper's mitigation.

Simulated time.  `wait_ms()` advances a virtual clock; registered co-tenant
workloads emit `rate_per_ms` LLC accesses per waited millisecond, which is
how a Prime+Probe wait window observes contention.

Drift.  Host provisioning is *time-varying*: :class:`HostEvent`s scheduled
on the host timeline (:meth:`SimHost.schedule_event`) apply while simulated
time advances — i.e. during a guest's ``wait_ms``, so an event can land in
the middle of a Prime+Probe window.  Event kinds mirror the ways a cloud
silently invalidates a probed abstraction (§2.1/§6.4, Fig 9): ``migrate``
(live migration: full GPA→HPA remap onto a fresh machine, possibly with a
new hidden slice hash), ``cat`` (runtime CAT repartition: the guest's
effective LLC associativity changes), ``remap`` (partial page remapping /
compaction), and ``cotenant`` (co-tenant churn: arrivals, departures,
re-rates).  Every abstraction-invalidating event bumps ``SimHost.epoch``;
the guest has *no* architectural visibility into it — only the validation
hypercall ``hypercall_host_epoch`` (§6.2 boundary) exposes it for
tests/exports, while guest-side detection must come from probing
(`VEV.validate_sets`, `VScan` drift signals).

Device.  The port of `repro.core.host_model`: all host logic stays numpy,
exactly as in the reference, so seeded streams are identical.  The
machine state lives in torch tensors on the host's device (``SimHost(...,
device=None)`` means the CUDA card; the tests pass ``device="cpu"``);
tensors cross to it only at the four engine calls and at the
``hypercall_*`` readers.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import cachesim
from repro_torch.core.cachesim import (BLOCKS_PER_PAGE, LAT_DRAM, MachineGeometry,
                                       PAGE_BITS)

_STREAM_BUCKET = 512  # pad access streams to multiples of this (compile reuse)
_LANE_BUCKET = 128    # pad batched-probe lanes (T) to multiples of this
_BATCH_BUCKET = 8     # pad batched-probe batch dim (B) to multiples of this

# Batched-measurement padding climbs a power-of-two ladder after bucket
# rounding, as in the JAX package (where each distinct (B, T) shape is a
# fresh XLA compile); the port keeps the same padding so its dispatch
# shapes, counts and results match the reference.  Ladder padding is
# exact for measurement lanes:
# they run uncommitted against a state snapshot, each lane's rng forks
# from its own lane index, and padded tail steps only touch padded
# positions — so per-lane results are bit-identical at any padding.
# Committed streams keep plain bucket padding (`_pad_to_bucket`): under
# random replacement the machine rng advances per step, padded steps
# included, so their padding is part of the replayed sequence.

# Physical probe-dispatch accounting: one count per engine access-stream
# call issued on behalf of guest probing (untimed, timed, batched, and the
# multi-guest fused paths).  Co-tenant background traffic (`run_cotenants`)
# is NOT counted — the metric is the cost of *measurement*, the quantity
# the ProbePlan executor exists to minimize (`benchmarks --only plans`).
_DISPATCH_STATS = {"probe_dispatches": 0}


def probe_dispatch_count() -> int:
    """Total physical probe dispatches issued process-wide (all hosts)."""
    return _DISPATCH_STATS["probe_dispatches"]


def _count_probe_dispatch() -> None:
    _DISPATCH_STATS["probe_dispatches"] += 1


def _pad_to_bucket(arr: np.ndarray, fill) -> np.ndarray:
    n = len(arr)
    m = ((n + _STREAM_BUCKET - 1) // _STREAM_BUCKET) * _STREAM_BUCKET
    if m == 0:
        m = _STREAM_BUCKET
    out = np.full(m, fill, dtype=np.int32)
    out[:n] = arr
    return out


def _round_up(n: int, bucket: int) -> int:
    return max(bucket, ((n + bucket - 1) // bucket) * bucket)


def _ladder(n: int) -> int:
    """Next power of two >= n (the compile-shape ladder, see above)."""
    return 1 << (max(1, int(n)) - 1).bit_length()


# `repro_torch.core.plancost`'s process-wide compile-shape cache: every physical
# dispatch notes its (kernel kind, machine geometry, padded shape) so the
# cost model can predict which lowerings hit already-compiled kernels.
# Imported lazily — plancost imports probeplan which imports this module.
_plancost = None


def _note_shape(kind: str, geom, shape) -> None:
    global _plancost
    if _plancost is None:
        from repro_torch.core import plancost as _pc
        _plancost = _pc
    _plancost.SHAPE_CACHE.note(kind, geom, shape)


@dataclasses.dataclass
class CotenantWorkload:
    """A co-located VM generating LLC traffic at `rate_per_ms` accesses/ms.

    By default the traffic issues from its domain's core 0 and — like any
    foreign VM's accesses seen from the guest's perspective — bypasses the
    modelled private L2s (the guest only shares the LLC with it).  Two
    knobs extend that to the two-level hierarchy: ``core`` pins the
    issuing core (a co-tenant vCPU *sharing a specific core* with the
    guest), and ``l2_local=True`` makes the accesses fill that core's
    private L2 — the SMT-sibling / core-sharing tenant whose working set
    thrashes the L2 the harvest tier probes for."""

    name: str
    domain: int
    rate_per_ms: float
    gen: Callable[[np.random.Generator, int], np.ndarray]  # -> block addrs
    enabled: bool = True
    core: Optional[int] = None    # issuing core (None: domain's core 0)
    l2_local: bool = False        # fill the issuing core's private L2


#: Event kinds that invalidate a probed cache abstraction (bump the epoch).
EPOCH_EVENT_KINDS = ("migrate", "cat", "remap")


@dataclasses.dataclass
class HostEvent:
    """One scheduled change of host provisioning (see module docstring).

    ``at_ms``          host-timeline time the event fires (applied while a
                       guest waits across it — events land mid-probe).
    ``kind``           ``migrate`` | ``cat`` | ``remap`` | ``cotenant``.
    ``fraction``       remap: fraction of every guest's pages silently
                       rebacked (migrate always rebacks everything).
    ``new_llc_ways``   cat: the guest-effective LLC associativity after the
                       repartition (machine state re-initializes — a CAT
                       mask change flushes the guest's old allocation).
    ``new_slice_seed`` migrate: the destination machine's hidden slice-hash
                       seed (None keeps the source hash).
    ``add``/``remove``/``retarget``  cotenant churn: attach a workload,
                       detach one by name, or retarget one
                       (``{"name": ..., "domain"/"rate_per_ms"/"enabled"}``).
    ``note``           free-form annotation (benchmarks / event log).
    ``applied_at_ms``  set by the host when the event fires.
    """

    at_ms: float
    kind: str
    fraction: float = 1.0
    new_llc_ways: Optional[int] = None
    new_slice_seed: Optional[int] = None
    add: Optional[CotenantWorkload] = None
    remove: Optional[str] = None
    retarget: Optional[Dict] = None
    note: str = ""
    applied_at_ms: Optional[float] = None


class SimHost:
    """The hypervisor + physical machine."""

    def __init__(self,
                 geom: Optional[MachineGeometry] = None,
                 n_host_pages: int = 1 << 15,
                 seed: int = 0,
                 device=None):
        self.geom = geom or MachineGeometry()
        self.n_host_pages = n_host_pages
        self.rng = np.random.default_rng(seed)
        # machine state device: None is the CUDA card (raises without one)
        self.device = resolve_device(device)
        self.state = cachesim.init_machine(self.geom, self.device)
        self.free_host_pages: List[int] = list(range(n_host_pages))
        self.cotenants: List[CotenantWorkload] = []
        self.time_ms: float = 0.0
        # contiguity: freshly-booted VMs get mostly-contiguous host pages
        self._next_contig = 0
        # -- drift timeline (see module docstring) --------------------------
        # epoch counts abstraction-invalidating provisioning changes
        # (EPOCH_EVENT_KINDS); guests cannot see it architecturally.
        self.epoch: int = 0
        self.pending_events: List[HostEvent] = []   # sorted by at_ms
        self.event_log: List[HostEvent] = []
        self.guests: List["GuestVM"] = []           # registered at boot

    # -- drift timeline -------------------------------------------------------
    def _register_guest(self, vm: "GuestVM") -> None:
        self.guests.append(vm)

    def schedule_event(self, event: HostEvent) -> HostEvent:
        """Queue a provisioning change on the host timeline.  It applies
        when simulated time next advances across ``event.at_ms`` (events in
        the past fire on the very next advance) — i.e. *during* a guest's
        ``wait_ms``, mid-probe."""
        self.pending_events.append(event)
        self.pending_events.sort(key=lambda e: e.at_ms)
        return event

    def schedule_events(self, events: Sequence[HostEvent]) -> None:
        for ev in events:
            self.schedule_event(ev)

    def _guest_page_tables(self) -> List[np.ndarray]:
        """Unique page tables of registered guests (a rebooted guest shares
        its predecessor's backing array — remap it once)."""
        seen: Dict[int, np.ndarray] = {}
        for vm in self.guests:
            seen.setdefault(id(vm._page_table), vm._page_table)
        return list(seen.values())

    def _remap_in_place(self, fraction: float) -> int:
        """Silently reback ``fraction`` of every guest's pages with new host
        pages, in place (cached lines of remapped pages are NOT migrated —
        their old HPAs just stop being accessed, Fig 9)."""
        remapped = 0
        for pt in self._guest_page_tables():
            n = len(pt)
            k = n if fraction >= 1.0 else int(n * fraction)
            if k == 0:
                continue
            victims = self.rng.choice(n, size=k, replace=False)
            pt[victims] = self.rng.integers(0, self.n_host_pages, size=k)
            remapped += k
        return remapped

    def apply_event(self, event: HostEvent) -> None:
        """Apply one provisioning change now (normally called by
        :meth:`advance` at the event's scheduled time)."""
        if event.kind == "migrate":
            # live migration: every guest page lands on a new host page of
            # the destination machine; caches start cold; the destination's
            # hidden slice hash may differ.
            self._remap_in_place(1.0)
            if event.new_slice_seed is not None:
                self.geom = dataclasses.replace(
                    self.geom, slice_seed=int(event.new_slice_seed))
            self.state = cachesim.init_machine(self.geom, self.device)
        elif event.kind == "cat":
            if event.new_llc_ways is None:
                raise ValueError("cat event needs new_llc_ways")
            llc = dataclasses.replace(self.geom.llc,
                                      n_ways=int(event.new_llc_ways))
            self.geom = dataclasses.replace(self.geom, llc=llc)
            # repartitioning rewrites the guest's way mask: its old
            # occupancy is gone, the machine state re-initializes
            self.state = cachesim.init_machine(self.geom, self.device)
        elif event.kind == "remap":
            self._remap_in_place(event.fraction)
        elif event.kind == "cotenant":
            if event.add is not None:
                self.add_cotenant(event.add)
            if event.remove is not None:
                self.remove_cotenant(event.remove)
            if event.retarget is not None:
                kw = dict(event.retarget)
                self.retarget_cotenant(kw.pop("name"), **kw)
        else:
            raise ValueError(f"unknown host event kind {event.kind!r}")
        if event.kind in EPOCH_EVENT_KINDS:
            self.epoch += 1
        event.applied_at_ms = self.time_ms
        self.event_log.append(event)

    def advance(self, ms: float) -> None:
        """Advance the virtual clock by ``ms``: co-tenants emit traffic for
        every sub-span, and scheduled events fire at their timestamps — so
        an event can land in the middle of a probe's wait window, with
        co-tenant traffic correctly split around it."""
        remaining = float(ms)
        while self.pending_events and (self.pending_events[0].at_ms
                                       <= self.time_ms + remaining):
            ev = self.pending_events.pop(0)
            span = max(0.0, ev.at_ms - self.time_ms)
            if span > 0:
                self.time_ms += span
                self.run_cotenants(span)
                remaining -= span
            self.apply_event(ev)
        if remaining > 0:
            self.time_ms += remaining
            self.run_cotenants(remaining)

    # -- memory provisioning ------------------------------------------------
    def provision_pages(self, n: int, mode: str = "contiguous") -> np.ndarray:
        """Back `n` guest pages with host pages.

        mode='contiguous': consecutive host pages (fresh boot, §2.2);
        mode='fragmented': uniformly random free host pages (aged host).
        """
        if mode == "contiguous":
            start = self._next_contig
            pages = np.arange(start, start + n, dtype=np.int64)
            self._next_contig += n
            if self._next_contig > self.n_host_pages:
                raise RuntimeError("host out of contiguous memory")
        elif mode == "fragmented":
            idx = self.rng.choice(len(self.free_host_pages), size=n, replace=False)
            pages = np.array([self.free_host_pages[i] for i in idx], dtype=np.int64)
        else:
            raise ValueError(mode)
        return pages

    def remap_pages(self, page_table: np.ndarray, fraction: float,
                    rng: Optional[np.random.Generator] = None) -> np.ndarray:
        """Hypervisor-side remapping (compaction/ballooning, §2.1/Fig 9):
        silently rebacks a random `fraction` of guest pages with new host
        pages.  Cached lines of remapped pages are *not* migrated (their old
        HPAs simply stop being accessed)."""
        rng = rng or self.rng
        pt = page_table.copy()
        n = len(pt)
        k = int(n * fraction)
        if k == 0:
            return pt
        victims = rng.choice(n, size=k, replace=False)
        pt[victims] = rng.integers(0, self.n_host_pages, size=k)
        return pt

    # -- co-tenants ----------------------------------------------------------
    def add_cotenant(self, wl: CotenantWorkload) -> None:
        self.cotenants.append(wl)

    def cotenant(self, name: str) -> Optional[CotenantWorkload]:
        for wl in self.cotenants:
            if wl.name == name:
                return wl
        return None

    def remove_cotenant(self, name: str) -> CotenantWorkload:
        """Detach a registered traffic source entirely (vs merely disabling
        it).  Measurement-only workloads (e.g. a contention burst) must be
        removed once their phase ends so later phases — and any reuse of
        this host — measure a clean baseline."""
        wl = self.cotenant(name)
        if wl is None:
            raise KeyError(f"no cotenant named {name!r}")
        self.cotenants.remove(wl)
        return wl

    def retarget_cotenant(self, name: str, domain: Optional[int] = None,
                          rate_per_ms: Optional[float] = None,
                          enabled: Optional[bool] = None,
                          core: Optional[int] = None,
                          l2_local: Optional[bool] = None) -> CotenantWorkload:
        """Move/re-rate a registered traffic source.  The fleet simulator
        uses this to route a guest workload's LLC traffic into whichever
        domain the scheduler just placed it on — the *act* edge of the
        probe→decide→act→measure loop.  `core`/`l2_local` re-pin a
        core-sharing tenant (pass core=-1 to clear the pin)."""
        wl = self.cotenant(name)
        if wl is None:
            raise KeyError(f"no cotenant named {name!r}")
        if domain is not None:
            wl.domain = domain
        if rate_per_ms is not None:
            wl.rate_per_ms = rate_per_ms
        if enabled is not None:
            wl.enabled = enabled
        if core is not None:
            wl.core = None if core < 0 else int(core)
        if l2_local is not None:
            wl.l2_local = bool(l2_local)
        return wl

    def _cotenant_stream(self, ms: float
                         ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        blocks: List[np.ndarray] = []
        cores: List[np.ndarray] = []
        l2loc: List[np.ndarray] = []
        for wl in self.cotenants:
            if not wl.enabled:
                continue
            n = int(wl.rate_per_ms * ms)
            if n <= 0:
                continue
            b = wl.gen(self.rng, n).astype(np.int32)
            blocks.append(b)
            # route the workload's LLC traffic into ITS domain (or the
            # exact core it is pinned to)
            core = (wl.core if wl.core is not None
                    else wl.domain * self.geom.cores_per_domain)
            cores.append(np.full(n, core, np.int32))
            l2loc.append(np.full(n, wl.l2_local, bool))
        if not blocks:
            return (np.empty(0, np.int32), np.empty(0, np.int32),
                    np.empty(0, bool))
        # interleave round-robin-ish by shuffling a concatenation
        allb = np.concatenate(blocks)
        allc = np.concatenate(cores)
        alll = np.concatenate(l2loc)
        perm = self.rng.permutation(len(allb))
        return allb[perm], allc[perm], alll[perm]

    def run_cotenants(self, ms: float) -> None:
        blocks, cores, l2_local = self._cotenant_stream(ms)
        if len(blocks) == 0:
            return
        # l2_local accesses run prober-style (cotenant=False): they fill
        # the issuing core's private L2 — the core-sharing tenant model —
        # while plain co-tenants stay LLC-only as before
        self._run_stream(blocks, cores=cores, cotenant=~l2_local)

    # -- raw stream execution -------------------------------------------------
    def _on_device(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)

    def _run_stream(self, blocks: np.ndarray, cores: np.ndarray,
                    cotenant: np.ndarray) -> np.ndarray:
        n = len(blocks)
        pb = _pad_to_bucket(blocks.astype(np.int32), -1)
        pc = _pad_to_bucket(cores.astype(np.int32), 0)
        pt = np.zeros(len(pb), bool)
        pt[:n] = cotenant
        _note_shape("stream", self.geom, (len(pb),))
        self.state, lats = cachesim.access_stream(
            self.state, self.geom, self._on_device(pb), self._on_device(pc),
            self._on_device(pt))
        return lats.cpu().numpy()[:n]

    def _run_streams_batched(self, lanes: Sequence[np.ndarray],
                             cores: Sequence[int],
                             salt: int = 0,
                             lane_bucket: Optional[int] = None,
                             batch_bucket: Optional[int] = None
                             ) -> List[np.ndarray]:
        """Run B independent block-address streams as measurement lanes in a
        single engine dispatch (cachesim.access_streams_batched).  Lanes see
        a snapshot of the current machine state; their mutations are not
        committed.  Returns per-lane latency arrays trimmed to lane length.
        ``lane_bucket``/``batch_bucket`` override the padding granularity
        (per-platform plan-lowering hints; padding lanes/steps are no-ops).
        """
        n_lanes = len(lanes)
        pb_lanes = _ladder(_round_up(n_lanes, batch_bucket or _BATCH_BUCKET))
        t = _ladder(_round_up(max((len(l) for l in lanes), default=1),
                              lane_bucket or _LANE_BUCKET))
        blocks = np.full((pb_lanes, t), -1, np.int32)
        lane_cores = np.zeros(pb_lanes, np.int32)
        for i, (lane, core) in enumerate(zip(lanes, cores)):
            blocks[i, :len(lane)] = lane
            lane_cores[i] = core
        _note_shape("batched", self.geom, (pb_lanes, t))
        lats = cachesim.access_streams_batched(
            self.state, self.geom, self._on_device(blocks),
            self._on_device(lane_cores),
            torch.zeros(pb_lanes, dtype=torch.bool, device=self.device),
            salt & 0xFFFFFFFF)
        lats = lats.cpu().numpy()
        return [lats[i, :len(lane)] for i, lane in enumerate(lanes)]


class GuestVM:
    """The VM-visible interface.  Everything the probing stack may use."""

    def __init__(self, host: SimHost, n_guest_pages: int = 1 << 13,
                 mapping: str = "contiguous", vcpu_cores: Sequence[int] = (0,),
                 seed: int = 0,
                 _page_table: Optional[np.ndarray] = None):
        self.host = host
        self.n_guest_pages = n_guest_pages
        # hidden from the guest (``_page_table`` is only passed by
        # :meth:`reboot`, which reuses the existing backing instead of
        # provisioning fresh host pages):
        self._page_table = (_page_table if _page_table is not None
                            else host.provision_pages(n_guest_pages, mapping))
        self.vcpu_cores = list(vcpu_cores)  # vcpu i -> host core (hidden!)
        self.n_vcpus = len(self.vcpu_cores)
        self.rng = np.random.default_rng(seed + 17)
        self._free_guest_pages = list(range(n_guest_pages))
        # guest-TSC noise model: reads are noisy until warmed
        self._timer_warm = 0
        self.timer_noise_lat = 400
        self.timer_warm_reads = 8
        # cost accounting (used by benchmarks to report hardware-independent
        # work: total simulated accesses and batched passes issued)
        self.stat_accesses = 0
        self.stat_passes = 0
        # batched probes never commit machine state (so the machine rng
        # never advances); this per-call counter re-forks the lane rngs so
        # successive measurement dispatches draw independent replacement
        # decisions, like committed sequential probes would
        self._probe_seq = 0
        host._register_guest(self)

    # -- guest memory management ----------------------------------------------
    def alloc_pages(self, n: int) -> np.ndarray:
        if n > len(self._free_guest_pages):
            raise RuntimeError("guest out of pages")
        idx = self.rng.choice(len(self._free_guest_pages), size=n, replace=False)
        idx = np.sort(idx)[::-1]
        pages = np.array([self._free_guest_pages[i] for i in idx], np.int64)
        for i in idx:
            self._free_guest_pages.pop(int(i))
        return pages

    def free_pages(self, pages: Sequence[int]) -> None:
        self._free_guest_pages.extend(int(p) for p in pages)

    def reserve_pages(self, pages: Sequence[int]) -> None:
        """Mark specific guest pages as allocated (no-op for pages already
        taken).  `CacheXSession.import_` re-pins the pages an imported
        abstraction references so fresh allocations cannot recycle them."""
        drop = {int(p) for p in pages}
        self._free_guest_pages = [p for p in self._free_guest_pages
                                  if p not in drop]

    def reboot(self, seed: int = 0) -> "GuestVM":
        """Guest reboot: the hypervisor keeps the VM's memory, so the
        hidden GPA→HPA page table is *unchanged* — which is exactly why a
        probed cache abstraction stays valid across reboots (page colors
        and eviction sets are HPA properties).  All guest-side state is
        fresh: page allocator, timer warmth, cost counters, rng."""
        return GuestVM(self.host, n_guest_pages=self.n_guest_pages,
                       vcpu_cores=list(self.vcpu_cores), seed=seed,
                       _page_table=self._page_table)

    @staticmethod
    def gva(page: int, offset: int) -> int:
        """Guest virtual address of byte `offset` in guest page `page`.
        (Guest identity-maps GVA->GPA for the probing buffers.)"""
        return (int(page) << PAGE_BITS) | int(offset)

    # -- translation (hidden) ---------------------------------------------------
    def _hpa_block(self, gvas: np.ndarray) -> np.ndarray:
        gvas = np.asarray(gvas, np.int64)
        gpage = gvas >> PAGE_BITS
        off = gvas & ((1 << PAGE_BITS) - 1)
        hpage = self._page_table[gpage]
        return ((hpage << PAGE_BITS | off) >> cachesim.LINE_BITS).astype(np.int32)

    # -- accesses ---------------------------------------------------------------
    def access(self, gvas: np.ndarray, vcpu: int = 0) -> None:
        """Untimed accesses (MLP-style batched traversal)."""
        gvas = np.atleast_1d(np.asarray(gvas, np.int64))
        blocks = self._hpa_block(gvas)
        core = self.vcpu_cores[vcpu]
        self.stat_accesses += len(blocks)
        self.stat_passes += 1
        _count_probe_dispatch()
        self.host._run_stream(blocks, np.full(len(blocks), core, np.int32),
                              np.zeros(len(blocks), bool))

    def access_segments(self, segments: Sequence[Tuple[np.ndarray, int]]
                        ) -> None:
        """Untimed committed traversal of several per-thread segments fused
        into ONE dispatch: ``segments`` is a sequence of ``(gvas, vcpu)``
        pairs executed back to back in order (the multi-vCPU prime of a
        ProbePlan ``Commit`` op).  State evolution is identical to issuing
        one :meth:`access` per segment in the same order — the simulator
        replays the concatenated stream access by access — at 1 dispatch
        instead of ``len(segments)``."""
        parts = [(np.atleast_1d(np.asarray(g, np.int64)), v)
                 for g, v in segments]
        n = sum(len(g) for g, _ in parts)
        if n == 0:
            return
        blocks = np.concatenate([self._hpa_block(g) for g, _ in parts])
        cores = np.concatenate(
            [np.full(len(g), self.vcpu_cores[v], np.int32)
             for g, v in parts])
        self.stat_accesses += n
        self.stat_passes += 1
        _count_probe_dispatch()
        self.host._run_stream(blocks, cores, np.zeros(n, bool))

    def timed_access(self, gvas: np.ndarray, vcpu: int = 0) -> np.ndarray:
        """Accesses with per-access guest-TSC latencies (noisy when cold)."""
        gvas = np.atleast_1d(np.asarray(gvas, np.int64))
        blocks = self._hpa_block(gvas)
        core = self.vcpu_cores[vcpu]
        self.stat_accesses += len(blocks)
        self.stat_passes += 1
        _count_probe_dispatch()
        lats = self.host._run_stream(
            blocks, np.full(len(blocks), core, np.int32),
            np.zeros(len(blocks), bool)).astype(np.int64)
        # Guest TSC instability (§3.1): readings spike until the timer has
        # been read a few times in quick succession; any idle period
        # (wait_ms) makes it cold again.  warm_timer() = dummy reads.
        for i in range(len(lats)):
            if self._timer_warm < self.timer_warm_reads and self.rng.random() < 0.35:
                lats[i] += self.timer_noise_lat
            self._timer_warm = min(self.timer_warm_reads, self._timer_warm + 1)
        return lats

    def timed_access_batch(self, gva_lists: Sequence[np.ndarray],
                           vcpu=0, salt: int = 0,
                           lane_bucket: Optional[int] = None,
                           batch_bucket: Optional[int] = None
                           ) -> List[np.ndarray]:
        """Batched multi-set Prime+Probe: B independent timed streams in ONE
        fused dispatch.  ``vcpu`` is a single vcpu id or one per lane;
        ``salt`` re-forks the per-lane rng (vote index for majority voting
        under non-deterministic replacement).

        Lanes run against a snapshot of the machine state and are not
        committed — this is a measurement primitive (VEV group tests, VCOL
        parallel filtering, VSCAN probe phases all route through it); the
        caller re-primes real state where occupancy matters.  Guest-TSC
        noise applies per lane from the current warm level (each lane's MLP
        traversal then keeps its own timer warm, as in the fused sequential
        path).
        """
        lanes = [np.atleast_1d(np.asarray(g, np.int64)) for g in gva_lists]
        if not lanes:
            return []
        vcpus = [vcpu] * len(lanes) if np.isscalar(vcpu) else list(vcpu)
        blocks = [self._hpa_block(lane) for lane in lanes]
        cores = [self.vcpu_cores[v] for v in vcpus]
        self.stat_accesses += sum(len(b) for b in blocks)
        self.stat_passes += 1
        _count_probe_dispatch()
        out = [l.astype(np.int64)
               for l in self.host._run_streams_batched(
                   blocks, cores, salt=self._next_salt(salt),
                   lane_bucket=lane_bucket, batch_bucket=batch_bucket)]
        self._apply_timer_noise(out)
        return out

    def _next_salt(self, salt: int) -> int:
        """Effective per-dispatch rng salt (see ``_probe_seq``)."""
        self._probe_seq += 1
        return (salt * 65537 + self._probe_seq) & 0xFFFFFFFF

    def _apply_timer_noise(self, out: List[np.ndarray]) -> None:
        """Guest-TSC noise for one batched measurement (in place): each
        lane starts from the current warm level; the batch leaves the
        timer warm (shared by the single- and multi-guest batched paths)."""
        warm0 = self._timer_warm
        for lats in out:
            warm = warm0
            for i in range(min(len(lats), self.timer_warm_reads - warm0)):
                if warm < self.timer_warm_reads and self.rng.random() < 0.35:
                    lats[i] += self.timer_noise_lat
                warm += 1
        self._timer_warm = self.timer_warm_reads

    def warm_timer(self) -> None:
        """Dummy RDTSC reads before a measurement (the paper's §3.1 fix)."""
        self._timer_warm = self.timer_warm_reads

    def _timer_cooldown(self) -> None:
        self._timer_warm = 0

    # -- time -----------------------------------------------------------------
    def wait_ms(self, ms: float) -> None:
        """Spin-wait: co-located VMs keep running, scheduled host events
        fire at their timestamps (possibly mid-window — the guest cannot
        tell); our timer goes cold."""
        self.host.advance(ms)
        self._timer_cooldown()

    # -- validation hypercalls (used ONLY by tests/benchmarks) -------------------
    def hypercall_hpa_page(self, gpage: int) -> int:
        return int(self._page_table[gpage])

    def hypercall_host_epoch(self) -> int:
        """Host provisioning epoch (bumps on migrate/cat/remap events).
        Validation boundary only: exports stamp it and `validate()` reports
        staleness against it, but guest-side *decisions* (which sets to
        repair, when to recolor) must come from probing — see
        `VEV.validate_sets` / `VScan` drift signals."""
        return self.host.epoch

    def hypercall_l2_color(self, gpage: int) -> int:
        # L2 color = HPA bits 15-12 (paper Fig 1) = low 4 bits of host page no.
        return int(self._page_table[gpage]) & 0xF

    def hypercall_llc_color(self, gpage: int) -> int:
        # LLC color = HPA bits 16-12 = low 5 bits of host page number.
        return int(self._page_table[gpage]) & 0x1F

    def hypercall_llc_setslice(self, gva: int) -> Tuple[int, int]:
        blk = int(self._hpa_block(np.array([gva]))[0])
        s = int(cachesim.slice_hash(
            torch.tensor([blk]), self.host.geom.llc.n_slices,
            self.host.geom.slice_seed)[0])
        return blk % self.host.geom.llc.n_sets, s

    def hypercall_resident_level(self, gva: int, vcpu: int = 0) -> int:
        blk = int(self._hpa_block(np.array([gva]))[0])
        return cachesim.resident_level(self.host.state, blk,
                                       self.vcpu_cores[vcpu], self.host.geom)


# ---------------------------------------------------------------------------
# Multi-guest fused dispatch (the ProbePlan executor's batch-over-guests
# lowering).  Every guest must live on its OWN SimHost with an identical
# MachineGeometry and one shared device; per-guest results are
# bit-identical to issuing the same op through the guest's own single-VM
# path (integer arithmetic throughout).
# ---------------------------------------------------------------------------

def _check_multi(vms: Sequence["GuestVM"]) -> MachineGeometry:
    geoms = {vm.host.geom for vm in vms}
    if len(geoms) != 1:
        raise ValueError(f"multi-guest dispatch needs one shared geometry, "
                         f"got {len(geoms)}")
    if len({id(vm.host) for vm in vms}) != len(vms):
        raise ValueError("multi-guest dispatch needs one host per guest")
    if len({vm.host.device for vm in vms}) != 1:
        raise ValueError("multi-guest dispatch needs one shared device")
    return next(iter(geoms))


def commit_segments_multi(vms: Sequence["GuestVM"],
                          segments_per_vm: Sequence[
                              Sequence[Tuple[np.ndarray, int]]]) -> None:
    """Committed traversal for G guests in ONE dispatch: guest i runs (and
    commits) its own fused segment stream against its own machine state
    (`cachesim.access_streams_committed`).  The per-guest state evolution
    equals ``vms[i].access_segments(segments_per_vm[i])``."""
    geom = _check_multi(vms)
    per_vm: List[Tuple[np.ndarray, np.ndarray]] = []
    for vm, segments in zip(vms, segments_per_vm):
        parts = [(np.atleast_1d(np.asarray(g, np.int64)), v)
                 for g, v in segments]
        parts = [(g, v) for g, v in parts if len(g)]
        if parts:
            blocks = np.concatenate([vm._hpa_block(g) for g, _ in parts])
            cores = np.concatenate(
                [np.full(len(g), vm.vcpu_cores[v], np.int32)
                 for g, v in parts])
        else:
            blocks = np.empty(0, np.int32)
            cores = np.empty(0, np.int32)
        per_vm.append((blocks, cores))
    if not any(len(b) for b, _ in per_vm):
        return          # standalone access_segments dispatches nothing
    t = _round_up(max(len(b) for b, _ in per_vm), _STREAM_BUCKET)
    g_n = len(vms)
    blocks = np.full((g_n, t), -1, np.int32)
    cores = np.zeros((g_n, t), np.int32)
    for i, (b, c) in enumerate(per_vm):
        blocks[i, :len(b)] = b
        cores[i, :len(b)] = c
        if len(b):      # a work-free guest issues no pass standalone
            vms[i].stat_accesses += len(b)
            vms[i].stat_passes += 1
    _count_probe_dispatch()
    _note_shape("committed", geom, (g_n, t))
    host = vms[0].host
    states = cachesim.stack_states([vm.host.state for vm in vms])
    new_states, _ = cachesim.access_streams_committed(
        states, geom, host._on_device(blocks), host._on_device(cores),
        torch.zeros((g_n, t), dtype=torch.bool, device=host.device))
    for vm, st in zip(vms, cachesim.unstack_states(new_states, g_n)):
        vm.host.state = st


def timed_access_batch_multi(vms: Sequence["GuestVM"],
                             lanes_per_vm: Sequence[Sequence[np.ndarray]],
                             vcpus_per_vm: Sequence[Sequence[int]],
                             salt: int = 0,
                             lane_bucket: Optional[int] = None,
                             batch_bucket: Optional[int] = None
                             ) -> List[List[np.ndarray]]:
    """Batched measurement lanes for G guests in ONE dispatch
    (`cachesim.access_streams_batched_multi`): guest i's lanes probe a
    snapshot of its own machine state, uncommitted, with its own rng salt
    (per-guest ``_probe_seq`` advances exactly as a standalone
    :meth:`GuestVM.timed_access_batch` would, so latencies and guest-TSC
    noise draws are bit-identical to the single-guest path)."""
    geom = _check_multi(vms)
    g_n = len(vms)
    prepared = []
    max_b = 1
    max_t = 1
    for vm, gva_lists, vcpus in zip(vms, lanes_per_vm, vcpus_per_vm):
        lanes = [np.atleast_1d(np.asarray(g, np.int64)) for g in gva_lists]
        blocks = [vm._hpa_block(lane) for lane in lanes]
        cores = [vm.vcpu_cores[v] for v in vcpus]
        prepared.append((lanes, blocks, cores))
        max_b = max(max_b, len(lanes))
        max_t = max(max_t, max((len(l) for l in lanes), default=1))
    if not any(lanes for lanes, _, _ in prepared):
        return [[] for _ in vms]   # standalone path dispatches nothing
    b_pad = _ladder(_round_up(max_b, batch_bucket or _BATCH_BUCKET))
    t_pad = _ladder(_round_up(max_t, lane_bucket or _LANE_BUCKET))
    blocks_arr = np.full((g_n, b_pad, t_pad), -1, np.int32)
    cores_arr = np.zeros((g_n, b_pad), np.int32)
    salts = np.zeros(g_n, np.uint32)
    for i, (vm, (lanes, blocks, cores)) in enumerate(zip(vms, prepared)):
        if not lanes:
            continue    # empty batch: standalone early-returns untouched
        for j, (b, c) in enumerate(zip(blocks, cores)):
            blocks_arr[i, j, :len(b)] = b
            cores_arr[i, j] = c
        salts[i] = vm._next_salt(salt)
        vm.stat_accesses += sum(len(b) for b in blocks)
        vm.stat_passes += 1
    _count_probe_dispatch()
    _note_shape("batched_multi", geom, (g_n, b_pad, t_pad))
    host = vms[0].host
    states = cachesim.stack_states([vm.host.state for vm in vms])
    lats = cachesim.access_streams_batched_multi(
        states, geom, host._on_device(blocks_arr), host._on_device(cores_arr),
        torch.zeros((g_n, b_pad), dtype=torch.bool, device=host.device),
        host._on_device(salts.astype(np.int64))).cpu().numpy()
    results: List[List[np.ndarray]] = []
    for i, (vm, (lanes, _, _)) in enumerate(zip(vms, prepared)):
        out = [lats[i, j, :len(lane)].astype(np.int64)
               for j, lane in enumerate(lanes)]
        if lanes:
            vm._apply_timer_noise(out)
        results.append(out)
    return results


def shard_slices(n: int, shard_size: Optional[int]) -> List[slice]:
    """Partition ``n`` guests into contiguous shards of ``shard_size``
    (last shard takes the remainder).  ``None``/``0``/``>= n`` means one
    shard — the unsharded multi-guest dispatch."""
    if not shard_size or shard_size <= 0 or shard_size >= n:
        return [slice(0, n)]
    return [slice(i, min(i + shard_size, n))
            for i in range(0, n, shard_size)]


def commit_segments_sharded(vms: Sequence["GuestVM"],
                            segments_per_vm: Sequence[
                                Sequence[Tuple[np.ndarray, int]]],
                            shard_size: Optional[int] = None) -> None:
    """Sharded committed traversal: guests split into ``shard_size`` groups,
    one `commit_segments_multi` dispatch per shard.  ``ceil(G / S)``
    dispatches whose stacked-state shape is ``(S, ...)`` — reused across
    every fleet size that shards at S — instead of one ``(G, ...)`` dispatch
    whose shape is unique to this exact G.  Per-guest
    state evolution is identical at any shard size."""
    vms = list(vms)
    segments_per_vm = list(segments_per_vm)
    for sl in shard_slices(len(vms), shard_size):
        commit_segments_multi(vms[sl], segments_per_vm[sl])


def timed_access_batch_sharded(vms: Sequence["GuestVM"],
                               lanes_per_vm: Sequence[Sequence[np.ndarray]],
                               vcpus_per_vm: Sequence[Sequence[int]],
                               salt: int = 0,
                               lane_bucket: Optional[int] = None,
                               batch_bucket: Optional[int] = None,
                               shard_size: Optional[int] = None
                               ) -> List[List[np.ndarray]]:
    """Sharded batched measurement: one `timed_access_batch_multi` dispatch
    per ``shard_size`` group of guests (see :func:`commit_segments_sharded`
    for the shape-reuse rationale).  Per-guest latencies, salts and timer
    noise are bit-identical at any shard size — padding never leaks into
    lane results."""
    vms = list(vms)
    lanes_per_vm = list(lanes_per_vm)
    vcpus_per_vm = list(vcpus_per_vm)
    out: List[List[np.ndarray]] = []
    for sl in shard_slices(len(vms), shard_size):
        out.extend(timed_access_batch_multi(
            vms[sl], lanes_per_vm[sl], vcpus_per_vm[sl], salt=salt,
            lane_bucket=lane_bucket, batch_bucket=batch_bucket))
    return out


# -- canned co-tenant generators (paper §6 workload analogues) -----------------

def polluter_gen(region_pages: int = 4096, base_page: int = 1 << 18):
    """`cache polluter`: 64 B-stride sweeps of a large region (stresses all
    sets)."""
    state = {"pos": 0}
    n_blocks = region_pages * BLOCKS_PER_PAGE

    def gen(rng: np.random.Generator, n: int) -> np.ndarray:
        start = state["pos"]
        out = (base_page * BLOCKS_PER_PAGE +
               (start + np.arange(n)) % n_blocks)
        state["pos"] = (start + n) % n_blocks
        return out
    return gen


def poisoner_gen(host: SimHost, target_set_index_bits: int, n_sets: int,
                 base_page: int = 1 << 18, pool_pages: int = 8192):
    """`cache poisoner`: stresses only blocks whose LLC set index falls in one
    of 16 zones (1/16 of the sets), like §2.2's avoidable-set-contention
    experiment.  zone = target_set_index_bits (0..15)."""
    lo = target_set_index_bits * (n_sets // 16)
    hi = lo + (n_sets // 16)
    base_block = base_page * BLOCKS_PER_PAGE
    cand = base_block + np.arange(pool_pages * BLOCKS_PER_PAGE)
    cand = cand[(cand % n_sets >= lo) & (cand % n_sets < hi)]

    def gen(rng: np.random.Generator, n: int) -> np.ndarray:
        return rng.choice(cand, size=n, replace=True)
    return gen


def congruent_gen(set_indices, n_sets: int, base_page: int = 1 << 18,
                  span_pages: int = 4096):
    """Traffic confined to exact LLC set-index residues (sharper than
    `poisoner_gen`'s 1/16-zone granularity).  The fleet simulator uses it to
    keep one virtual color's monitored sets saturated so CAP's measured
    per-color ranking has a stable hottest color to steer streams into."""
    base_block = base_page * BLOCKS_PER_PAGE
    cand = base_block + np.arange(span_pages * BLOCKS_PER_PAGE)
    cand = cand[np.isin(cand % n_sets, np.asarray(sorted(set_indices)))]

    def gen(rng: np.random.Generator, n: int) -> np.ndarray:
        return rng.choice(cand, size=n, replace=True)
    return gen


def zipf_gen(base_page: int = 1 << 18, region_pages: int = 2048, a: float = 1.3):
    """nginx-like skewed accesses (some sets naturally hotter, Fig 4-left)."""
    base_block = base_page * BLOCKS_PER_PAGE
    n_blocks = region_pages * BLOCKS_PER_PAGE

    def gen(rng: np.random.Generator, n: int) -> np.ndarray:
        r = rng.zipf(a, size=n) % n_blocks
        return base_block + r
    return gen
