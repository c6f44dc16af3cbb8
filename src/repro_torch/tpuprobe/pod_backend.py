"""CacheX for an accelerator pod: the pod probe backend
(`CacheXSession.attach(backend="pod")`).

The port of `repro.tpuprobe.pod_backend`, line for line: the same model,
the same integers and decisions, numpy on the host.  The paper probes an
opaque hypervisor-hidden LLC and serves the result as an abstraction
CAS/CAP consume.  A pod tenant faces the same information asymmetry: the
runtime's fast-memory reservation, per-chip effective HBM bandwidth under
co-located traffic, and per-axis/per-hop link health are all
undocumented at tenant level.  This module re-expresses the three probes
as **ProbePlan programs** run by the one executor every LLC probe already
lowers through, and serves them behind the same session query surface:

  ===============  =========================================================
  probe module      ProbePlan re-expression
  ===============  =========================================================
  ``vmem_probe``   one-shot binary search → ONE ``Vote[vmem]`` op over an
                   aligned ladder of candidate tiles per chip (a lane per
                   candidate; verdict True = "tile over budget"); the
                   largest False candidate *is* the effective budget —
                   the eviction-set trick, batched
  ``ici_probe``    per-axis timed collectives → one ``Measure[ici_<axis>]``
                   op per mesh axis, a lane per hop (per-level op
                   plumbing; per-axis signatures fuse / tune-cache
                   separately)
  ``monitor``      ``PodMonitor``'s windowed loop → :class:`PodScan`, a
                   VScan-shaped monitor (``Wait``/``WarmTimer``/
                   ``Measure[hbm]``/``Measure[ici]`` plan per window,
                   EWMA, `TierTracker` hysteresis tiers, quarantine of
                   faulted chips)
  ===============  =========================================================

Plans execute against :class:`SimPod`, a deterministic host model in the
``SimHost`` posture: contention playback schedules (``monitor.SimClock``'s
contract, generalized to per-chip HBM and per-axis/per-hop links), a
hidden reservation of :data:`~repro_torch.tpuprobe.vmem_probe.NOMINAL_VMEM`,
a provisioning epoch, and hypercall-style oracles that tests and
benchmarks (never decision paths) validate against.  The card's own
probes are `tpuprobe.vmem_probe` (a staged triad's shared-memory tile)
and `tpuprobe.ici_probe` (`torch.distributed` collectives).
:class:`PodSlice` is the tenant handle: it satisfies
`repro_torch.core.backend.ProbeTarget` by encoding probes as int64 lane
descriptors, so ``probeplan.execute`` / ``fuse`` / ``plan_cost`` work on
pod plans unchanged.

:class:`PodSession` serves the CacheXSession query surface —
``topology()`` (mesh axes/chips + per-chip effective VMEM, the
``effective_ways`` analogue), ``colors()`` (VMEM/HBM arena zones),
``contention()`` (per-chip slowdown as ``per_domain``, per-axis link
health as ``per_level``), subscriptions, epoch-stamped
``export()``/``import_()`` with :class:`StaleAbstractionError` on pod
reprovisioning; its exports carry the JAX package's format string, so
either package imports the other's.  :class:`PodFleetSim` closes the
loop through the ported consumers (`distributed.rebalance`,
`data.pipeline`, `serve.engine`): probe → tier → reroute/rebalance →
measure p99 decode latency and step time.
"""

from __future__ import annotations

import dataclasses
import json
import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.abstraction import (ContentionView,
                                          StaleAbstractionError)
from repro_torch.core.cas import TierTracker
from repro_torch.core.probeplan import (Measure, PlanLowering, PlanResult,
                                        ProbePlan, Vote, Wait, WarmTimer,
                                        execute)
from repro_torch.core.vscan import DriftSignal
from repro_torch.tpuprobe.vmem_probe import NOMINAL_VMEM

__all__ = ["POD_EXPORT_FORMAT", "encode_lane", "decode_lane", "SimPod",
           "PodSlice", "POD_LOWERING", "vmem_plan", "apply_vmem", "ici_plan",
           "apply_ici", "degraded_hops", "PodScanSnapshot", "PodScan",
           "PodProbeConfig", "PodTopologyView", "PodColorsView",
           "PodSession", "PodBackend", "PodLoopReport", "PodFleetSim",
           "run_pod_loop"]

POD_EXPORT_FORMAT = "cachex-pod-abstraction/v1"

# -- lane descriptor encoding (what PodSlice's probing surface interprets) --
KIND_HBM = 1       # a=chip,      b=rep        : timed HBM triad lane
KIND_ICI = 2       # a=axis index, b=hop       : timed collective ping
KIND_VMEM = 3      # a=chip,      b=tile quanta: tile-fit compile trial

#: synthetic latency scales (ticks); slowdown = latency / nominal
NOMINAL_HBM_LAT = 100
NOMINAL_ICI_LAT = 200
VMEM_FIT_LAT = 10
VMEM_OVER_LAT = 1000
VMEM_THRESHOLD = 500       # Vote threshold separating fits / over-budget
VMEM_ALIGN = 1 << 18       # 256 KiB tile quantum (vmem_probe's resolution)


def encode_lane(kind: int, a: int, b: int) -> int:
    return (kind << 40) | (a << 20) | b


def decode_lane(enc: int) -> Tuple[int, int, int]:
    return (enc >> 40) & 0xFF, (enc >> 20) & 0xFFFFF, enc & 0xFFFFF


# ---------------------------------------------------------------------------
# SimPod: deterministic pod host model (the SimHost posture, no TPU needed)
# ---------------------------------------------------------------------------

class SimPod:
    """Hypervisor-side ground truth for a small TPU pod.

    ``mesh_shape`` orders the mesh axes (e.g. ``{"data": 2, "model": 4}``
    → 8 chips, row-major coords).  Hidden quantities a tenant must probe:

      * ``reserved_vmem`` — the runtime's opaque VMEM reservation,
      * ``hbm_schedule(chip, t_ms) -> slowdown`` — per-chip effective-HBM
        contention playback (``monitor.SimClock``'s contract),
      * ``link_schedule(axis, hop, t_ms) -> slowdown`` — per-hop ICI
        health (``ici_probe``'s ``link_model``, time-varying).

    ``epoch`` is the pod provisioning epoch: :meth:`reprovision` (runtime
    upgrade / slice migration) bumps it, which is what makes an exported
    abstraction stale.  ``hypercall_*`` oracles are the §6.2 validation
    boundary — tests and ``validate()`` only, never decision paths.
    """

    def __init__(self, mesh_shape: Optional[Dict[str, int]] = None,
                 seed: int = 0, reserved_vmem: int = 3 << 20,
                 hbm_schedule: Optional[Callable[[int, float], float]] = None,
                 link_schedule: Optional[
                     Callable[[str, int, float], float]] = None):
        self.mesh_shape = dict(mesh_shape or {"data": 2, "model": 4})
        self.axis_names = list(self.mesh_shape)
        self.n_chips = int(np.prod(list(self.mesh_shape.values())))
        self.seed = seed
        self.reserved_vmem = int(reserved_vmem)
        self._hbm = hbm_schedule or (lambda chip, t: 1.0)
        self._link = link_schedule or (lambda axis, hop, t: 1.0)
        self.time_ms = 0.0
        self.epoch = 0
        self.stat_dispatches = 0
        self.stat_accesses = 0

    def chip_coords(self, chip: int) -> Tuple[int, ...]:
        coords, rem = [], chip
        for ax in reversed(self.axis_names):
            coords.append(rem % self.mesh_shape[ax])
            rem //= self.mesh_shape[ax]
        return tuple(reversed(coords))

    def advance(self, ms: float) -> None:
        self.time_ms += ms

    def reprovision(self, reserved_vmem: Optional[int] = None,
                    hbm_schedule=None, link_schedule=None) -> int:
        """Runtime upgrade / slice migration: hidden quantities change and
        the provisioning epoch bumps (exported abstractions go stale)."""
        if reserved_vmem is not None:
            self.reserved_vmem = int(reserved_vmem)
        if hbm_schedule is not None:
            self._hbm = hbm_schedule
        if link_schedule is not None:
            self._link = link_schedule
        self.epoch += 1
        return self.epoch

    def slice(self) -> "PodSlice":
        """Boot a tenant slice (the pod analogue of ``make_host_vm``)."""
        return PodSlice(self)

    # -- validation hypercalls (tests / validate() ONLY) --------------------
    def hypercall_pod_epoch(self) -> int:
        return self.epoch

    def hypercall_reserved_vmem(self) -> int:
        return self.reserved_vmem

    def hypercall_chip_slowdown(self, chip: int) -> float:
        return max(1.0, float(self._hbm(chip, self.time_ms)))

    def hypercall_link_slowdown(self, axis: str, hop: int) -> float:
        return max(1.0, float(self._link(axis, hop, self.time_ms)))


class PodSlice:
    """Tenant probing handle: the `ProbeTarget` surface over a SimPod.

    Lane elements are :func:`encode_lane` descriptors, not addresses —
    ``timed_access_batch`` decodes each lane and synthesizes its latency
    from the pod's hidden state at the current playback time (plus a
    deterministic sub-tick jitter forked from ``(seed, dispatch, salt)``,
    mirroring GuestVM's salted timer noise).  The ProbePlan executor is
    the only intended caller.
    """

    def __init__(self, pod: SimPod):
        self.host = pod
        self.stat_passes = 0
        self.stat_accesses = 0
        self.stat_dispatches = 0
        self._probe_seq = 0

    # -- ProbeTarget surface (repro.core.backend) ---------------------------
    def access(self, lanes, vcpu: int = 0) -> None:
        self.stat_accesses += int(len(lanes))
        self.stat_passes += 1

    def access_segments(self, segments) -> None:
        for gvas, _vcpu in segments:
            self.stat_accesses += int(len(gvas))
        self.stat_passes += 1

    def wait_ms(self, ms: float) -> None:
        self.host.advance(ms)

    def warm_timer(self) -> None:
        self.stat_passes += 1

    def timed_access_batch(self, lanes, vcpu=0, salt: int = 0,
                           lane_bucket: int = 128, batch_bucket: int = 8):
        self.stat_dispatches += 1
        self.host.stat_dispatches += 1
        rng = np.random.default_rng(
            (self.host.seed, self._probe_seq, salt))
        self._probe_seq += 1
        pod, t = self.host, self.host.time_ms
        out: List[np.ndarray] = []
        for lane in lanes:
            lane = np.asarray(lane, np.int64)
            self.stat_accesses += int(lane.size)
            pod.stat_accesses += int(lane.size)
            lat = np.empty(lane.size, np.int64)
            jit = rng.integers(0, 2, lane.size)
            for i, enc in enumerate(lane):
                kind, a, b = decode_lane(int(enc))
                if kind == KIND_HBM:
                    base = NOMINAL_HBM_LAT * max(1.0, pod._hbm(a, t))
                elif kind == KIND_ICI:
                    axis = pod.axis_names[a]
                    base = NOMINAL_ICI_LAT * max(1.0, pod._link(axis, b, t))
                elif kind == KIND_VMEM:
                    fits = b * VMEM_ALIGN <= NOMINAL_VMEM - pod.reserved_vmem
                    base = VMEM_FIT_LAT if fits else VMEM_OVER_LAT
                else:
                    raise ValueError(f"bad pod lane descriptor {enc:#x}")
                lat[i] = int(round(base)) + int(jit[i])
            out.append(lat)
        return out


# ---------------------------------------------------------------------------
# probe plans (the seed probes, as data)
# ---------------------------------------------------------------------------

#: pod plans opt out of multi-guest lockstep (one slice per pod; lanes are
#: descriptors, not congruent address streams) but keep the cost model's
#: padding buckets so `plan_cost` / `fuse` stay meaningful.
POD_LOWERING = PlanLowering(fuse_commits=True, lane_bucket=8,
                            batch_bucket=8, lockstep=False)


def vmem_plan(chips: Sequence[int], votes: int = 1,
              align: int = VMEM_ALIGN) -> ProbePlan:
    """ONE ``Vote[vmem]`` op replacing `vmem_probe`'s sequential binary
    search: a lane per (chip, aligned candidate tile); verdict True means
    the compile trial ran over budget.  The search becomes data — it
    costs, fuses, and batches like any other plan."""
    n_cand = NOMINAL_VMEM // align
    lanes, order = [], []
    for chip in chips:
        for q in range(1, n_cand + 1):
            lanes.append(np.array([encode_lane(KIND_VMEM, chip, q)],
                                  np.int64))
            order.append((int(chip), q))
    op = Vote(lanes=tuple(lanes), vcpus=(0,) * len(lanes),
              threshold=VMEM_THRESHOLD, votes=votes, level="vmem")
    return ProbePlan(ops=(WarmTimer(), op), label="pod.vmem",
                     hints=POD_LOWERING,
                     meta={"order": order, "align": align})


def apply_vmem(plan: ProbePlan, result: PlanResult) -> Dict[int, int]:
    """Per-chip effective VMEM (bytes): the largest aligned candidate whose
    verdict was False (fits).  0 if nothing fit."""
    verdicts = result.last
    align = plan.meta["align"]
    eff: Dict[int, int] = {}
    for (chip, q), over in zip(plan.meta["order"], verdicts):
        if not over:
            eff[chip] = max(eff.get(chip, 0), q * align)
        else:
            eff.setdefault(chip, 0)
    return eff


def ici_plan(mesh_shape: Dict[str, int]) -> ProbePlan:
    """One ``Measure[ici_<axis>]`` op per mesh axis, a lane per hop — the
    per-level plumbing gives each axis its own signature suffix, so
    per-axis plans cost/fuse/tune-cache independently."""
    ops: List = [WarmTimer()]
    meta_axes = []
    for ai, (axis, size) in enumerate(mesh_shape.items()):
        lanes = tuple(np.full(2, encode_lane(KIND_ICI, ai, hop), np.int64)
                      for hop in range(size))
        ops.append(Measure(lanes=lanes, vcpus=(0,) * size, salt=0,
                           level=f"ici_{axis}"))
        meta_axes.append(axis)
    return ProbePlan(ops=tuple(ops), label="pod.ici", hints=POD_LOWERING,
                     meta={"axes": meta_axes})


def apply_ici(plan: ProbePlan, result: PlanResult) -> Dict[str, Dict]:
    """Per-axis health from the timed lanes — `ici_probe.probe_axes`'s
    output shape (slowdown = worst hop), plus the per-hop breakdown
    `degraded_hops` used to need a second pass for."""
    out: Dict[str, Dict] = {}
    for i, axis in enumerate(plan.meta["axes"]):
        lats = result.values[i + 1]              # op 0 is the WarmTimer
        per_hop = [float(l[-1]) / NOMINAL_ICI_LAT for l in lats]
        out[axis] = {"per_hop": per_hop,
                     "slowdown": max(1.0, max(per_hop)),
                     "size": len(per_hop)}
    return out


def degraded_hops(axis_stats: Dict[str, Dict], axis: str,
                  threshold: float = 1.3) -> List[int]:
    """Which hops on ``axis`` are sick, straight from the probed per-hop
    breakdown (no extra probe pass)."""
    return [h for h, s in enumerate(axis_stats[axis]["per_hop"])
            if s > threshold]


# ---------------------------------------------------------------------------
# PodScan: the monitor loop as a VScan-shaped resource
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PodScanSnapshot:
    """One monitoring window's measurements (the VScanSnapshot analogue)."""

    slowdown: np.ndarray         # per chip, instantaneous
    ewma: np.ndarray             # per chip, smoothed
    axis_health: Dict[str, float]
    window_ms: float
    time_ms: float


class PodScan:
    """Windowed pod contention monitor: `monitor.PodMonitor`'s loop as a
    ProbePlan program + state machine.

    Each window is one plan — ``Wait(window)`` (the idle-step analogue),
    ``WarmTimer``, ``Measure[hbm]`` (a lane per chip), ``Measure[ici]``
    (a lane per (axis, hop)) — and :meth:`apply_monitor` folds the
    result: EWMA slowdowns, `TierTracker` hysteresis tiers, quarantine of
    chips whose instantaneous slowdown stays above
    ``quarantine_slowdown`` for ``drift_intervals`` consecutive windows
    (VSCAN's drift-suspicion shape; :meth:`confirm_clean` lifts it).
    """

    def __init__(self, sl: PodSlice, window_ms: float = 10.0,
                 ewma_alpha: float = 0.3,
                 tier_thresholds: Sequence[float] = (1.15, 1.5),
                 quarantine_slowdown: float = 3.0,
                 drift_intervals: int = 2):
        self.sl = sl
        self.pod = sl.host
        self.window_ms = window_ms
        self.ewma_alpha = ewma_alpha
        self.quarantine_slowdown = quarantine_slowdown
        self.drift_intervals = drift_intervals
        n = self.pod.n_chips
        self.ewma = np.ones(n)
        self.axis_health = {a: 1.0 for a in self.pod.axis_names}
        self.tiers = TierTracker(keys=list(range(n)),
                                 thresholds=list(tier_thresholds))
        self.flagged: set = set()
        self._hot_streak = np.zeros(n, np.int64)
        self.intervals = 0
        self.history: List[PodScanSnapshot] = []

    def monitor_plan(self) -> ProbePlan:
        pod = self.pod
        hbm = tuple(np.full(2, encode_lane(KIND_HBM, c, 0), np.int64)
                    for c in range(pod.n_chips))
        ici_lanes, ici_order = [], []
        for ai, axis in enumerate(pod.axis_names):
            for hop in range(pod.mesh_shape[axis]):
                ici_lanes.append(np.full(2, encode_lane(KIND_ICI, ai, hop),
                                         np.int64))
                ici_order.append((axis, hop))
        return ProbePlan(
            ops=(Wait(self.window_ms), WarmTimer(),
                 Measure(lanes=hbm, vcpus=(0,) * len(hbm), salt=0,
                         level="hbm"),
                 Measure(lanes=tuple(ici_lanes),
                         vcpus=(0,) * len(ici_lanes), salt=0, level="ici")),
            label="pod.monitor", hints=POD_LOWERING,
            meta={"ici_order": ici_order})

    def apply_monitor(self, plan: ProbePlan,
                      result: PlanResult) -> PodScanSnapshot:
        slow = np.array([max(1.0, float(l[-1]) / NOMINAL_HBM_LAT)
                         for l in result.values[2]])
        per_hop: Dict[str, float] = {a: 1.0 for a in self.pod.axis_names}
        for (axis, _hop), l in zip(plan.meta["ici_order"],
                                   result.values[3]):
            per_hop[axis] = max(per_hop[axis],
                                float(l[-1]) / NOMINAL_ICI_LAT)
        a = self.ewma_alpha
        self.ewma = (1 - a) * self.ewma + a * slow
        for axis, h in per_hop.items():
            self.axis_health[axis] = ((1 - a) * self.axis_health[axis]
                                      + a * h)
        self.tiers.update({c: float(self.ewma[c])
                           for c in range(len(self.ewma))})
        hot = slow > self.quarantine_slowdown
        self._hot_streak = np.where(hot, self._hot_streak + 1, 0)
        for c in np.nonzero(self._hot_streak >= self.drift_intervals)[0]:
            self.flagged.add(int(c))
        self.intervals += 1
        snap = PodScanSnapshot(slowdown=slow, ewma=self.ewma.copy(),
                               axis_health=dict(self.axis_health),
                               window_ms=self.window_ms,
                               time_ms=self.pod.time_ms)
        self.history.append(snap)
        return snap

    def monitor_once(self) -> PodScanSnapshot:
        plan = self.monitor_plan()
        return self.apply_monitor(plan, execute(self.sl, plan))

    def confirm_clean(self, chips: Sequence[int]) -> List[int]:
        """Un-quarantine chips whose latest window measured quiet."""
        cleared = [c for c in chips if c in self.flagged
                   and self._hot_streak[c] == 0]
        for c in cleared:
            self.flagged.discard(c)
        return cleared

    # -- persistence --------------------------------------------------------
    def state_dict(self) -> Dict:
        return {"window_ms": self.window_ms, "ewma_alpha": self.ewma_alpha,
                "quarantine_slowdown": self.quarantine_slowdown,
                "drift_intervals": self.drift_intervals,
                "ewma": [float(x) for x in self.ewma],
                "axis_health": dict(self.axis_health),
                "tiers": {str(k): v for k, v in self.tiers.tier.items()},
                "tier_thresholds": list(self.tiers.thresholds),
                "flagged": sorted(self.flagged),
                "hot_streak": [int(x) for x in self._hot_streak],
                "intervals": self.intervals}

    @classmethod
    def from_state(cls, sl: PodSlice, state: Dict) -> "PodScan":
        scan = cls(sl, window_ms=state["window_ms"],
                   ewma_alpha=state["ewma_alpha"],
                   tier_thresholds=tuple(state["tier_thresholds"]),
                   quarantine_slowdown=state["quarantine_slowdown"],
                   drift_intervals=state["drift_intervals"])
        scan.ewma = np.array(state["ewma"])
        scan.axis_health = dict(state["axis_health"])
        scan.tiers.tier = {int(k): int(v)
                           for k, v in state["tiers"].items()}
        scan.flagged = set(state["flagged"])
        scan._hot_streak = np.array(state["hot_streak"], np.int64)
        scan.intervals = int(state["intervals"])
        return scan


# ---------------------------------------------------------------------------
# the session
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PodProbeConfig:
    """Pod-backend knobs (the `ProbeConfig` analogue; same replace idiom)."""

    votes: int = 1
    window_ms: float = 10.0
    ewma_alpha: float = 0.3
    refresh_interval_ms: float = 50.0
    tier_thresholds: Tuple[float, ...] = (1.15, 1.5)
    quarantine_slowdown: float = 3.0
    drift_intervals: int = 2
    vmem_align: int = VMEM_ALIGN
    seed: int = 0

    def replace(self, **kw) -> "PodProbeConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class PodTopologyView:
    """Probed pod structure: mesh axes/chips in place of LLC domains;
    per-chip effective VMEM is the ``effective_ways`` analogue (probed,
    not nominal, capacity)."""

    axes: Dict[str, int]
    n_chips: int
    effective_vmem: Dict[int, int]
    axis_slowdown: Dict[str, float]
    epoch: int


@dataclasses.dataclass(frozen=True)
class PodColorsView:
    """VMEM/HBM arena zones — the virtual-color analogue CAP-style
    consumers allocate against.  Zone ``2c`` is chip ``c``'s HBM staging
    arena, zone ``2c+1`` its VMEM arena."""

    n_chips: int

    @property
    def n_zones(self) -> int:
        return 2 * self.n_chips

    def zone_of(self, chip: int, kind: str = "hbm") -> int:
        return 2 * chip + (0 if kind == "hbm" else 1)

    def chip_of(self, zone: int) -> int:
        return zone // 2

    def kind_of(self, zone: int) -> str:
        return "hbm" if zone % 2 == 0 else "vmem"

    def build_free_lists(self, per_zone: int) -> Dict[int, List]:
        """Colored free lists for a `ColoredStagingPool` (CapAllocator
        handles are (zone, slot) pairs, like page ids for LLC colors)."""
        return {z: [(z, i) for i in range(per_zone)]
                for z in range(self.n_zones)}


class PodSession:
    """The probed pod abstraction as a query API — `CacheXSession`'s
    surface (attach/topology/colors/contention/refresh/plan/execute/
    apply/subscribe/export/import_/validate/check_drift/repair) served by
    the pod backend.  Stages run at most once, lazily: ``topology()``
    probes effective VMEM + ICI health; ``contention()``/``refresh()``
    build the :class:`PodScan` monitor."""

    def __init__(self, sl: PodSlice, platform: str = "pod",
                 config: Optional[PodProbeConfig] = None):
        self.vm = sl
        self.pod = sl.host
        self.platform = platform
        self.config = config or PodProbeConfig()
        self._vmem: Optional[Dict[int, int]] = None
        self._ici: Optional[Dict[str, Dict]] = None
        self._scan: Optional[PodScan] = None
        self._last: Optional[ContentionView] = None
        self._intervals = 0
        self._subs: Dict[int, Callable[[ContentionView], None]] = {}
        self._drift_subs: Dict[int, Callable[[DriftSignal], None]] = {}
        self._next_sub = 0
        self.epoch = 0
        self._probed_pod_epoch: Optional[int] = None

    # -- lifecycle ----------------------------------------------------------
    @classmethod
    def attach(cls, sl: PodSlice, platform: str = "pod",
               config: Optional[PodProbeConfig] = None,
               eager: bool = False) -> "PodSession":
        session = cls(sl, platform, config)
        if eager:
            session.topology()
            session.colors()
            session.refresh()
        return session

    def _note_probed_epoch(self) -> None:
        now = self.pod.hypercall_pod_epoch()
        if self._probed_pod_epoch is None:
            self._probed_pod_epoch = now
        else:
            self._probed_pod_epoch = min(self._probed_pod_epoch, now)

    def _ensure_capacity(self) -> None:
        if self._vmem is None:
            plan = vmem_plan(range(self.pod.n_chips),
                             votes=self.config.votes,
                             align=self.config.vmem_align)
            self._vmem = apply_vmem(plan, execute(self.vm, plan))
            self._note_probed_epoch()
        if self._ici is None:
            plan = ici_plan(self.pod.mesh_shape)
            self._ici = apply_ici(plan, execute(self.vm, plan))
            self._note_probed_epoch()

    def _ensure_scan(self) -> PodScan:
        if self._scan is None:
            cfg = self.config
            self._scan = PodScan(
                self.vm, window_ms=cfg.window_ms,
                ewma_alpha=cfg.ewma_alpha,
                tier_thresholds=cfg.tier_thresholds,
                quarantine_slowdown=cfg.quarantine_slowdown,
                drift_intervals=cfg.drift_intervals)
            self._note_probed_epoch()
        return self._scan

    # -- queries ------------------------------------------------------------
    def topology(self) -> PodTopologyView:
        self._ensure_capacity()
        return PodTopologyView(
            axes=dict(self.pod.mesh_shape), n_chips=self.pod.n_chips,
            effective_vmem=dict(self._vmem),
            axis_slowdown={a: s["slowdown"] for a, s in self._ici.items()},
            epoch=self.epoch)

    def colors(self) -> PodColorsView:
        return PodColorsView(n_chips=self.pod.n_chips)

    def effective_vmem(self, chip: int = 0) -> int:
        """Probed usable VMEM (the `vmem_probe` result, plan-served)."""
        self._ensure_capacity()
        return self._vmem[chip]

    def axis_stats(self) -> Dict[str, Dict]:
        """Per-axis ICI stats (the `ici_probe.probe_axes` shape)."""
        self._ensure_capacity()
        return {a: dict(s) for a, s in self._ici.items()}

    def monitored_sets(self) -> PodScan:
        return self._ensure_scan()

    def _build_view(self, snap: PodScanSnapshot) -> ContentionView:
        scan = self._scan
        colors = self.colors()
        per_domain = {c: float(scan.ewma[c])
                      for c in range(self.pod.n_chips)}
        self._ensure_capacity()
        per_color: Dict[int, float] = {}
        for z in range(colors.n_zones):
            chip = colors.chip_of(z)
            if colors.kind_of(z) == "hbm":
                per_color[z] = float(scan.ewma[chip])
            else:   # VMEM arena pressure: nominal/effective
                eff = max(self._vmem.get(chip, 0), 1)
                per_color[z] = NOMINAL_VMEM / eff
        per_level = {"hbm": float(scan.ewma.mean()),
                     "ici": float(np.mean(list(
                         scan.axis_health.values())))}
        for axis, h in scan.axis_health.items():
            per_level[f"ici:{axis}"] = float(h)
        return ContentionView(
            per_domain=per_domain, per_color=per_color,
            mean_rate=float(snap.slowdown.mean()),
            window_ms=snap.window_ms, measured_at_ms=snap.time_ms,
            interval=self._intervals, epoch=self.epoch,
            per_level=per_level, l2_cores={})

    def refresh(self) -> ContentionView:
        scan = self._ensure_scan()
        before = set(scan.flagged)
        snap = scan.monitor_once()
        self._intervals += 1
        view = self._build_view(snap)
        self._last = view
        for fn in list(self._subs.values()):
            fn(view)
        new_flags = sorted(scan.flagged - before)
        if new_flags and self._drift_subs:
            sig = DriftSignal(kind="pod_chip", set_indices=new_flags,
                              frac=len(new_flags) / self.pod.n_chips,
                              time_ms=self.pod.time_ms,
                              intervals=scan.drift_intervals)
            for fn in list(self._drift_subs.values()):
                fn(sig)
        return view

    def contention(self,
                   max_age_ms: Optional[float] = None) -> ContentionView:
        limit = (self.config.refresh_interval_ms if max_age_ms is None
                 else max_age_ms)
        if (self._last is None
                or self._last.age_ms(self.pod.time_ms) > limit):
            return self.refresh()
        return self._last

    # -- plans --------------------------------------------------------------
    def plan(self) -> ProbePlan:
        """The next monitoring window as data (inspect / cost / fuse)."""
        return self._ensure_scan().monitor_plan()

    def execute(self, plan: ProbePlan) -> PlanResult:
        return execute(self.vm, plan)

    def apply(self, plan: ProbePlan, result: PlanResult) -> ContentionView:
        scan = self._ensure_scan()
        snap = scan.apply_monitor(plan, result)
        self._intervals += 1
        view = self._build_view(snap)
        self._last = view
        for fn in list(self._subs.values()):
            fn(view)
        return view

    # -- subscriptions ------------------------------------------------------
    def subscribe(self, fn: Callable[[ContentionView], None],
                  fire_now: bool = False) -> int:
        token = self._next_sub
        self._next_sub += 1
        self._subs[token] = fn
        if fire_now and self._last is not None:
            fn(self._last)
        return token

    def subscribe_drift(self, fn: Callable[[DriftSignal], None]) -> int:
        token = self._next_sub
        self._next_sub += 1
        self._drift_subs[token] = fn
        return token

    def unsubscribe(self, token: int) -> None:
        self._subs.pop(token, None)
        self._drift_subs.pop(token, None)

    # -- persistence --------------------------------------------------------
    def export(self) -> Dict:
        data: Dict = {
            "format": POD_EXPORT_FORMAT, "platform": self.platform,
            "config": dataclasses.asdict(self.config),
            "mesh": dict(self.pod.mesh_shape),
            "pod_epoch": (self._probed_pod_epoch
                          if self._probed_pod_epoch is not None
                          else self.pod.hypercall_pod_epoch()),
            "abstraction_epoch": self.epoch}
        if self._vmem is not None:
            data["vmem"] = {str(c): int(b) for c, b in self._vmem.items()}
        if self._ici is not None:
            data["ici"] = {a: dict(s) for a, s in self._ici.items()}
        if self._scan is not None:
            data["scan"] = self._scan.state_dict()
        return data

    def export_json(self, path: Optional[str] = None) -> str:
        js = json.dumps(self.export(), indent=1, sort_keys=True)
        if path is not None:
            with open(path, "w") as f:
                f.write(js + "\n")
        return js

    @classmethod
    def import_(cls, sl: PodSlice, data: Dict,
                config: Optional[PodProbeConfig] = None,
                allow_stale: bool = False) -> "PodSession":
        """Re-attach an exported pod abstraction without re-probing; a
        reprovisioned pod (epoch bump) raises `StaleAbstractionError`
        unless ``allow_stale=True`` (then :meth:`repair` re-probes)."""
        if data.get("format") != POD_EXPORT_FORMAT:
            raise ValueError(f"not a {POD_EXPORT_FORMAT} export: "
                             f"{data.get('format')!r}")
        snap_epoch = data.get("pod_epoch")
        if snap_epoch is not None and not allow_stale:
            now = sl.host.hypercall_pod_epoch()
            if now != snap_epoch:
                raise StaleAbstractionError(
                    f"snapshot was probed at pod epoch {snap_epoch}, but "
                    f"the pod is now at epoch {now}: provisioning drifted "
                    f"(runtime upgrade / slice migration) and the probed "
                    f"VMEM budget and link health are no longer "
                    f"trustworthy.  Import with allow_stale=True and call "
                    f"repair() to re-probe.")
        if config is None:
            kw = dict(data["config"])
            kw["tier_thresholds"] = tuple(kw["tier_thresholds"])
            config = PodProbeConfig(**kw)
        session = cls(sl, data.get("platform", "pod"), config)
        session.epoch = int(data.get("abstraction_epoch", 0))
        session._probed_pod_epoch = snap_epoch
        if "vmem" in data:
            session._vmem = {int(c): int(b)
                             for c, b in data["vmem"].items()}
        if "ici" in data:
            session._ici = {a: dict(s) for a, s in data["ici"].items()}
        if "scan" in data:
            session._scan = PodScan.from_state(sl, data["scan"])
        return session

    @classmethod
    def import_json(cls, sl: PodSlice, js: str,
                    config: Optional[PodProbeConfig] = None,
                    allow_stale: bool = False) -> "PodSession":
        return cls.import_(sl, json.loads(js), config=config,
                           allow_stale=allow_stale)

    # -- drift / validation -------------------------------------------------
    def check_drift(self) -> Dict:
        scan = self._ensure_scan()
        now = self.pod.hypercall_pod_epoch()
        return {"flagged": sorted(scan.flagged),
                "pod_epoch_now": now,
                "probed_pod_epoch": self._probed_pod_epoch,
                "stale": (self._probed_pod_epoch is not None
                          and now != self._probed_pod_epoch)}

    def repair(self) -> Dict:
        """Re-probe the capacity stages and clear quarantines; bumps the
        abstraction epoch (the pod analogue of the LLC repair pass —
        capacity re-detection, not incremental set surgery)."""
        old_vmem = dict(self._vmem or {})
        self._vmem = None
        self._ici = None
        self._ensure_capacity()
        scan = self._ensure_scan()
        cleared = scan.confirm_clean(sorted(scan.flagged))
        self._probed_pod_epoch = self.pod.hypercall_pod_epoch()
        self.epoch += 1
        return {"epoch": self.epoch,
                "vmem_changed": {c: (old_vmem.get(c), b)
                                 for c, b in self._vmem.items()
                                 if old_vmem.get(c) != b},
                "cleared": cleared}

    def validate(self) -> Dict:
        """Check the abstraction against pod ground truth via the
        hypercall oracles — tests/benchmarks only, never a decision
        path (the §6.2 boundary)."""
        self._ensure_capacity()
        expected = ((NOMINAL_VMEM - self.pod.hypercall_reserved_vmem())
                    // self.config.vmem_align) * self.config.vmem_align
        vmem_ok = all(b == expected for b in self._vmem.values())
        link_ok = True
        for axis, s in self._ici.items():
            worst = max(self.pod.hypercall_link_slowdown(axis, h)
                        for h in range(self.pod.mesh_shape[axis]))
            if not math.isclose(s["slowdown"], worst, rel_tol=0.05):
                link_ok = False
        now = self.pod.hypercall_pod_epoch()
        return {"vmem_ok": vmem_ok, "expected_vmem": expected,
                "link_ok": link_ok, "pod_epoch_now": now,
                "stale": (self._probed_pod_epoch is not None
                          and now != self._probed_pod_epoch)}


class PodBackend:
    """`repro.core.backend.ProbeBackend` for TPU-pod tenant slices."""

    name = "pod"
    formats = (POD_EXPORT_FORMAT,)

    def attach(self, target: PodSlice, platform="pod", config=None,
               eager: bool = False) -> PodSession:
        return PodSession.attach(target, platform=str(platform),
                                 config=config, eager=eager)

    def import_(self, target: PodSlice, data: Dict, config=None,
                allow_stale: bool = False) -> PodSession:
        return PodSession.import_(target, data, config=config,
                                  allow_stale=allow_stale)


# ---------------------------------------------------------------------------
# the closed pod loop (probe → tier → reroute/rebalance → measure)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PodLoopReport:
    """One closed-loop pod run (FleetReport's posture: measured outcomes,
    not synthetic slowdowns)."""

    mode: str                    # rebalance "on" | "off"
    intervals: int
    warmup: int
    requests: int
    p99_decode_ms: float
    mean_decode_ms: float
    mean_step_s: float
    rebalances: int
    expert_moves: int
    hot_request_frac: float      # fraction of measured requests on hot chips
    staged_batches: int
    flagged_chips: Tuple[int, ...]


def _default_hbm_schedule(hot_chip: int, n_chips: int):
    """One chip under heavy co-located HBM traffic; the rest idle with a
    small fixed per-chip skew (so latency ordering is informative)."""
    def schedule(chip: int, t: float) -> float:
        if chip == hot_chip:
            return 2.4
        return 1.0 + 0.02 * (chip % 4)
    return schedule


def _default_link_schedule(axis_name: str, bad_hop: int):
    def schedule(axis: str, hop: int, t: float) -> float:
        if axis == axis_name and hop == bad_hop:
            return 1.8
        return 1.0
    return schedule


class PodFleetSim:
    """FleetSim-style closed pod loop over the seed LM-stack consumers.

    Per interval: the session :meth:`PodSession.refresh`-probes one
    monitoring window and publishes the ContentionView; subscribers act —
    `serve.engine.ReplicaRouter` tiers (decode rerouting),
    `distributed.rebalance.StragglerMitigator` (microbatch re-weighting),
    `distributed.rebalance.ExpertRebalancer` (MoE re-placement after tier
    commit), `data.pipeline.ColoredStagingPool` (staging into quiet
    zones) — then a real `serve.engine.Request` stream is routed and
    served and a training step is timed, both against the pod's *ground
    truth* slowdowns (act → measure, not act → assume).

    ``rebalance="off"`` detaches every subscriber: the probe still runs
    (same measurement cost), but nothing consumes it — the baseline the
    bench's on-vs-off delta is measured against.
    """

    def __init__(self, mesh_shape: Optional[Dict[str, int]] = None,
                 seed: int = 0, intervals: int = 40, warmup: int = 8,
                 rebalance: str = "on", requests_per_interval: int = 12,
                 base_decode_ms_per_token: float = 0.25,
                 max_new_tokens: int = 8, total_microbatches: int = 32,
                 n_experts: int = 16,
                 per_microbatch_s: float = 0.001):
        from repro_torch.data.pipeline import ColoredStagingPool
        from repro_torch.distributed.rebalance import (ExpertRebalancer,
                                                       StragglerMitigator)
        from repro_torch.serve.engine import ReplicaRouter

        self.mesh_shape = dict(mesh_shape or {"data": 2, "model": 4})
        self.intervals = intervals
        self.warmup = warmup
        self.rebalance = rebalance
        self.requests_per_interval = requests_per_interval
        self.base_decode_ms = base_decode_ms_per_token
        self.max_new = max_new_tokens
        self.per_microbatch_s = per_microbatch_s
        self.rng = np.random.default_rng(seed)

        n_chips = int(np.prod(list(self.mesh_shape.values())))
        self.hot_chip = n_chips // 2
        self.pod = SimPod(
            self.mesh_shape, seed=seed,
            hbm_schedule=_default_hbm_schedule(self.hot_chip, n_chips),
            link_schedule=_default_link_schedule(
                list(self.mesh_shape)[-1], 1))
        self.session = PodSession.attach(self.pod.slice(), eager=True)
        cfg = self.session.config
        self.router = ReplicaRouter(
            n_chips, tiers=TierTracker(keys=list(range(n_chips)),
                                       thresholds=list(
                                           cfg.tier_thresholds)))
        self.mitigator = StragglerMitigator(n_chips, total_microbatches)
        self.experts = ExpertRebalancer(
            n_experts, n_chips, experts_per_device=n_experts // n_chips,
            thresholds=cfg.tier_thresholds)
        self.staging = ColoredStagingPool.from_colors(
            self.session.colors(), bufs_per_zone=4)
        if rebalance == "on":
            self.session.subscribe(self.router.tiers.on_contention)
            self.session.subscribe(self.mitigator.on_contention)
            self.session.subscribe(self.experts.on_contention)
            self.session.subscribe(self.staging.on_contention)

    def run(self) -> PodLoopReport:
        from repro_torch.serve.engine import Request
        n_chips = self.pod.n_chips
        latencies: List[float] = []
        step_times: List[float] = []
        hot_hits = measured = staged = 0
        rid = 0
        expert_load = self.rng.zipf(1.5, self.experts.n_experts)
        for interval in range(self.intervals):
            self.session.refresh()
            # -- serve: one interval's request stream is in flight
            # together (load builds while routing, drains on completion)
            inflight: List[Request] = []
            for _ in range(self.requests_per_interval):
                req = Request(rid=rid,
                              prompt=np.zeros(4, np.int32),
                              max_new=self.max_new)
                rid += 1
                replica = self.router.assign(req)
                true_slow = self.pod.hypercall_chip_slowdown(replica)
                lat = self.max_new * self.base_decode_ms * true_slow
                if interval >= self.warmup:
                    latencies.append(lat)
                    measured += 1
                    if replica == self.hot_chip:
                        hot_hits += 1
                inflight.append(req)
            for req in inflight:
                self.router.complete(req)
            # -- train: one step under the current microbatch plan
            true = np.array([self.pod.hypercall_chip_slowdown(c)
                             for c in range(n_chips)])
            if interval >= self.warmup:
                step_times.append(self.mitigator.step_time(
                    true, per_microbatch_s=self.per_microbatch_s))
            # -- MoE router load drifts a little each interval
            expert_load = (0.9 * expert_load
                           + 0.1 * self.rng.zipf(
                               1.5, self.experts.n_experts))
            self.experts.update_load(expert_load)
            # -- data path: stage one batch through the colored pool
            h = self.staging.stage(np.zeros(8, np.int8))
            self.staging.release(h)
            staged += 1
        lat_arr = np.array(latencies)
        return PodLoopReport(
            mode=self.rebalance, intervals=self.intervals,
            warmup=self.warmup, requests=measured,
            p99_decode_ms=float(np.percentile(lat_arr, 99)),
            mean_decode_ms=float(lat_arr.mean()),
            mean_step_s=float(np.mean(step_times)),
            rebalances=self.mitigator.rebalances,
            expert_moves=self.experts.moves,
            hot_request_frac=hot_hits / max(measured, 1),
            staged_batches=staged,
            flagged_chips=tuple(sorted(
                self.session.monitored_sets().flagged)))


def run_pod_loop(rebalance: str = "on", seed: int = 0,
                 intervals: int = 40, warmup: int = 8,
                 mesh_shape: Optional[Dict[str, int]] = None
                 ) -> PodLoopReport:
    """One closed pod loop (the `run_fleet` analogue; bench + CI entry)."""
    return PodFleetSim(mesh_shape=mesh_shape, seed=seed,
                       intervals=intervals, warmup=warmup,
                       rebalance=rebalance).run()
