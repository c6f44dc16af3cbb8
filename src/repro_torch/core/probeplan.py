"""ProbePlan — a declarative probe IR under every measurement.

Every probe the measurement stack performs — MLP priming traversals, timed
Prime+Probe lanes, majority-voted eviction verdicts, scan-interval waits —
compiles to a small dataclass program of batched access-stream ops, and ONE
executor lowers those programs onto the guest probing surface:

  ===========  ==============================================================
  op           lowering
  ===========  ==============================================================
  ``Commit``   committed multi-thread traversal, segments fused into one
               dispatch (``GuestVM.access_segments`` →
               ``cachesim.access_stream``); the prime / install / traverse
               edge of Prime+Probe
  ``Wait``     scan interval: advance the virtual clock, co-tenants run
  ``WarmTimer``  dummy RDTSC reads (the paper's §3.1 guest-TSC fix)
  ``Measure``  B uncommitted timed lanes in one dispatch
               (``GuestVM.timed_access_batch`` →
               ``cachesim.access_streams_batched``, the batched multi-set
               engine: ``csrc/cachesim_engine.cu`` on the card)
  ``Vote``     majority-voted eviction verdicts: ``votes`` Measure rounds,
               the vote index salting each lane's rng fork, reduced to one
               bool per lane (``last-access latency > threshold``)
  ``Validate`` cheap self-eviction validity check of already-built eviction
               sets: one ``[spare, members, spare]`` lane per set, lowered
               exactly like ``Vote`` — verdict True means the set still
               evicts its congruent spare line, i.e. it survived host drift
               (page remapping / repartitioning); the drift-repair pipeline
               (`VEV.validate_sets` → `repair_sets`) is built on it
  ===========  ==============================================================

Why an IR instead of stage-specific driver loops: plans are *data*.  A
caller can inspect what a stage is about to probe, :func:`fuse`
structurally-congruent plans into one program whose ops share dispatches
(VEV's multi-partition lockstep construction), re-run a plan against fresh
state, and — the fleet-scale payoff — execute N guests' plans as ONE
vectorized program via :func:`execute_many`, which batches every op over
guests (``cachesim.access_streams_committed`` /
``access_streams_batched_multi``): one dispatch per op per *tick*, not per
guest.  Per-guest results are bit-identical to single-guest execution
(integer arithmetic end to end; each guest keeps its own machine state,
rng salt and guest-TSC noise stream).

:class:`PlanLowering` carries the per-platform lowering hints
(``CachePlatform.plan_lowering()``): whether committed segments may fuse
(exact under LRU; non-deterministic replacement keeps per-segment
dispatches so trials replay the sequential path bit for bit), padding
bucket sizes, and whether multi-guest lockstep execution is allowed.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.core.host_model import (GuestVM, commit_segments_sharded,
                                         timed_access_batch_sharded)


@dataclasses.dataclass(frozen=True)
class PlanLowering:
    """Per-platform plan-lowering hints (``CachePlatform.plan_lowering()``).

    ``fuse_commits``   fuse a Commit op's segments into one dispatch.  Exact
                       under LRU (the stream is replayed access by access in
                       order); non-LRU platforms keep one dispatch per
                       segment so replacement trials match the sequential
                       path bit for bit.
    ``lane_bucket``    Measure/Vote lane-length padding granularity (T).
    ``batch_bucket``   Measure/Vote lane-count padding granularity (B).
    ``lockstep``       whether plans of co-running guests may execute as one
                       vectorized program (:func:`execute_many`); requires
                       deterministic (LRU) replacement for bit-identity.
    ``shard_size``     lockstep guest-shard size: ``execute_many`` splits G
                       co-running guests into ``ceil(G / shard_size)``
                       groups and issues one multi-guest dispatch per
                       group per op (`host_model.commit_segments_sharded` /
                       `timed_access_batch_sharded`).  ``None`` keeps the
                       single whole-fleet dispatch.  Sharding bounds the
                       stacked-state footprint of any one dispatch and
                       reuses one ``(shard, ...)`` compile shape across
                       fleet sizes; per-guest results are bit-identical at
                       any shard size (`repro_torch.core.fleetshard` picks it).
    """

    fuse_commits: bool = True
    lane_bucket: int = 128
    batch_bucket: int = 8
    lockstep: bool = True
    shard_size: Optional[int] = None


DEFAULT_LOWERING = PlanLowering()


# ---------------------------------------------------------------------------
# ops
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Segment:
    """One thread's slice of a committed traversal."""

    gvas: np.ndarray
    vcpu: int = 0


@dataclasses.dataclass(frozen=True)
class Commit:
    """Committed access-stream traversal (prime / install / traverse):
    segments run back to back, each from its own vCPU.  No output."""

    segments: Tuple[Segment, ...]


@dataclasses.dataclass(frozen=True)
class Wait:
    """Scan interval: advance the virtual clock by ``ms`` (co-located VMs
    keep running; the guest TSC goes cold).  No output."""

    ms: float


@dataclasses.dataclass(frozen=True)
class WarmTimer:
    """Dummy RDTSC reads before a timed probe (§3.1).  No output."""


@dataclasses.dataclass(frozen=True)
class Measure:
    """B uncommitted timed lanes in one batched dispatch.  Output: a list
    of per-lane int64 latency arrays (trimmed to lane length).

    ``level`` declares which cache level the lanes probe (``"l2"`` |
    ``"llc"`` | ``"mixed"`` when one dispatch carries lanes of both) —
    pure metadata for plan introspection, cost attribution and the
    tune-cache key (`repro_torch.core.plancost`); consumers threshold the
    returned latencies themselves."""

    lanes: Tuple[np.ndarray, ...]
    vcpus: Tuple[int, ...]
    salt: int = 0
    level: str = "llc"


@dataclasses.dataclass(frozen=True)
class Vote:
    """Majority-voted eviction verdicts: ``votes`` Measure rounds over the
    same lanes (vote index = rng salt), each lane's verdict ``last-access
    latency > threshold``, majority-reduced.  Output: bool array (B,).

    ``level`` names the cache level the ``threshold`` encodes — it keeps
    per-level plans self-describing (and separately tune-cacheable)
    without consumers reverse-engineering the level from the threshold."""

    lanes: Tuple[np.ndarray, ...]
    vcpus: Tuple[int, ...]
    threshold: int
    votes: int = 1
    level: str = "llc"


@dataclasses.dataclass(frozen=True)
class Validate:
    """Self-eviction validity check of built eviction sets: one
    ``[spare, members*, spare]`` Prime+Probe lane per set, ``votes``
    rounds, majority-reduced.  Output: bool array (B,) — True = the set
    still evicts its spare (valid), False = drift broke it (or the spare
    itself drifted; validation errs toward repair).  Structurally a
    ``Vote`` — the distinct kind makes drift-repair plans self-describing
    and lets harnesses count validation cost separately.  ``level`` names
    the cache level validated (see :class:`Vote`)."""

    lanes: Tuple[np.ndarray, ...]
    vcpus: Tuple[int, ...]
    threshold: int
    votes: int = 1
    level: str = "llc"


ProbeOp = Union[Commit, Wait, WarmTimer, Measure, Vote, Validate]


@dataclasses.dataclass(frozen=True)
class ProbePlan:
    """An ordered program of probe ops plus lowering hints.

    ``meta`` carries stage-private bookkeeping (e.g. VSCAN's lane →
    monitored-set order) that result appliers need; the executor never
    reads it.
    """

    ops: Tuple[ProbeOp, ...]
    label: str = ""
    hints: Optional[PlanLowering] = None
    meta: Dict = dataclasses.field(default_factory=dict)

    def signature(self) -> Tuple[str, ...]:
        """Structural signature: op kind per position (congruence key for
        :func:`fuse` / :func:`execute_many`, and the tune-cache key in
        `repro_torch.core.plancost`) — lowering-independent by design.  Batched
        ops probing a non-default cache level carry it as a suffix
        (``"Vote[l2]"``), so per-level plans fuse / tune-cache separately
        while every existing LLC plan keeps its signature verbatim."""
        names = []
        for op in self.ops:
            name = type(op).__name__
            level = getattr(op, "level", "llc")
            names.append(name if level == "llc" else f"{name}[{level}]")
        return tuple(names)

    def effective_lowering(self) -> PlanLowering:
        """The lowering :func:`execute` will actually use — the plan's
        hints, or :data:`DEFAULT_LOWERING` when it carries none."""
        return self.hints or DEFAULT_LOWERING

    @property
    def n_dispatches(self) -> int:
        """Dispatches one execution of this plan will issue under its
        *effective* lowering: an unfused Commit (``fuse_commits=False``,
        what ``plan_lowering()`` forces on non-LRU platforms) is one
        dispatch per non-empty segment, not one fused dispatch — counting
        from the requested lowering made model and measurement disagree
        exactly there."""
        hints = self.effective_lowering()
        n = 0
        for op in self.ops:
            if isinstance(op, Commit):
                live = sum(1 for s in op.segments if len(s.gvas))
                n += (1 if hints.fuse_commits else live) if live else 0
            elif isinstance(op, Measure):
                n += 1 if op.lanes else 0
            elif isinstance(op, (Vote, Validate)):
                n += op.votes if op.lanes else 0
        return n

    def cost(self, lowering: Optional[PlanLowering] = None, platform=None,
             n_guests: int = 1):
        """Predicted execution cost (`repro_torch.core.plancost.plan_cost`):
        dispatches, padded lane work, compile hits/misses, wall estimate."""
        from repro_torch.core import plancost
        return plancost.plan_cost(self, lowering=lowering,
                                  platform=platform, n_guests=n_guests)


@dataclasses.dataclass(frozen=True)
class PlanResult:
    """Per-op outputs of one plan execution (``None`` for output-free
    ops, aligned with ``plan.ops``)."""

    values: Tuple

    def __getitem__(self, i: int):
        return self.values[i]

    @property
    def last(self):
        """Output of the final op (the probe, by Prime+Probe convention)."""
        return self.values[-1]


# ---------------------------------------------------------------------------
# the executor
# ---------------------------------------------------------------------------

def _measure(vm: GuestVM, lanes, vcpus, salt, hints: PlanLowering):
    if not lanes:
        return []
    return vm.timed_access_batch(list(lanes), vcpu=list(vcpus), salt=salt,
                                 lane_bucket=hints.lane_bucket,
                                 batch_bucket=hints.batch_bucket)


def _vote(vm: GuestVM, op: Union[Vote, Validate],
          hints: PlanLowering) -> np.ndarray:
    hits = np.zeros(len(op.lanes), np.int64)
    for vote in range(op.votes):
        lats = _measure(vm, op.lanes, op.vcpus, vote, hints)
        hits += np.array([int(l[-1] > op.threshold) for l in lats],
                         np.int64)
    return hits * 2 > op.votes


def execute(vm: GuestVM, plan: ProbePlan) -> PlanResult:
    """Run one plan against one guest.  Op order is program order; every
    batched op is one dispatch (``Vote``: one per vote round)."""
    hints = plan.hints or DEFAULT_LOWERING
    out: List = []
    for op in plan.ops:
        if isinstance(op, Commit):
            if hints.fuse_commits:
                vm.access_segments([(s.gvas, s.vcpu) for s in op.segments])
            else:
                for s in op.segments:
                    if len(s.gvas):
                        vm.access(s.gvas, vcpu=s.vcpu)
            out.append(None)
        elif isinstance(op, Wait):
            vm.wait_ms(op.ms)
            out.append(None)
        elif isinstance(op, WarmTimer):
            vm.warm_timer()
            out.append(None)
        elif isinstance(op, Measure):
            out.append(_measure(vm, op.lanes, op.vcpus, op.salt, hints))
        elif isinstance(op, (Vote, Validate)):
            out.append(_vote(vm, op, hints))
        else:
            raise TypeError(f"unknown probe op {op!r}")
    return PlanResult(values=tuple(out))


# ---------------------------------------------------------------------------
# fusion (same guest: N congruent plans -> one program sharing dispatches)
# ---------------------------------------------------------------------------

def fuse(plans: Sequence[ProbePlan]) -> Tuple[ProbePlan, List[List[slice]]]:
    """Merge structurally-congruent plans into one plan whose batched ops
    share dispatches: Commit segments and Measure/Vote lanes concatenate in
    plan order (Vote thresholds/votes and Wait durations must agree).
    Returns ``(fused, spans)`` where ``spans[i][j]`` slices plan ``i``'s
    share out of fused op ``j``'s output (see :func:`split_result`)."""
    if not plans:
        raise ValueError("nothing to fuse")
    sig = plans[0].signature()
    for p in plans[1:]:
        if p.signature() != sig:
            raise ValueError(f"cannot fuse structurally different plans: "
                             f"{sig} vs {p.signature()}")
    ops: List[ProbeOp] = []
    spans: List[List[slice]] = [[] for _ in plans]
    for j in range(len(sig)):
        cur = [p.ops[j] for p in plans]
        op0 = cur[0]
        if isinstance(op0, Commit):
            segs: List[Segment] = []
            for i, op in enumerate(cur):
                segs.extend(op.segments)
                spans[i].append(slice(0, 0))
            ops.append(Commit(segments=tuple(segs)))
        elif isinstance(op0, (Measure, Vote, Validate)):
            lanes: List[np.ndarray] = []
            vcpus: List[int] = []
            for i, op in enumerate(cur):
                spans[i].append(slice(len(lanes), len(lanes) + len(op.lanes)))
                lanes.extend(op.lanes)
                vcpus.extend(op.vcpus)
            if isinstance(op0, (Vote, Validate)):
                if any((op.threshold, op.votes, op.level)
                       != (op0.threshold, op0.votes, op0.level)
                       for op in cur):
                    raise ValueError("cannot fuse Votes with different "
                                     "threshold/votes/level")
                ops.append(type(op0)(lanes=tuple(lanes), vcpus=tuple(vcpus),
                                     threshold=op0.threshold,
                                     votes=op0.votes, level=op0.level))
            else:
                if any(op.salt != op0.salt for op in cur):
                    raise ValueError("cannot fuse Measures with different "
                                     "salts")
                ops.append(Measure(lanes=tuple(lanes), vcpus=tuple(vcpus),
                                   salt=op0.salt, level=op0.level))
        elif isinstance(op0, Wait):
            if any(op.ms != op0.ms for op in cur):
                raise ValueError("cannot fuse Waits of different lengths")
            ops.append(op0)
            for s in spans:
                s.append(slice(0, 0))
        else:   # WarmTimer
            ops.append(op0)
            for s in spans:
                s.append(slice(0, 0))
    fused = ProbePlan(ops=tuple(ops),
                      label="+".join(dict.fromkeys(p.label for p in plans)),
                      hints=plans[0].hints)
    return fused, spans


def split_result(result: PlanResult,
                 spans: List[List[slice]]) -> List[PlanResult]:
    """Undo :func:`fuse`: slice each constituent plan's outputs back out of
    the fused execution's result."""
    out = []
    for plan_spans in spans:
        vals = []
        for v, sl in zip(result.values, plan_spans):
            vals.append(None if v is None else v[sl])
        out.append(PlanResult(values=tuple(vals)))
    return out


# ---------------------------------------------------------------------------
# vectorized execution over guests
# ---------------------------------------------------------------------------

def execute_many(vms: Sequence[GuestVM],
                 plans: Sequence[ProbePlan]) -> List[PlanResult]:
    """Run G structurally-congruent plans — one per guest, each guest on
    its own host — as ONE vectorized program: every Commit / Measure is a
    single dispatch vmapped over guests (``Vote``: one per vote round);
    Wait / WarmTimer apply per guest (each guest keeps its own window).
    Per-guest results are bit-identical to ``execute(vms[i], plans[i])``
    under deterministic (LRU) replacement — the ``PlanLowering.lockstep``
    hint gates callers accordingly.

    A ``PlanLowering.shard_size`` hint shards the group: each batched op
    issues one multi-guest dispatch per ``shard_size`` guests (the
    rack-scale lowering — `repro_torch.core.fleetshard`) instead of one for the
    whole group; results stay bit-identical at any shard size."""
    if len(vms) != len(plans):
        raise ValueError("one plan per guest")
    if not plans:
        return []
    if len(plans) == 1:
        return [execute(vms[0], plans[0])]
    sig = plans[0].signature()
    for p in plans[1:]:
        if p.signature() != sig:
            raise ValueError(f"cannot co-execute structurally different "
                             f"plans: {sig} vs {p.signature()}")
    hints = plans[0].hints or DEFAULT_LOWERING
    vms = list(vms)
    shard = hints.shard_size
    outs: List[List] = [[] for _ in plans]
    for j, sig_kind in enumerate(sig):
        kind = sig_kind.split("[", 1)[0]   # strip the level suffix
        ops = [p.ops[j] for p in plans]
        if kind == "Commit":
            commit_segments_sharded(
                vms, [[(s.gvas, s.vcpu) for s in op.segments]
                      for op in ops], shard_size=shard)
            for o in outs:
                o.append(None)
        elif kind == "Wait":
            for vm, op in zip(vms, ops):
                vm.wait_ms(op.ms)
            for o in outs:
                o.append(None)
        elif kind == "WarmTimer":
            for vm in vms:
                vm.warm_timer()
            for o in outs:
                o.append(None)
        elif kind == "Measure":
            if any(op.salt != ops[0].salt for op in ops):
                raise ValueError("cannot co-execute Measures with "
                                 "different salts")
            res = timed_access_batch_sharded(
                vms, [op.lanes for op in ops], [op.vcpus for op in ops],
                salt=ops[0].salt, lane_bucket=hints.lane_bucket,
                batch_bucket=hints.batch_bucket, shard_size=shard)
            for o, r in zip(outs, res):
                o.append(r)
        elif kind in ("Vote", "Validate"):
            op0 = ops[0]
            if any((op.threshold, op.votes) != (op0.threshold, op0.votes)
                   for op in ops):
                raise ValueError("cannot co-execute Votes with different "
                                 "threshold/votes")
            hits = [np.zeros(len(op.lanes), np.int64) for op in ops]
            for vote in range(op0.votes):
                res = timed_access_batch_sharded(
                    vms, [op.lanes for op in ops],
                    [op.vcpus for op in ops], salt=vote,
                    lane_bucket=hints.lane_bucket,
                    batch_bucket=hints.batch_bucket, shard_size=shard)
                for h, lats, op in zip(hits, res, ops):
                    h += np.array([int(l[-1] > op.threshold)
                                   for l in lats], np.int64)
            for o, h in zip(outs, hits):
                o.append(h * 2 > op0.votes)
        else:
            raise TypeError(f"unknown probe op kind {kind}")
    return [PlanResult(values=tuple(o)) for o in outs]
