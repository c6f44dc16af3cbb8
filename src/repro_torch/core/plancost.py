"""PlanCost — analytic ProbePlan cost model + measured lowering autotuner.

The ProbePlan IR made probing *inspectable*; this module makes it
*costable* (the Com-CAS / dace shape: a predictive cost model over an IR,
plus a tuner that measures candidate lowerings on small extracted
cutouts):

  * :func:`plan_cost` — an analytic model predicting, for any
    ``ProbePlan`` x ``PlanLowering`` x ``CachePlatform``:

      - ``dispatches``        engine launches one execution issues
                              (lockstep: shared across all guests),
      - ``padded_steps``      total padded lane-work elements, derived
                              with the executor's own bucket+ladder math
                              (:func:`plan_shapes`),
      - ``compile_hits/misses``  how many of those dispatches repeat a
                              shape the process has already dispatched —
                              predicted against :data:`SHAPE_CACHE`, the
                              process-wide dispatch-shape cache every
                              physical dispatch feeds
                              (`host_model._note_shape`),
      - ``est_wall_s``        ``COMPILE_S*misses + DISPATCH_OVERHEAD_S*
                              dispatches + STEP_COST_S*padded_steps``, with
                              the dominant term labeled.

    The counts are the same on any device and match the JAX package's
    model term for term.

  * :func:`tune_lowering` — a measured autotuner: extracts small plan
    *cutouts* (one Measure lane-bucket, one fused commit group, one Vote
    round as a 2-guest lockstep dispatch), times 2-4 candidate lowerings
    per knob (``fuse_commits`` on/off, ``lane_bucket`` in {32, 64, 128,
    full}, ``lockstep`` on/off) on scratch VMs booted from the platform on
    ``device`` (None: the CUDA card), scores ``COMPILE_S *
    predicted_misses + HORIZON * measured``, and caches the winning
    :class:`PlanLowering` per (platform, plan-signature, n_guests) —
    ``plan_lowering()`` becomes a default the tuner overrides
    (``CacheXSession.tuned_lowering`` / ``FleetSim.tune`` /
    ``run_cachex(tune=True)`` request it).  ``measure=False`` runs the
    same candidate scan purely on the analytic model (microseconds; the
    default for inline session use).

The tuner's cutout dispatches leave no trace in the workload's
accounting: both the probe-dispatch counter and :data:`SHAPE_CACHE` are
snapshot/restored around timing, so tuning decisions depend only on what
the *workload* has dispatched, never on tuner history (this is what makes
repeated tunes deterministic).  The engine's launch counters
(`repro_torch._build.LAUNCHES`) do count the cutouts: they were launched.

The three device costs were measured for the CUDA engine by
``chip_smoke.py`` (``measure_cost_constants``) on one NVIDIA H100 80GB
HBM3 at a 700.00 W power limit; each is the median of three whole runs of
that script, which ranged 2.48-3.93e-4, 2.73-6.25e-4 and 2.60-5.61e-8 s
(host clock).  They matter through their ratios: ``DISPATCH_OVERHEAD_S``
is the host time of one minimal engine dispatch with its synchronizing
copy, ``STEP_COST_S`` the slope of dispatch time over padded lane-work
elements, and ``COMPILE_S`` the extra host time of a new padded shape's
first dispatch over a repeat.  The engine compiles nothing per shape, so
``COMPILE_S`` measures allocation and first-touch noise: -0.01 to 1.60 ms
per shape, on the median about one dispatch.  It is still the term that
weighs lockstep's shared shapes against per-guest ones, so
``chip_smoke.py`` reports every model choice (lowering, shard) that its
freshly measured constants would change against these.  ``HORIZON`` encodes the paper's long-running-monitor posture —
a tuned plan is executed many times, so one-time costs amortize while
per-execution lane work and dispatch overhead recur.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from repro_torch.core.host_model import (_BATCH_BUCKET, _DISPATCH_STATS,
                                         _LANE_BUCKET, _STREAM_BUCKET, _ladder,
                                         _round_up, GuestVM, shard_slices,
                                         timed_access_batch_multi)
from repro_torch.core.probeplan import (Commit, DEFAULT_LOWERING, Measure,
                                        PlanLowering, ProbePlan, Validate,
                                        Vote)


# -- model constants: measured for the CUDA engine by
#    chip_smoke.measure_cost_constants on one NVIDIA H100 80GB HBM3 at a
#    700.00 W power limit, the median of three runs (host clock; see the
#    module docstring)
COMPILE_S = 3.01e-4       # a new padded shape's first dispatch over a repeat
DISPATCH_OVERHEAD_S = 3.75e-4  # one minimal dispatch + its synchronizing copy
STEP_COST_S = 3.75e-8     # per padded lane-work element
HORIZON = 250             # plan executions a tuned lowering amortizes over
SWITCH_MARGIN = 0.10      # a challenger must beat the incumbent by 10%:
                          # near-ties keep the platform default, so repeated
                          # tunes are deterministic under timing jitter
                          # (cutout timings are sub-ms; min-of-reps floors
                          # are stable but not to single-digit percent)

#: lane_bucket candidates the tuner times; 1 = "full" (pad to the exact
#: max lane length — the pow2 ladder still applies on top, like the
#: executor does).
LANE_BUCKET_CANDIDATES = (32, 64, 128, 1)


# ---------------------------------------------------------------------------
# the dispatch-shape cache
# ---------------------------------------------------------------------------

class ShapeCache:
    """Process-wide registry of already-dispatched engine shapes.

    Every physical dispatch notes its ``(kernel kind, MachineGeometry,
    padded shape)`` here (`host_model._note_shape`), so the cost model can
    tell a shape this process has already dispatched (a hit) from a new
    one (a miss).
    """

    def __init__(self) -> None:
        self._seen: Set[Tuple] = set()
        self.hits = 0
        self.misses = 0

    def note(self, kind: str, geom, shape: Sequence[int]) -> None:
        key = (kind, geom, tuple(int(x) for x in shape))
        if key in self._seen:
            self.hits += 1
        else:
            self.misses += 1
            self._seen.add(key)

    def seen(self, kind: str, geom, shape: Sequence[int]) -> bool:
        """Membership test; ``geom=None`` matches the shape under any
        geometry (platform-agnostic queries)."""
        shape = tuple(int(x) for x in shape)
        if geom is not None:
            return (kind, geom, shape) in self._seen
        return any(k == kind and s == shape for k, _, s in self._seen)

    def shapes(self) -> List[Tuple]:
        return list(self._seen)

    def __len__(self) -> int:
        return len(self._seen)

    def snapshot(self) -> Tuple:
        return (set(self._seen), self.hits, self.misses)

    def restore(self, snap: Tuple) -> None:
        self._seen, self.hits, self.misses = set(snap[0]), snap[1], snap[2]

    def clear(self) -> None:
        self._seen.clear()
        self.hits = self.misses = 0


#: The process-wide instance `host_model._note_shape` feeds.
SHAPE_CACHE = ShapeCache()


# ---------------------------------------------------------------------------
# the analytic model
# ---------------------------------------------------------------------------

def plan_shapes(plan: ProbePlan, lowering: Optional[PlanLowering] = None,
                n_guests: int = 1) -> List[Tuple[str, Tuple[int, ...]]]:
    """The (kernel kind, padded shape) of every dispatch one execution of
    ``plan`` issues under ``lowering`` — the executor's own bucket+ladder
    padding math, without running anything.  ``n_guests > 1`` with a
    lockstep-capable lowering models `execute_many`: one multi-guest
    dispatch per op for the whole co-running group — or, when the lowering
    carries a ``shard_size``, one per guest shard (``ceil(n_guests /
    shard_size)`` dispatches per op, each of stacked shape ``(shard,
    ...)``, mirroring the sharded executor exactly)."""
    hints = lowering or plan.hints or DEFAULT_LOWERING
    multi = n_guests > 1 and hints.lockstep
    groups = ([sl.stop - sl.start
               for sl in shard_slices(n_guests, hints.shard_size)]
              if multi else [n_guests])
    shapes: List[Tuple[str, Tuple[int, ...]]] = []

    def measure_shape(op, g: int) -> Tuple[str, Tuple[int, ...]]:
        b = _ladder(_round_up(len(op.lanes),
                              hints.batch_bucket or _BATCH_BUCKET))
        t = _ladder(_round_up(max((len(l) for l in op.lanes), default=1),
                              hints.lane_bucket or _LANE_BUCKET))
        if multi:
            return ("batched_multi", (g, b, t))
        return ("batched", (b, t))

    for op in plan.ops:
        if isinstance(op, Commit):
            live = [s for s in op.segments if len(s.gvas)]
            if not live:
                continue
            total = sum(len(s.gvas) for s in live)
            if multi:
                shapes.extend(("committed",
                               (g, _round_up(total, _STREAM_BUCKET)))
                              for g in groups)
            elif hints.fuse_commits:
                shapes.append(("stream", (_round_up(total, _STREAM_BUCKET),)))
            else:
                shapes.extend(("stream",
                               (_round_up(len(s.gvas), _STREAM_BUCKET),))
                              for s in live)
        elif isinstance(op, Measure):
            if op.lanes:
                shapes.extend(measure_shape(op, g) for g in groups)
        elif isinstance(op, (Vote, Validate)):
            if op.lanes:
                shapes.extend([measure_shape(op, g) for g in groups]
                              * op.votes)
    return shapes


@dataclasses.dataclass(frozen=True)
class PlanCost:
    """Predicted cost of one plan execution (see :func:`plan_cost`).

    ``dominant`` labels the binding term of ``est_wall_s``: ``compile``
    (new dispatch shapes), ``dispatch`` (launch overhead), or ``steps``
    (padded lane work).
    """

    dispatches: int
    padded_steps: int
    compile_hits: int
    compile_misses: int
    est_wall_s: float
    dominant: str
    shapes: Tuple[Tuple[str, Tuple[int, ...]], ...]


def plan_cost(plan: ProbePlan, lowering: Optional[PlanLowering] = None,
              platform=None, n_guests: int = 1,
              shape_cache: Optional[ShapeCache] = None) -> PlanCost:
    """Predict dispatch count, padded lane work, shape hits/misses and a
    wall estimate for one execution of ``plan`` under ``lowering`` on
    ``platform`` (a :class:`~repro_torch.core.platforms.CachePlatform`;
    None matches cached shapes geometry-agnostically).  A shape is a miss
    only the first time it appears — across ``shape_cache`` (default: the
    process-wide :data:`SHAPE_CACHE`) *and* within this plan's own
    dispatch walk."""
    shapes = plan_shapes(plan, lowering, n_guests)
    geom = platform.machine() if platform is not None else None
    cache = SHAPE_CACHE if shape_cache is None else shape_cache
    new_here: Set[Tuple] = set()
    hits = misses = steps = 0
    for kind, shape in shapes:
        steps += int(np.prod(shape))
        if cache.seen(kind, geom, shape) or (kind, shape) in new_here:
            hits += 1
        else:
            misses += 1
            new_here.add((kind, shape))
    terms = {"compile": COMPILE_S * misses,
             "dispatch": DISPATCH_OVERHEAD_S * len(shapes),
             "steps": STEP_COST_S * steps}
    return PlanCost(dispatches=len(shapes), padded_steps=steps,
                    compile_hits=hits, compile_misses=misses,
                    est_wall_s=sum(terms.values()),
                    dominant=max(terms, key=terms.get),
                    shapes=tuple(shapes))


# ---------------------------------------------------------------------------
# the measured autotuner
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Trial:
    """One candidate lowering the tuner evaluated for one knob."""

    knob: str                 # "lane_bucket" | "fuse_commits" | "lockstep"
    candidate: str            # e.g. "64", "full", "fused", "lockstep_off"
    cutout: Tuple[int, ...]   # padded shape of the timed cutout dispatch
    measured_s: float         # min-of-reps warm cutout wall (0.0 if model-only)
    pred_misses: int          # predicted new dispatch shapes for the candidate
    score: float              # COMPILE_S*pred_misses + HORIZON*measured term
    chosen: bool = False


@dataclasses.dataclass(frozen=True)
class TuneReport:
    """Outcome of one :func:`tune_lowering` call.

    ``measured=False`` means the candidate scan ran purely on the analytic
    model; ``cached=True`` means the whole report was served from the
    per-(platform, plan-signature, n_guests) tune cache without re-timing.
    """

    platform: str
    signature: Tuple[str, ...]
    n_guests: int
    chosen: PlanLowering
    trials: Tuple[Trial, ...]
    measured: bool
    cached: bool = False


_TUNE_CACHE: Dict[Tuple, TuneReport] = {}


def clear_tune_cache() -> None:
    _TUNE_CACHE.clear()


def _cutout_spec(plan: Optional[ProbePlan], platform) -> Tuple[int, int,
                                                               List[int]]:
    """Cutout dimensions extracted from the plan: (lane count capped at one
    batch bucket, lane length, committed segment lengths).  Falls back to
    platform geometry (ways+1-line probe lanes) when the plan lacks the op
    kind."""
    lane_len = int(platform.effective_ways) + 1
    n_lanes = _BATCH_BUCKET
    seg_lens = [lane_len * 4] * 2
    if plan is not None:
        for op in plan.ops:
            if isinstance(op, (Measure, Vote, Validate)) and op.lanes:
                n_lanes = min(len(op.lanes), _BATCH_BUCKET)
                lane_len = min(max(len(l) for l in op.lanes), 256)
                break
        for op in plan.ops:
            if isinstance(op, Commit):
                live = [len(s.gvas) for s in op.segments if len(s.gvas)]
                if live:
                    seg_lens = [min(n, 512) for n in live[:4]]
                    break
    return n_lanes, int(lane_len), seg_lens


def _scratch_vm(platform, seed: int, device=None) -> GuestVM:
    """A throwaway VM on its own host on ``device``: cutouts must not
    perturb the real guest's machine state, probe-seq or timer warmth."""
    _, vm = platform.make_host_vm(seed=seed, n_guest_pages=256,
                                  mapping="contiguous", n_host_pages=512,
                                  with_noise=False, device=device)
    return vm


def _cutout_lanes(vm: GuestVM, n_lanes: int, lane_len: int) -> List:
    """Timing lanes over the scratch VM's pages (wrapping — the cutout
    times kernel shapes, it measures nothing)."""
    return [np.array([vm.gva((i * 31 + j) % vm.n_guest_pages, 0)
                      for j in range(lane_len)], np.int64)
            for i in range(n_lanes)]


def _segments(vm: GuestVM, seg_lens: List[int]) -> List[Tuple[np.ndarray,
                                                              int]]:
    return [(np.array([vm.gva((i * 61 + j) % vm.n_guest_pages, 0)
                       for j in range(n)], np.int64), 0)
            for i, n in enumerate(seg_lens)]


def _time_cutouts(fns: List, reps: int) -> List[float]:
    """Min-of-``reps`` wall time for each thunk, measured *interleaved*
    (A, B, A, B, ...) rather than block-per-candidate: a transient
    contention spike then inflates every candidate's slow reps equally
    instead of poisoning one candidate's whole block, which is what keeps
    repeated tunes deterministic on a noisy host."""
    for fn in fns:
        fn()                               # first call warms up (excluded)
    best = [float("inf")] * len(fns)
    for _ in range(reps):
        for i, fn in enumerate(fns):
            t0 = time.perf_counter()
            fn()
            best[i] = min(best[i], time.perf_counter() - t0)
    return best


def tune_lowering(platform, plan: Optional[ProbePlan] = None,
                  n_guests: int = 1, seed: int = 0,
                  horizon: float = HORIZON, measure: bool = True,
                  force: bool = False, reps: int = 7,
                  device=None) -> TuneReport:
    """Pick a :class:`PlanLowering` for ``plan`` on ``platform`` (see
    module docstring for the knob grid and scoring).  ``device`` holds
    the scratch VMs a measured tune times its cutouts on (None: the CUDA
    card); a model-only tune (``measure=False``) boots none.  Results are cached
    per (platform name, plan signature, n_guests); ``force=True``
    re-tunes.  Non-LRU replacement locks ``fuse_commits``/``lockstep`` off
    (correctness, not cost — fused/padded trials would not replay the
    sequential path bit for bit) and only ``lane_bucket`` is tuned."""
    sig = plan.signature() if plan is not None else ()
    key = (platform.name, sig, int(n_guests))
    if not force and key in _TUNE_CACHE:
        hit = _TUNE_CACHE[key]
        # a model-only result never satisfies a measured request
        if hit.measured or not measure:
            return dataclasses.replace(hit, cached=True)

    base = platform.plan_lowering()
    lru = platform.replacement == "lru"
    n_lanes, lane_len, seg_lens = _cutout_spec(plan, platform)
    ref = plan if plan is not None else _synthetic_plan(
        platform, n_lanes, lane_len, seg_lens)
    cache_snap = SHAPE_CACHE.snapshot()
    pred_cache = ShapeCache()
    pred_cache.restore(cache_snap)
    dispatch_snap = dict(_DISPATCH_STATS)

    def pred_misses(cand: PlanLowering, guests: int = 1) -> int:
        return plan_cost(ref, cand, platform=platform, n_guests=guests,
                         shape_cache=pred_cache).compile_misses

    trials: List[Trial] = []
    try:
        vm = _scratch_vm(platform, seed, device) if measure else None
        lanes = _cutout_lanes(vm, n_lanes, lane_len) if measure else None

        # -- lane_bucket: one Measure lane-bucket cutout per candidate ------
        # Candidates whose padding collapses to the same cutout shape are
        # one trial (e.g. "full" == 32 for short lanes) — keeps the scan
        # deterministic and 2-4 timed candidates wide.
        by_shape: Dict[Tuple[int, int], Tuple[str, int]] = {}
        order = [base.lane_bucket] + [c for c in LANE_BUCKET_CANDIDATES
                                      if c != base.lane_bucket]
        for cand in order:
            shape = (_ladder(_round_up(n_lanes, base.batch_bucket
                                       or _BATCH_BUCKET)),
                     _ladder(_round_up(lane_len, cand or _LANE_BUCKET)))
            by_shape.setdefault(shape, ("full" if cand == 1 else str(cand),
                                        cand))
        best_bucket, best_score = base.lane_bucket, float("inf")
        lane_items = list(by_shape.items())
        if measure:
            lane_ts = _time_cutouts(
                [lambda c=cand: vm.timed_access_batch(
                    lanes, vcpu=0, lane_bucket=c,
                    batch_bucket=base.batch_bucket)
                 for _, (_, cand) in lane_items], reps)
        else:
            lane_ts = [STEP_COST_S * int(np.prod(shape))
                       + DISPATCH_OVERHEAD_S for shape, _ in lane_items]
        for (shape, (name, cand)), t in zip(lane_items, lane_ts):
            low = dataclasses.replace(base, lane_bucket=cand)
            pm = pred_misses(low)
            score = COMPILE_S * pm + horizon * t
            trials.append(Trial("lane_bucket", name, shape,
                                t if measure else 0.0, pm, score))
            if score < best_score * (1 - SWITCH_MARGIN):
                best_bucket, best_score = cand, score

        # -- fuse_commits: one fused commit group vs per-segment dispatches -
        fuse = base.fuse_commits
        if lru:
            segs = _segments(vm, seg_lens) if measure else None
            fused_shape = (_round_up(sum(seg_lens), _STREAM_BUCKET),)
            split_steps = sum(_round_up(n, _STREAM_BUCKET) for n in seg_lens)
            best_fuse, best_score = fuse, float("inf")
            cands = [("fused", True), ("unfused", False)]
            if not base.fuse_commits:        # incumbent (default) first
                cands.reverse()
            if measure:
                fuse_ts = dict(zip((c for _, c in cands), _time_cutouts(
                    [(lambda: vm.access_segments(segs)) if c else
                     (lambda: [vm.access(g, vcpu=v) for g, v in segs])
                     for _, c in cands], reps)))
            for name, cand in cands:
                low = dataclasses.replace(base, fuse_commits=cand)
                if measure:
                    t = fuse_ts[cand]
                else:
                    t = (STEP_COST_S * (fused_shape[0] if cand
                                        else split_steps)
                         + DISPATCH_OVERHEAD_S * (1 if cand
                                                  else len(seg_lens)))
                pm = pred_misses(low)
                score = COMPILE_S * pm + horizon * t
                trials.append(Trial(
                    "fuse_commits", name,
                    fused_shape if cand else (len(seg_lens), _STREAM_BUCKET),
                    t if measure else 0.0, pm, score))
                if score < best_score * (1 - SWITCH_MARGIN):
                    best_fuse, best_score = cand, score
            fuse = best_fuse
        else:
            fuse = False

        # -- lockstep: one Vote round as a 2-guest multi dispatch vs solo ---
        lockstep = base.lockstep and lru
        if lru and n_guests > 1:
            d = max(1, len(plan_shapes(
                ref, dataclasses.replace(base, lane_bucket=best_bucket,
                                         lockstep=True), n_guests)))
            shape2 = (2,
                      _ladder(_round_up(n_lanes, base.batch_bucket
                                        or _BATCH_BUCKET)),
                      _ladder(_round_up(lane_len, best_bucket
                                        or _LANE_BUCKET)))
            if measure:
                vm2 = _scratch_vm(platform, seed + 1, device)
                lanes2 = _cutout_lanes(vm2, n_lanes, lane_len)
                vcpus = [0] * n_lanes
                t_solo, t_multi = _time_cutouts(
                    [lambda: vm.timed_access_batch(
                        lanes, vcpu=0, lane_bucket=best_bucket,
                        batch_bucket=base.batch_bucket),
                     lambda: timed_access_batch_multi(
                        [vm, vm2], [lanes, lanes2], [vcpus, vcpus],
                        lane_bucket=best_bucket,
                        batch_bucket=base.batch_bucket)], reps)
            else:
                t_solo = (DISPATCH_OVERHEAD_S
                          + STEP_COST_S * int(np.prod(shape2[1:])))
                t_multi = (DISPATCH_OVERHEAD_S
                           + STEP_COST_S * 2 * int(np.prod(shape2[1:])))
            # extrapolate the 2-guest cutout to the co-running group: the
            # marginal per-guest cost is t_multi - t_solo, the saving is
            # one dispatch overhead per extra guest per shareable dispatch
            per_exec_solo = d * n_guests * t_solo
            per_exec_multi = d * (t_multi + max(0.0, t_multi - t_solo)
                                  * max(0, n_guests - 2))
            best_lock, best_score = lockstep, float("inf")
            lcands = [("lockstep_on", True, t_multi, per_exec_multi),
                      ("lockstep_off", False, t_solo, per_exec_solo)]
            if not lockstep:                 # incumbent (default) first
                lcands.reverse()
            for name, cand, t, per_exec in lcands:
                low = dataclasses.replace(base, lane_bucket=best_bucket,
                                          fuse_commits=fuse, lockstep=cand)
                pm = pred_misses(low, guests=n_guests if cand else 1)
                score = COMPILE_S * pm + horizon * per_exec
                trials.append(Trial("lockstep", name,
                                    shape2 if cand else shape2[1:],
                                    t if measure else 0.0, pm, score))
                if score < best_score * (1 - SWITCH_MARGIN):
                    best_lock, best_score = cand, score
            lockstep = best_lock
        elif not lru:
            lockstep = False
    finally:
        # tuner dispatches leave no trace (see module docstring)
        _DISPATCH_STATS.clear()
        _DISPATCH_STATS.update(dispatch_snap)
        SHAPE_CACHE.restore(cache_snap)

    chosen = PlanLowering(fuse_commits=fuse, lane_bucket=best_bucket,
                          batch_bucket=base.batch_bucket, lockstep=lockstep)
    trials = [dataclasses.replace(
        t, chosen=(
            (t.knob == "lane_bucket"
             and t.candidate == ("full" if best_bucket == 1
                                 else str(best_bucket)))
            or (t.knob == "fuse_commits"
                and t.candidate == ("fused" if fuse else "unfused"))
            or (t.knob == "lockstep"
                and t.candidate == ("lockstep_on" if lockstep
                                    else "lockstep_off"))))
        for t in trials]
    report = TuneReport(platform=platform.name, signature=sig,
                        n_guests=int(n_guests), chosen=chosen,
                        trials=tuple(trials), measured=measure)
    _TUNE_CACHE[key] = report
    return report


def _synthetic_plan(platform, n_lanes: int, lane_len: int,
                    seg_lens: List[int]) -> ProbePlan:
    """A representative monitor-shaped plan when the caller has none:
    prime Commit + one Measure over ways+1-line lanes."""
    from repro_torch.core.probeplan import Segment, WarmTimer
    gva = GuestVM.gva
    segs = tuple(Segment(gvas=np.array([gva(j % 64, 0) for j in range(n)],
                                       np.int64), vcpu=0)
                 for n in seg_lens)
    lanes = tuple(np.array([gva(j % 64, 0) for j in range(lane_len)],
                           np.int64) for _ in range(n_lanes))
    return ProbePlan(ops=(Commit(segments=segs), WarmTimer(),
                          Measure(lanes=lanes, vcpus=(0,) * n_lanes)),
                     label="plancost.synthetic",
                     hints=platform.plan_lowering())
