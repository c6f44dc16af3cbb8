"""VEV — minimal eviction-set construction inside the VM (paper §3.1).

Implements the paper's adapted L2FBS pipeline:

  * candidate pools sized ``Ps = W * 2^Nui * Nslices * C`` per aligned page
    offset (``C = 3`` accounts for uneven distribution across sets/slices),
  * MLP-batched eviction tests (a whole candidate list is traversed in one
    batched pass; repeated tests + majority vote suppress the false
    positives the paper attributes to other tenants' cache activity),
  * group-testing pruning with backtracking (Vila et al. [62]) accelerated
    with the binary-search group scan of L2FBS [73],
  * guest-TSC warm-up before every timed probe (the paper's §3.1 fix),
  * VTOP-guided placement: parallel construction partitions rows among
    vCPU pairs *within one LLC domain*; a pair straddling domains never
    observes evictions and stalls — the exact failure mode of Table 2
    row 3 (L2FBS without topology awareness: 46.57% success).

"Parallel" here means two things, faithfully mirroring the paper: the MLP
batching of a single tester (one `access_stream` pass instead of per-line
round trips), and row-partitioned construction across vCPUs.  The container
is single-core, so benchmarks report both wall time and the modelled
critical path (max over partitions) alongside sequential cost (sum) — the
hardware-independent speedup the paper's Table 2 measures.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.cachesim import (BLOCKS_PER_PAGE, L2_MISS_THRESHOLD,
                                       LLC_MISS_THRESHOLD, LINE_BITS, PAGE_BITS)
from repro_torch.core.host_model import GuestVM
from repro_torch.core import hierarchy, probeplan
from repro_torch.core.probeplan import PlanLowering, ProbePlan, Validate, Vote

C_POOL_SCALE = 3  # paper §3.1: scaling factor C
_SPARE_HARVEST_ROUNDS = 4  # max extra fused rounds topping up set spares
SPARE_FACTOR = 2   # spares kept per set = SPARE_FACTOR * ways (repair pool depth)


def _probe_lanes(tests, prime_reps: int) -> List[np.ndarray]:
    """(target, candidates) -> one Prime+Probe lane per test:
    ``[target, candidates * prime_reps, target]``."""
    return [np.concatenate(
        [[t]] + [np.asarray(c, np.int64)] * prime_reps + [[t]])
        for t, c in tests]


def vote_plan(tests: Sequence[Tuple[int, Sequence[int]]], prime_reps: int,
              vcpu: int, threshold: int, votes: int,
              lowering: Optional[PlanLowering] = None,
              label: str = "vev.vote", level: str = "llc") -> ProbePlan:
    """Compile a round of (target, candidates) eviction tests to a one-op
    ProbePlan: a majority-voted :class:`~repro_torch.core.probeplan.Vote` over
    the Prime+Probe lanes ``[target, candidates*prime_reps, target]``.
    ``level`` stamps the op (and the plan's signature) with the cache
    level the threshold separates, so cost models and tuner caches keyed
    on signatures never conflate L2 and LLC programs."""
    lanes = tuple(_probe_lanes(tests, prime_reps))
    return ProbePlan(
        ops=(Vote(lanes=lanes, vcpus=(vcpu,) * len(lanes),
                  threshold=threshold, votes=votes, level=level),),
        label=label, hints=lowering)


def validate_plan(sets: Sequence[EvictionSet], prime_reps: int,
                  vcpus: Sequence[int], threshold: int, votes: int,
                  lowering: Optional[PlanLowering] = None,
                  label: str = "vev.validate",
                  level: str = "llc") -> ProbePlan:
    """Compile a drift-validity check of built eviction sets to a one-op
    :class:`~repro_torch.core.probeplan.Validate` ProbePlan: one
    ``[spare, members, spare]`` Prime+Probe lane per set that has a
    verified-congruent spare (``plan.meta["indices"]`` maps lanes back to
    set positions; spare-less sets are untestable and excluded)."""
    testable = [i for i, es in enumerate(sets) if len(es.spares)]
    lanes = tuple(_probe_lanes(
        [(int(sets[i].spares[0]), sets[i].gvas) for i in testable],
        prime_reps))
    return ProbePlan(
        ops=(Validate(lanes=lanes,
                      vcpus=tuple(vcpus[i] for i in testable),
                      threshold=threshold, votes=votes, level=level),),
        label=label, hints=lowering,
        meta={"indices": testable, "n_sets": len(sets)})


def _majority_verdicts(vm: GuestVM, lanes: List[np.ndarray], vcpu, thr: int,
                       votes: int) -> np.ndarray:
    """Fused majority-voted eviction verdicts: one batched dispatch per
    vote, the vote index salting the per-lane rng fork so each vote is an
    independent trial under non-deterministic replacement.  (The
    pre-ProbePlan batched path, kept as the parity reference the executor's
    ``Vote`` lowering is tested against.)"""
    hits = np.zeros(len(lanes), np.int64)
    for vote in range(votes):
        lats = vm.timed_access_batch(lanes, vcpu=vcpu, salt=vote)
        hits += np.array([int(l[-1] > thr) for l in lats])
    return hits * 2 > votes


@dataclasses.dataclass
class EvictionSet:
    """A minimal eviction set: `gvas` all map to one cache set.

    ``spares`` are *verified-congruent* non-member lines harvested for free
    during construction (pool targets a built set was observed to evict,
    i.e. "covered" targets).  They cost zero extra probing and are what
    makes drift validation cheap: a minimal set of exactly ``W`` lines
    cannot test itself (``W-1`` congruent lines never evict), but
    ``[spare, members, spare]`` is a complete eviction test — see
    :meth:`VEV.validate_sets`.  Spares double as the enriched candidate
    pool for incremental :meth:`VEV.repair_sets`.
    """

    gvas: np.ndarray          # guest line addresses (same aligned page offset)
    offset: int               # aligned page offset (bits 11:6 << 6)
    level: str                # "l2" | "llc"
    spares: np.ndarray = dataclasses.field(
        default_factory=lambda: np.empty(0, np.int64))

    def __len__(self) -> int:
        return len(self.gvas)

    def add_spare(self, gva: int, cap: int) -> None:
        if len(self.spares) < cap:
            self.spares = np.append(self.spares, np.int64(gva))

    def state_dict(self) -> Dict:
        """JSON-serializable form (the `CacheXSession` export contract:
        GVAs stay valid across guest reboots because the GPA→HPA backing
        persists)."""
        return {"gvas": [int(g) for g in self.gvas],
                "offset": int(self.offset), "level": str(self.level),
                "spares": [int(g) for g in self.spares]}

    @classmethod
    def from_state(cls, state: Dict) -> "EvictionSet":
        return cls(gvas=np.asarray(state["gvas"], np.int64),
                   offset=int(state["offset"]), level=str(state["level"]),
                   spares=np.asarray(state.get("spares", []), np.int64))


@dataclasses.dataclass
class VEVStats:
    tests: int = 0
    prunes: int = 0
    failures: int = 0
    built: int = 0


class VEV:
    """Eviction-set constructor bound to one GuestVM."""

    def __init__(self, vm: GuestVM, votes: int = 1, max_backtracks: int = 8,
                 vcpu: int = 0, prime_reps: int = 1, use_batch: bool = True,
                 use_plans: bool = True,
                 lowering: Optional[PlanLowering] = None):
        self.vm = vm
        self.votes = votes
        self.max_backtracks = max_backtracks
        self.vcpu = vcpu
        # Non-LRU replacement makes a single traversal evict the target only
        # probabilistically; repeated priming passes drive the probability
        # toward 1 (the standard technique L2FBS inherits for unknown
        # replacement policies).  1 suffices for (pseudo-)LRU.
        self.prime_reps = prime_reps
        # use_batch routes group tests through the batched multi-set
        # Prime+Probe engine (one fused dispatch per vote for a whole round
        # of tests); False keeps the per-test sequential path for
        # benchmarking the dispatch reduction.
        self.use_batch = use_batch
        # use_plans emits the batched tests as ProbePlan Vote programs
        # (`probeplan.execute`); False keeps the pre-plan direct
        # `_majority_verdicts` path as the parity reference.
        self.use_plans = use_plans
        self.lowering = lowering
        self.stats = VEVStats()

    # -- thresholds -----------------------------------------------------------
    @staticmethod
    def _threshold(level: str) -> int:
        return L2_MISS_THRESHOLD if level == "l2" else LLC_MISS_THRESHOLD

    # -- primitive: does candidate list evict target? ---------------------------
    def evicts(self, target_gva: int, cand_gvas: Sequence[int], level: str) -> bool:
        """MLP-batched eviction test with majority voting.

        One fused pass per vote: [target, candidates..., target] — the MLP
        traversal itself keeps the guest TSC warm, so the final timed probe
        needs no separate warm-up (the explicit ``warm_timer`` path is still
        exercised by standalone probes, e.g. vscan's probe phase).
        """
        thr = self._threshold(level)
        cand = np.asarray(cand_gvas, np.int64)
        hits = 0
        rounds = self.votes
        for _ in range(rounds):
            self.stats.tests += 1
            stream = np.concatenate([[target_gva]] +
                                    [cand] * self.prime_reps +
                                    [[target_gva]])
            lats = self.vm.timed_access(stream, vcpu=self.vcpu)
            hits += int(int(lats[-1]) > thr)
        return hits * 2 > rounds

    def evicts_many(self, tests: Sequence[Tuple[int, Sequence[int]]],
                    level: str) -> np.ndarray:
        """Batched eviction tests: each (target, candidates) pair becomes one
        lane ``[target, candidates*prime_reps, target]`` of a single fused
        multi-set Prime+Probe dispatch per vote (the engine behind VEV group
        testing, VCOL filtering and VSCAN probing — paper Tables 2/6).
        Outcome-equivalent to per-test :meth:`evicts` under LRU (each lane's
        verdict depends only on its own in-lane accesses)."""
        if not tests:
            return np.zeros(0, bool)
        if not self.use_batch:
            return np.array([self.evicts(t, c, level) for t, c in tests])
        self.stats.tests += len(tests) * self.votes
        if self.use_plans:
            plan = vote_plan(tests, self.prime_reps, self.vcpu,
                             self._threshold(level), self.votes,
                             lowering=self.lowering, level=level)
            return probeplan.execute(self.vm, plan).last
        return _majority_verdicts(self.vm,
                                  _probe_lanes(tests, self.prime_reps),
                                  self.vcpu, self._threshold(level),
                                  self.votes)

    # -- pruning ----------------------------------------------------------------
    def _prune_rounds(self, target_gva: int, cand_gvas, ways: int,
                      rng: np.random.Generator):
        """Round generator behind :meth:`prune` in batched mode.

        Yields one round of (target, keep-list) tests at a time and receives
        the verdict vector; a driver (``build_for_offset`` directly, or
        :func:`build_many` merging several partitions) turns each round into
        one fused multi-set Prime+Probe dispatch.  Each round tests the two
        drop-a-half splits (L2FBS's binary-search scan — one verdict removes
        half the candidates while enough congruent lines remain) ahead of
        the classic ``ways+1`` group removals (Vila et al. backtracking).
        """
        s = np.asarray(cand_gvas, np.int64)
        backtracks = 0
        self.stats.prunes += 1
        while len(s) > ways:
            n_groups = min(ways + 1, len(s))
            groups: List[np.ndarray] = []
            if len(s) >= 2 * ways:
                groups.extend(np.array_split(rng.permutation(len(s)), 2))
            groups.extend(np.array_split(rng.permutation(len(s)), n_groups))
            keeps = [np.delete(s, g) for g in groups]
            verdicts = yield [(target_gva, k) for k in keeps]
            hit = np.flatnonzero(verdicts)
            if len(hit):
                # halves come first, so the largest viable removal wins
                s = keeps[int(hit[0])]
            else:
                backtracks += 1
                if backtracks > self.max_backtracks:
                    self.stats.failures += 1
                    return None
        # final sanity: the minimal set must still evict the target.
        verdicts = yield [(target_gva, s)]
        if not verdicts[0]:
            self.stats.failures += 1
            return None
        return s

    def prune(self, target_gva: int, cand_gvas: Sequence[int], ways: int,
              level: str, rng: np.random.Generator) -> Optional[np.ndarray]:
        """Reduce a superset that evicts `target` to a minimal set of `ways`
        lines.  Group testing with backtracking (Vila et al.), scanning
        groups smallest-first as in L2FBS's binary-search pruning.

        Batched mode drives :meth:`_prune_rounds` (one dispatch per round);
        sequential mode keeps the seed per-test scan with early exit."""
        if self.use_batch:
            return _drive(self._prune_rounds(target_gva, cand_gvas, ways, rng),
                          lambda tests: self.evicts_many(tests, level))
        s = np.asarray(cand_gvas, np.int64)
        backtracks = 0
        self.stats.prunes += 1
        while len(s) > ways:
            n_groups = min(ways + 1, len(s))
            perm = rng.permutation(len(s))
            groups = np.array_split(perm, n_groups)
            removed = False
            for g in groups:
                keep = np.delete(s, g)
                if self.evicts(target_gva, keep, level):
                    s = keep
                    removed = True
                    break
            if not removed:
                backtracks += 1
                if backtracks > self.max_backtracks:
                    self.stats.failures += 1
                    return None
        # final sanity: minimality — removing any line must break eviction.
        if not self.evicts(target_gva, s, level):
            self.stats.failures += 1
            return None
        return s

    # -- pool construction --------------------------------------------------------
    def make_pool(self, offset: int, ways: int, n_uncontrollable_rows: int,
                  n_slices: int, scale: int = C_POOL_SCALE) -> np.ndarray:
        """Allocate a candidate pool at `offset` sized per §3.1:
        Ps = W * 2^Nui * Nslices * C   (2^Nui == n_uncontrollable_rows)."""
        n_pages = ways * n_uncontrollable_rows * n_slices * scale
        pages = self.vm.alloc_pages(n_pages)
        return np.array([self.vm.gva(int(p), offset) for p in pages], np.int64)

    def _build_rounds(self, offset: int, pool, ways: int, level: str,
                      max_sets: Optional[int], seed: int):
        """Round generator behind :meth:`build_for_offset` in batched mode:
        per target, the covered-by-built-set checks and the pool-viability
        test share one round; pruning rounds follow via
        :meth:`_prune_rounds`.  Drivers turn each round into one dispatch —
        :func:`build_many` merges rounds of several partitions (Fig 6)."""
        rng = np.random.default_rng(seed)
        pool = list(np.asarray(pool, np.int64))
        built: List[EvictionSet] = []
        misses = 0
        while pool and (max_sets is None or len(built) < max_sets):
            target = int(pool.pop(0))
            tests = [(target, es.gvas) for es in built]
            tests.append((target, np.array(pool, np.int64)))
            verdicts = yield tests
            cov = np.flatnonzero(np.asarray(verdicts[:-1]))
            if len(cov):                                # covered
                # the covering set evicted this target: a verified-congruent
                # spare, harvested for free (drift validation/repair fuel)
                built[int(cov[0])].add_spare(target, cap=SPARE_FACTOR * ways)
                continue
            if not verdicts[-1]:
                # pool can no longer evict this target: its set's lines are
                # exhausted (or it needs more candidates) — skip.
                misses += 1
                if misses > 4 * ways:
                    break
                continue
            minimal = yield from self._prune_rounds(
                target, np.array(pool, np.int64), ways, rng)
            if minimal is None:
                continue
            built.append(EvictionSet(gvas=np.sort(minimal), offset=offset,
                                     level=level))
            self.stats.built += 1
            taken = set(int(x) for x in minimal)
            pool = [p for p in pool if int(p) not in taken]
        # spare harvest: a set built last never saw later "covered" targets,
        # so it would have no verified-congruent spare and could never be
        # drift-validated (`validate_sets`).  Top up zero-spare sets from
        # the leftover pool — every (target, set) pair rides one fused
        # round, so this adds at most `_SPARE_HARVEST_ROUNDS` dispatches.
        attempts = 0
        while (pool and attempts < _SPARE_HARVEST_ROUNDS
               and any(len(es.spares) < SPARE_FACTOR * ways
                       for es in built)):
            poor = [es for es in built
                    if len(es.spares) < SPARE_FACTOR * ways]
            targets = [int(pool.pop(0))
                       for _ in range(min(len(pool), 96))]
            tests = [(t, es.gvas) for t in targets for es in poor]
            verdicts = yield tests
            k = 0
            for t in targets:
                for es in poor:
                    if verdicts[k]:
                        es.add_spare(t, cap=SPARE_FACTOR * ways)
                    k += 1
            attempts += 1
        return built

    def build_for_offset(self, offset: int, pool: np.ndarray, ways: int,
                         level: str, max_sets: Optional[int] = None,
                         seed: int = 0) -> List[EvictionSet]:
        """Paper §3.1 "basic steps": repeatedly pick a target from the pool;
        if no previously-built set evicts it, prune the pool remainder into a
        new minimal set and remove its lines from the pool."""
        if self.use_batch:
            return _drive(
                self._build_rounds(offset, pool, ways, level, max_sets, seed),
                lambda tests: self.evicts_many(tests, level))
        rng = np.random.default_rng(seed)
        pool = list(np.asarray(pool, np.int64))
        built: List[EvictionSet] = []
        misses = 0
        while pool and (max_sets is None or len(built) < max_sets):
            target = int(pool.pop(0))
            covered = False
            for es in built:
                if self.evicts(target, es.gvas, level):
                    covered = True
                    es.add_spare(target, cap=SPARE_FACTOR * ways)
                    break
            if covered:
                continue
            if not self.evicts(target, np.array(pool, np.int64), level):
                # pool can no longer evict this target: its set's lines are
                # exhausted (or it needs more candidates) — skip.
                misses += 1
                if misses > 4 * ways:
                    break
                continue
            minimal = self.prune(target, pool, ways, level, rng)
            if minimal is None:
                continue
            built.append(EvictionSet(gvas=np.sort(minimal), offset=offset,
                                     level=level))
            self.stats.built += 1
            taken = set(int(x) for x in minimal)
            pool = [p for p in pool if int(p) not in taken]
        # spare harvest (sequential twin of the batched phase above)
        attempts = 0
        while (pool and attempts < _SPARE_HARVEST_ROUNDS
               and any(len(es.spares) < SPARE_FACTOR * ways
                       for es in built)):
            poor = [es for es in built
                    if len(es.spares) < SPARE_FACTOR * ways]
            targets = [int(pool.pop(0))
                       for _ in range(min(len(pool), 96))]
            for t in targets:
                for es in poor:
                    if self.evicts(t, es.gvas, level):
                        es.add_spare(t, cap=SPARE_FACTOR * ways)
            attempts += 1
        return built

    # -- associativity probing (paper Table 3) -------------------------------------
    def probe_associativity(self, pool: np.ndarray, level: str,
                            max_ways: int = 32, seed: int = 0) -> Optional[int]:
        """Detect the effective set capacity: the size of a minimal eviction
        set.  Prune with an over-estimate of `ways` by shrinking until
        removing any single group breaks eviction."""
        rng = np.random.default_rng(seed)
        pool = list(np.asarray(pool, np.int64))
        target = int(pool.pop(0))
        if not self.evicts(target, np.array(pool), level):
            return None
        s = np.array(pool, np.int64)
        # binary-search-flavoured halving first: try dropping half
        changed = True
        while changed:
            changed = False
            if len(s) < 2:
                break
            perm = rng.permutation(len(s))
            pieces = np.array_split(perm, 2)  # halves
            keeps = [np.delete(s, piece) for piece in pieces]
            keeps = [k for k in keeps if len(k)]
            verdicts = self.evicts_many([(target, k) for k in keeps], level)
            hit = np.flatnonzero(verdicts)
            if len(hit):
                s = keeps[int(hit[0])]
                changed = True
        # then one-at-a-time greedy removal to exact minimality; batched mode
        # tests every single-line removal of the current set in one dispatch
        # and drops the first line whose removal keeps the set evicting
        if self.use_batch:
            while len(s) > 1:
                keeps = [np.delete(s, i) for i in range(len(s))]
                verdicts = self.evicts_many([(target, k) for k in keeps],
                                            level)
                hit = np.flatnonzero(verdicts)
                if not len(hit):
                    break
                s = keeps[int(hit[0])]
        else:
            i = 0
            while i < len(s):
                keep = np.delete(s, i)
                if len(keep) and self.evicts(target, keep, level):
                    s = keep
                else:
                    i += 1
        return len(s) if self.evicts(target, s, level) else None

    # -- drift validation & incremental repair (host-event recovery) -----------
    def validate_sets(self, sets: Sequence[EvictionSet], level: str,
                      vcpus: Optional[Sequence[int]] = None) -> np.ndarray:
        """Cheap guest-side drift check of already-built eviction sets.

        One fused :class:`~repro_torch.core.probeplan.Validate` dispatch per vote
        tests *every* set: lane ``[spare, members, spare]`` — an intact set
        still evicts its verified-congruent spare (miss on the re-access),
        a set whose member pages were silently remapped no longer musters
        ``ways`` congruent lines and the spare survives (hit).  Returns one
        bool per set (True = valid).  Conservative by construction: a set
        whose *spare* drifted, or that has no spare, reads as broken and
        gets repaired — validation never green-lights a stale set.
        """
        if not len(sets):
            return np.zeros(0, bool)
        vcpus = ([self.vcpu] * len(sets) if vcpus is None else list(vcpus))
        ok = np.zeros(len(sets), bool)
        if self.use_batch:
            plan = validate_plan(sets, self.prime_reps, vcpus,
                                 self._threshold(level), self.votes,
                                 lowering=self.lowering, level=level)
            op = plan.ops[0]
            if op.lanes:
                self.stats.tests += len(op.lanes) * self.votes
                if self.use_plans:
                    verdicts = probeplan.execute(self.vm, plan).last
                else:
                    verdicts = _majority_verdicts(
                        self.vm, list(op.lanes), list(op.vcpus),
                        op.threshold, op.votes)
                ok[np.asarray(plan.meta["indices"], int)] = \
                    np.asarray(verdicts, bool)
            return ok
        for i, es in enumerate(sets):
            if len(es.spares):
                ok[i] = self.evicts(int(es.spares[0]), es.gvas, level)
        return ok

    def _verdict_round(self, tests: Sequence[Tuple[int, Sequence[int]]],
                       lane_vcpus: Sequence[int], level: str) -> np.ndarray:
        """One fused round of (target, candidates) eviction verdicts with
        per-lane vCPUs (the repair primitive; plain :meth:`evicts_many`
        assumes one constructor vCPU)."""
        if not tests:
            return np.zeros(0, bool)
        self.stats.tests += len(tests) * self.votes
        if not self.use_batch:
            return np.array([self.evicts(t, c, level) for t, c in tests])
        lanes = _probe_lanes(tests, self.prime_reps)
        if self.use_plans:
            plan = ProbePlan(
                ops=(Vote(lanes=tuple(lanes), vcpus=tuple(lane_vcpus),
                          threshold=self._threshold(level),
                          votes=self.votes, level=level),),
                label="vev.repair", hints=self.lowering)
            return np.asarray(probeplan.execute(self.vm, plan).last, bool)
        return np.asarray(_majority_verdicts(
            self.vm, lanes, list(lane_vcpus), self._threshold(level),
            self.votes), bool)

    def repair_sets(self, sets: Sequence[EvictionSet], valid: np.ndarray,
                    level: str, ways: int, seed: int = 0,
                    vcpus: Optional[Sequence[int]] = None,
                    extra_pools: Optional[Dict[int, np.ndarray]] = None
                    ) -> "RepairOutcome":
        """Incrementally rebuild only the broken sets (where ``valid`` is
        False), reusing each set's surviving members + spares as the
        candidate pool.

        Because members and spares were all verified congruent in ONE
        (set, slice) cell at build time, repair needs no group-testing
        scan; two fused rounds fix every broken set at once:

          1. *filter*: for each candidate ``c`` of set ``i``'s pool, one
             lane ``[c, pool_i \\ {c}, c]`` — ``c`` is evicted iff it is
             still congruent with the pool's cell and at least ``ways``
             other pool lines still are (i.e. ``c`` survived the drift);
          2. *sanity*: the ``ways`` lowest-addressed survivors form the
             repaired set, the rest become its spares, and one
             :class:`~repro_torch.core.probeplan.Validate` lane per repaired set
             re-checks ``[spare, members, spare]`` end to end.

        Sets whose pool kept fewer than ``ways + 1`` congruent lines (or
        that fail sanity) land in ``RepairOutcome.failed`` — the caller
        retries with ``extra_pools`` top-up candidates (fresh same-offset
        lines; an off-cell extra cannot fake a clique, the filter round
        only keeps lines with ``ways`` congruent peers) or falls back to
        fresh construction.  Cost: ``2 * votes`` dispatches for any number
        of broken sets, vs. a full §3.1 pool scan per set for a rebuild —
        the ≥5x dispatch saving the drift benchmarks record.
        """
        valid = np.asarray(valid, bool)
        vcpus = ([self.vcpu] * len(sets) if vcpus is None else list(vcpus))
        broken = [i for i in range(len(sets)) if not valid[i]]
        out = list(sets)
        if not broken:
            return RepairOutcome(sets=out, repaired=[], failed=[])
        # round 1: filter each pool candidate against the rest of its pool
        tests: List[Tuple[int, np.ndarray]] = []
        lane_vcpus: List[int] = []
        spans: List[Tuple[int, np.ndarray, int, int]] = []
        for i in broken:
            es = sets[i]
            parts = [np.asarray(es.gvas, np.int64),
                     np.asarray(es.spares, np.int64)]
            if extra_pools and i in extra_pools:
                parts.append(np.asarray(extra_pools[i], np.int64))
            pool = np.unique(np.concatenate(parts))
            start = len(tests)
            tests.extend((int(c), np.delete(pool, k))
                         for k, c in enumerate(pool))
            lane_vcpus.extend([vcpus[i]] * len(pool))
            spans.append((i, pool, start, len(tests)))
        verdicts = self._verdict_round(tests, lane_vcpus, level)
        # reassemble: `ways` survivors -> members, the rest -> spares
        candidates: List[Tuple[int, EvictionSet]] = []
        failed: List[int] = []          # pool drifted beyond recovery
        alias_suspect: List[int] = []   # enough survivors, sanity refuted
        for i, pool, a, b in spans:
            survivors = pool[np.asarray(verdicts[a:b], bool)]
            if len(survivors) < ways + 1:
                failed.append(i)
                continue
            candidates.append((i, EvictionSet(
                gvas=np.sort(survivors[:ways]),
                offset=sets[i].offset, level=level,
                spares=survivors[ways:(1 + SPARE_FACTOR) * ways])))
        # round 2: end-to-end sanity of every repaired set
        sane = self.validate_sets([es for _, es in candidates], level,
                                  vcpus=[vcpus[i] for i, _ in candidates])
        repaired: List[int] = []
        for (i, es), ok in zip(candidates, sane):
            if ok:
                out[i] = es
                repaired.append(i)
            else:
                alias_suspect.append(i)
        # round 3 (rare): group-testing fallback on the same pools, ONLY
        # for sets whose pool had enough survivors yet failed sanity AND
        # only where the hierarchy model says back-invalidation aliasing
        # can produce that signature.  The filter round reads *any*
        # eviction as congruence; on a back-invalidating hierarchy whose
        # directory exposes fewer set indices than this level (milan_ccx:
        # 128-set LLC under a 256-set L2), L2 colors differing in the
        # dropped index bits share one directory row, a big single-color
        # lane overflows it, and the resulting back-invalidations evict
        # lines the pool is NOT L2-congruent with — drifted lines read as
        # survivors.  Sanity refuting a survivor-rich reassembly is that
        # effect *measured*, and the classic prune (whose verdicts
        # self-correct once the pool shrinks below the directory's
        # associativity) recovers the set, still from survivors only.
        # Where the model rules aliasing out (non-inclusive hierarchy,
        # LLC-level sets, set-rich directories), a refuted reassembly is
        # plain unrecoverable drift: the suspects join ``failed`` and the
        # caller's fresh-pool rebuild gets the dispatch budget instead.
        spec = hierarchy.HierarchySpec.of(self.vm.host.geom)
        if alias_suspect and not spec.directory_aliasing(level):
            failed.extend(alias_suspect)
            alias_suspect = []
        if alias_suspect:
            pools = {i: pool for i, pool, _, _ in spans}
            jobs = [{"offset": sets[i].offset, "pool": pools[i],
                     "max_sets": 1, "vcpu": vcpus[i]}
                    for i in alias_suspect]
            results, _, _ = build_many(
                self.vm, jobs, level, ways, votes=self.votes, seed=seed,
                use_batch=self.use_batch, prime_reps=self.prime_reps,
                use_plans=self.use_plans, lowering=self.lowering)
            for i, built in zip(alias_suspect, results):
                if built:
                    out[i] = built[0]
                    repaired.append(i)
                else:
                    failed.append(i)
        return RepairOutcome(sets=out, repaired=sorted(repaired),
                             failed=sorted(failed))


@dataclasses.dataclass
class RepairOutcome:
    """Result of one :meth:`VEV.repair_sets` pass."""

    sets: List[EvictionSet]   # input list with broken entries replaced
    repaired: List[int]       # indices rebuilt from survivors + spares
    failed: List[int]         # broken beyond incremental recovery: the
    #                           caller rebuilds these from a fresh pool


def _drive(gen, test_fn):
    """Run a round generator to completion with a per-round verdict fn."""
    try:
        tests = gen.send(None)
        while True:
            tests = gen.send(test_fn(tests))
    except StopIteration as e:
        return e.value


def build_many(vm: GuestVM, jobs: List[Dict], level: str, ways: int,
               votes: int = 1, seed: int = 0, use_batch: bool = True,
               prime_reps: int = 1, use_plans: bool = True,
               lowering: Optional[PlanLowering] = None
               ) -> Tuple[List[List[EvictionSet]], List[int], List[int]]:
    """Merged multi-partition eviction-set construction (Fig 6).

    ``jobs``: dicts with keys ``offset``, ``pool``, optional ``max_sets`` and
    ``vcpu``.  All partitions advance in lockstep, one fused multi-set
    Prime+Probe dispatch per round across every partition still running —
    the batched realization of the paper's parallel construction (partitions
    are disjoint rows, so their lanes never interfere).  With ``use_plans``
    each partition's round compiles to a one-op Vote ProbePlan and the
    round's plans are :func:`~repro_torch.core.probeplan.fuse`\\ d into a single
    program sharing its dispatches; ``use_plans=False`` keeps the pre-plan
    direct `_majority_verdicts` merge (same lanes, same dispatches).

    Returns (per-job built sets, per-job round counts, per-job prune-failure
    counts).  A job's round count is the number of dispatches it would have
    cost alone, so ``sum`` models sequential construction cost and ``max``
    the parallel critical path.
    """
    vevs = [VEV(vm, votes=votes, vcpu=int(j.get("vcpu", 0)),
                prime_reps=prime_reps, use_batch=use_batch,
                use_plans=use_plans, lowering=lowering) for j in jobs]
    results: List[Optional[List[EvictionSet]]] = [None] * len(jobs)
    rounds: List[int] = [0] * len(jobs)
    if not use_batch:
        for i, (vev, j) in enumerate(zip(vevs, jobs)):
            before = vm.stat_passes
            results[i] = vev.build_for_offset(
                j["offset"], j["pool"], ways, level,
                max_sets=j.get("max_sets"), seed=seed + i)
            rounds[i] = vm.stat_passes - before
        return ([r or [] for r in results], rounds,
                [v.stats.failures for v in vevs])

    thr = VEV._threshold(level)
    gens = {}
    pending = {}
    for i, (vev, j) in enumerate(zip(vevs, jobs)):
        gens[i] = vev._build_rounds(j["offset"], j["pool"], ways, level,
                                    j.get("max_sets"), seed + i)
        try:
            pending[i] = gens[i].send(None)
        except StopIteration as e:
            results[i] = e.value
    while pending:
        order = list(pending)
        for i in order:
            rounds[i] += votes   # dispatches this job would issue alone
        if use_plans:
            plans = [vote_plan(pending[i], prime_reps, vevs[i].vcpu, thr,
                               votes, lowering=lowering, label="vev.build",
                               level=level)
                     for i in order]
            fused, spans = probeplan.fuse(plans)
            split = probeplan.split_result(probeplan.execute(vm, fused),
                                           spans)
            per_job = {i: r.last for i, r in zip(order, split)}
        else:
            lanes: List[np.ndarray] = []
            vcpus: List[int] = []
            bounds: Dict[int, Tuple[int, int]] = {}
            for i in order:
                start = len(lanes)
                lanes.extend(_probe_lanes(pending[i], prime_reps))
                vcpus.extend([vevs[i].vcpu] * len(pending[i]))
                bounds[i] = (start, len(lanes))
            verdicts = _majority_verdicts(vm, lanes, vcpus, thr, votes)
            per_job = {i: verdicts[a:b] for i, (a, b) in bounds.items()}
        nxt = {}
        for i in order:
            vevs[i].stats.tests += len(pending[i]) * votes
            try:
                nxt[i] = gens[i].send(per_job[i])
            except StopIteration as e:
                results[i] = e.value
        pending = nxt
    return ([r or [] for r in results], rounds,
            [v.stats.failures for v in vevs])


# -- parallel construction (paper §3.3 / Fig 6) ---------------------------------

@dataclasses.dataclass
class ParallelBuildResult:
    sets: List[EvictionSet]
    # modelled costs (hardware-independent, see module docstring):
    sequential_passes: int        # sum of per-partition batched passes
    critical_path_passes: int     # max over partitions (ideal parallel)
    per_partition: List[int]
    failures: int


def build_parallel(vm: GuestVM, partitions: List[Dict], level: str,
                   ways: int, pair_vcpus: List[Tuple[int, int]],
                   vcpu_domain: Dict[int, int], votes: int = 1,
                   seed: int = 0, use_batch: bool = True,
                   use_plans: bool = True,
                   lowering: Optional[PlanLowering] = None
                   ) -> ParallelBuildResult:
    """Row-partitioned parallel construction (Fig 6).

    `partitions`: list of dicts with keys {"offset": int, "pool": np.ndarray,
    "max_sets": int} — disjoint rows, one per constructor/helper vCPU pair.
    Pairs whose two vCPUs live in different LLC domains (wrong VTOP info)
    produce no eviction observations and fail their partition — reproducing
    L2FBS-without-VTOP behaviour (Table 2 row 3).
    """
    sets: List[EvictionSet] = []
    per_part_passes: List[int] = [0] * len(partitions)
    failures = 0
    jobs: List[Dict] = []
    job_part_idx: List[int] = []
    for i, part in enumerate(partitions):
        ctor, helper = pair_vcpus[i % len(pair_vcpus)]
        same_domain = vcpu_domain.get(ctor) == vcpu_domain.get(helper)
        if not same_domain:
            # constructor primes in one domain, helper-assisted probes land in
            # another: every test times out; model as wasted passes + failure.
            before = vm.stat_passes
            vev = VEV(vm, votes=votes, vcpu=ctor, use_batch=use_batch,
                      use_plans=use_plans, lowering=lowering)
            vev.evicts(int(part["pool"][0]), part["pool"][:ways * 2], level)
            failures += 1
            per_part_passes[i] = vm.stat_passes - before
            continue
        jobs.append({"offset": part["offset"], "pool": part["pool"],
                     "max_sets": part.get("max_sets"), "vcpu": ctor})
        job_part_idx.append(i)
    if jobs:
        # viable partitions advance in lockstep sharing fused dispatches
        # (build_many); per-job round counts model each partition's
        # standalone cost for the Table 2 sequential-vs-critical-path report
        results, rounds, fails = build_many(vm, jobs, level, ways, votes=votes,
                                            seed=seed, use_batch=use_batch,
                                            use_plans=use_plans,
                                            lowering=lowering)
        for j, (built, r) in enumerate(zip(results, rounds)):
            i = job_part_idx[j]
            per_part_passes[i] = r
            sets.extend(built)
            failures += fails[j]
    return ParallelBuildResult(
        sets=sets,
        sequential_passes=int(sum(per_part_passes)),
        critical_path_passes=int(max(per_part_passes)) if per_part_passes else 0,
        per_partition=per_part_passes,
        failures=failures,
    )
