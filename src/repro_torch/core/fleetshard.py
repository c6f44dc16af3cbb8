"""FleetShard — device mapping + shard sizing + streaming fleet metrics.

The rack-scale fleet layer (`~repro_torch.core.fleet.ShardedFleet`) co-executes
N-hundred guests per platform by stacking their lockstep ProbePlan
programs into shared multi-guest dispatches.  Three pieces of machinery
make that scale, and all three live here so ``fleet.py`` stays the
simulation loop:

  * :func:`choose_shard` — picks the guest-shard size per (platform,
    plan-signature, n_guests) by scoring ``ceil(n/S)``-dispatch lowerings
    with the `~repro_torch.core.plancost` analytic model against the live
    dispatch-shape cache: one big ``(n, ...)`` stacked dispatch amortizes
    launch overhead best but pays a new shape's first-dispatch cost per
    distinct fleet size (and pads every guest to the group max), while
    ``(S, ...)`` shards reuse one shape across the whole fleet *and*
    across fleet sizes.  The cost terms are `plancost`'s constants,
    read at call time.  ``ScaleSpec.max_guests_per_dispatch`` is the hard
    memory ceiling (host-side padding buffers grow with the leading batch
    axis); within it, the smallest shard inside ``SWITCH_MARGIN`` of the
    best score wins, so repeated choices are deterministic.

  * :func:`device_groups` — deals guest shards over the visible CUDA
    cards (``torch.cuda.device_count()``).  Each group's guests boot on
    their card through the explicit ``device`` argument and its lockstep
    dispatches run there (data-parallel across the fleet axis — the
    shard axis is already the batch axis, so no cross-device collective
    is ever needed); with one card, or on the CPU, this is one group,
    shards dispatched back-to-back.

  * Streaming metrics (:class:`StreamingMean`, :class:`EWMA`,
    :class:`P2Quantile`, :class:`RingWindow`, rolled up per-run by
    :class:`FleetMetrics`) — replace ``FleetSim``'s materialized
    per-interval history lists so a run retains O(series) floats instead
    of O(series x intervals): exact running-sum means for every report
    field that used to be ``sum(hist)/len(hist)``, P² quantile sketches
    for tail latencies, and an optional bounded ring window (plus full
    histories behind ``keep_history=True`` for parity tests and the
    small-fleet benches that still want timelines).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.core import plancost
from repro_torch.core.host_model import shard_slices
from repro_torch.core.plancost import (HORIZON, SHAPE_CACHE, SWITCH_MARGIN,
                                       ShapeCache, plan_cost, tune_lowering)
from repro_torch.core.probeplan import PlanLowering, ProbePlan


# ---------------------------------------------------------------------------
# shard sizing
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShardChoice:
    """Outcome of one :func:`choose_shard` call.

    ``shard_size=None`` means one unsharded whole-fleet dispatch per op
    (only offered when ``n_guests`` fits the platform's
    ``max_guests_per_dispatch`` ceiling).  ``lowering`` is the effective
    :class:`~repro_torch.core.probeplan.PlanLowering` to install — the tuned
    per-platform hints with ``shard_size`` threaded in, ready for
    ``execute_many``.  ``trials`` records every candidate's score for
    reporting (label, shard dispatches per op, amortized score)."""

    platform: str
    n_guests: int
    shard_size: Optional[int]
    n_shards: int
    lowering: PlanLowering
    score: float
    trials: Tuple[Tuple[str, int, float], ...]
    cached: bool = False


_SHARD_CACHE: Dict[Tuple, ShardChoice] = {}


def clear_shard_cache() -> None:
    _SHARD_CACHE.clear()


def choose_shard(platform, plan: Optional[ProbePlan] = None,
                 n_guests: int = 2, horizon: float = HORIZON,
                 force: bool = False) -> ShardChoice:
    """Pick the guest-shard size for co-executing ``n_guests`` copies of
    ``plan`` on ``platform``.

    Reuses :func:`~repro_torch.core.plancost.tune_lowering` (model-only) for
    the lane/batch buckets, then scores each ``ScaleSpec.shard_candidates``
    entry (plus the unsharded whole-fleet dispatch when it fits the
    ``max_guests_per_dispatch`` ceiling) with the analytic cost model
    against the live :data:`~repro_torch.core.plancost.SHAPE_CACHE`:

        ``COMPILE_S * first_run_misses
          + horizon * (DISPATCH_OVERHEAD_S * dispatches
                       + STEP_COST_S * padded_steps)``

    — a new shape's first-dispatch cost is paid once, dispatch overhead
    and padded lane work recur every monitoring interval.  Among candidates within
    ``SWITCH_MARGIN`` of the best score the *smallest* shard wins
    (lowest per-dispatch memory, deterministic under model ties).
    Results are cached per (platform, plan signature, n_guests).
    Non-lockstep lowerings (non-LRU platforms) cannot stack guests at
    all: the choice degenerates to per-guest sequential execution and
    ``shard_size`` is returned as ``None`` with the base lowering."""
    sig = plan.signature() if plan is not None else ()
    key = (platform.name, sig, int(n_guests))
    if not force and key in _SHARD_CACHE:
        return dataclasses.replace(_SHARD_CACHE[key], cached=True)

    base = tune_lowering(platform, plan, n_guests=n_guests,
                         measure=False).chosen
    spec = platform.scale
    if not base.lockstep or n_guests < 2:
        choice = ShardChoice(platform=platform.name, n_guests=int(n_guests),
                             shard_size=None, n_shards=n_guests,
                             lowering=base, score=float("inf"), trials=())
        _SHARD_CACHE[key] = choice
        return choice

    ref = plan
    if ref is None:
        ref = plancost._synthetic_plan(platform,
                                       *plancost._cutout_spec(None, platform))

    # candidate shard sizes, smallest first; None (= unsharded) last and
    # only when the whole fleet fits one dispatch
    cands: List[Optional[int]] = sorted(
        {int(c) for c in spec.shard_candidates
         if 0 < c < n_guests and c <= spec.max_guests_per_dispatch})
    if n_guests <= spec.max_guests_per_dispatch:
        cands.append(None)
    if not cands:
        cands = [int(spec.max_guests_per_dispatch)]

    geom = platform.machine()
    snap = SHAPE_CACHE.snapshot()
    trials: List[Tuple[str, int, float]] = []
    scored: List[Tuple[Optional[int], float]] = []
    for cand in cands:
        low = dataclasses.replace(base, shard_size=cand)
        cache = ShapeCache()
        cache.restore(snap)
        cost = plan_cost(ref, low, platform=platform, n_guests=n_guests,
                         shape_cache=cache)
        score = (plancost.COMPILE_S * cost.compile_misses
                 + horizon * (plancost.DISPATCH_OVERHEAD_S * cost.dispatches
                              + plancost.STEP_COST_S * cost.padded_steps))
        label = "unsharded" if cand is None else str(cand)
        trials.append((label, cost.dispatches, score))
        scored.append((cand, score))

    best = min(s for _, s in scored)
    # smallest shard within the switch margin of the best score
    chosen_size, chosen_score = next(
        (c, s) for c, s in scored if s <= best * (1 + SWITCH_MARGIN))
    chosen_low = dataclasses.replace(base, shard_size=chosen_size)
    n_shards = len(shard_slices(n_guests, chosen_size))
    choice = ShardChoice(platform=platform.name, n_guests=int(n_guests),
                         shard_size=chosen_size, n_shards=n_shards,
                         lowering=chosen_low, score=chosen_score,
                         trials=tuple(trials))
    _SHARD_CACHE[key] = choice
    return choice


# ---------------------------------------------------------------------------
# device mapping
# ---------------------------------------------------------------------------

def local_device_count(device=None) -> int:
    """CUDA cards a fleet on ``device`` spreads over: every visible card
    for None (the card) or an unindexed ``"cuda"``, one for an indexed
    card or the CPU.  Asking for a card where none is visible raises
    (`repro_torch.resolve_device`): there is no silent CPU fallback."""
    dev = resolve_device(device)
    if dev.type != "cuda" or dev.index is not None:
        return 1
    return max(1, torch.cuda.device_count())


def _group_device(index: int, device=None) -> torch.device:
    """The device group ``index`` of a fleet on ``device`` boots on."""
    dev = resolve_device(device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    return torch.device("cuda", index % max(1, torch.cuda.device_count()))


def device_groups(n_guests: int, shard_size: Optional[int],
                  device=None) -> List[Tuple[int, slice]]:
    """Partition ``n_guests`` into per-device lockstep groups.

    Contiguous runs of guest shards (the
    :func:`~repro_torch.core.host_model.shard_slices` partition) are dealt
    to the CUDA cards of ``device`` (see :func:`local_device_count`): the
    guests of group ``i`` boot on ``cuda:<i>`` and run as their own
    lockstep cohort there (data-parallel across the fleet axis: the shard
    axis is already the batch axis, no cross-device collective is
    needed), and within the group the ``shard_size`` lowering hint
    re-splits it into the same per-dispatch shards.  With one card, or on
    the CPU, this returns a single ``(0, slice(0, n_guests))`` group."""
    shards = shard_slices(n_guests, shard_size)
    n_dev = min(local_device_count(device), len(shards))
    if n_dev <= 1:
        return [(0, slice(0, n_guests))]
    per = -(-len(shards) // n_dev)         # ceil: shards per device
    groups = []
    for d in range(n_dev):
        chunk = shards[d * per:(d + 1) * per]
        if chunk:
            groups.append((d, slice(chunk[0].start, chunk[-1].stop)))
    return groups


@contextlib.contextmanager
def on_device(index: int, device=None):
    """Run the body's dispatches on group ``index``'s card: the engine
    launches on the current CUDA device, so this makes the card that
    holds the group's guests current (the guests themselves were booted
    there through their explicit ``device``).  Yields that device; a
    no-op on the CPU."""
    dev = _group_device(index, device)
    if dev.type != "cuda":
        yield dev
        return
    with torch.cuda.device(dev):
        yield dev


# ---------------------------------------------------------------------------
# streaming metrics
# ---------------------------------------------------------------------------

class StreamingMean:
    """Exact running-sum mean: ``value() == sum(samples) / len(samples)``
    bit for bit, because it *is* that computation performed online."""

    __slots__ = ("_sum", "n")

    def __init__(self) -> None:
        self._sum = 0.0
        self.n = 0

    def add(self, x: float) -> None:
        self._sum += float(x)
        self.n += 1

    def value(self) -> float:
        return self._sum / self.n if self.n else 0.0


class EWMA:
    """Exponentially-weighted moving average (seeded with the first
    sample, so a constant series reports the constant exactly)."""

    __slots__ = ("alpha", "n", "_v")

    def __init__(self, alpha: float = 0.25) -> None:
        self.alpha = float(alpha)
        self.n = 0
        self._v = 0.0

    def add(self, x: float) -> None:
        x = float(x)
        self._v = x if self.n == 0 else (self.alpha * x
                                         + (1.0 - self.alpha) * self._v)
        self.n += 1

    def value(self) -> float:
        return self._v if self.n else 0.0


class P2Quantile:
    """Jain & Chlamtac's P² streaming quantile sketch: five markers,
    O(1) memory and update, no stored samples.  Exact until the sixth
    sample (the first five are kept and interpolated directly), then the
    middle marker tracks the ``q``-quantile with parabolic adjustment —
    bounded error on unimodal latency distributions, which is all the
    serving guest needs from a p99."""

    __slots__ = ("q", "n", "_x", "_hq", "_np", "_npd", "_dn")

    def __init__(self, q: float = 0.99) -> None:
        self.q = float(q)
        self.n = 0
        self._x: List[float] = []
        self._hq: Optional[List[float]] = None
        self._np: List[int] = []
        self._npd: List[float] = []
        self._dn = (0.0, self.q / 2, self.q, (1 + self.q) / 2, 1.0)

    def add(self, x: float) -> None:
        x = float(x)
        self.n += 1
        if self._hq is None:
            self._x.append(x)
            if len(self._x) == 5:
                self._x.sort()
                self._hq = list(self._x)
                self._np = [1, 2, 3, 4, 5]
                self._npd = [1.0, 1 + 2 * self.q, 1 + 4 * self.q,
                             3 + 2 * self.q, 5.0]
            return
        hq, pos, des = self._hq, self._np, self._npd
        if x < hq[0]:
            hq[0] = x
            k = 0
        elif x >= hq[4]:
            hq[4] = x
            k = 3
        else:
            k = next(i - 1 for i in range(1, 5) if x < hq[i])
        for i in range(k + 1, 5):
            pos[i] += 1
        for i in range(5):
            des[i] += self._dn[i]
        for i in (1, 2, 3):
            d = des[i] - pos[i]
            if ((d >= 1 and pos[i + 1] - pos[i] > 1)
                    or (d <= -1 and pos[i - 1] - pos[i] < -1)):
                step = 1 if d >= 0 else -1
                hp = self._parabolic(i, step)
                hq[i] = (hp if hq[i - 1] < hp < hq[i + 1]
                         else self._linear(i, step))
                pos[i] += step

    def _parabolic(self, i: int, d: int) -> float:
        hq, pos = self._hq, self._np
        return hq[i] + d / (pos[i + 1] - pos[i - 1]) * (
            (pos[i] - pos[i - 1] + d) * (hq[i + 1] - hq[i])
            / (pos[i + 1] - pos[i])
            + (pos[i + 1] - pos[i] - d) * (hq[i] - hq[i - 1])
            / (pos[i] - pos[i - 1]))

    def _linear(self, i: int, d: int) -> float:
        hq, pos = self._hq, self._np
        return hq[i] + d * (hq[i + d] - hq[i]) / (pos[i + d] - pos[i])

    def value(self) -> float:
        if self.n == 0:
            return 0.0
        if self._hq is None:          # < 5 samples: exact interpolation
            xs = sorted(self._x)
            k = self.q * (len(xs) - 1)
            lo = int(math.floor(k))
            hi = min(lo + 1, len(xs) - 1)
            return xs[lo] + (xs[hi] - xs[lo]) * (k - lo)
        return self._hq[2]


class RingWindow:
    """Fixed-capacity window over the most recent samples (arrival
    order), for report fields that genuinely need a recent timeline
    (e.g. drift sparklines) without unbounded growth."""

    __slots__ = ("capacity", "_buf", "_next", "n")

    def __init__(self, capacity: int = 32) -> None:
        self.capacity = int(capacity)
        self._buf: List[float] = []
        self._next = 0
        self.n = 0

    def add(self, x: float) -> None:
        x = float(x)
        self.n += 1
        if len(self._buf) < self.capacity:
            self._buf.append(x)
        else:
            self._buf[self._next] = x
            self._next = (self._next + 1) % self.capacity

    def values(self) -> List[float]:
        if len(self._buf) < self.capacity:
            return list(self._buf)
        return self._buf[self._next:] + self._buf[:self._next]

    def __len__(self) -> int:
        return len(self._buf)


class _Series:
    __slots__ = ("mean", "ewma", "hist", "ring", "last")

    def __init__(self, keep_history: bool, window: int,
                 alpha: float) -> None:
        self.mean = StreamingMean()
        self.ewma = EWMA(alpha)
        self.hist: Optional[List[float]] = [] if keep_history else None
        self.ring = RingWindow(window) if window else None
        self.last = 0.0

    def add(self, x: float) -> None:
        x = float(x)
        self.mean.add(x)
        self.ewma.add(x)
        self.last = x
        if self.hist is not None:
            self.hist.append(x)
        if self.ring is not None:
            self.ring.add(x)

    def retained(self) -> int:
        n = 2                              # running sum + ewma
        if self.hist is not None:
            n += len(self.hist)
        if self.ring is not None:
            n += len(self.ring)
        return n


class FleetMetrics:
    """Per-run accumulator for named interval series.

    ``keep_history=False`` (the at-scale default) retains O(1) floats
    per series — running-sum mean, EWMA, last value, optional bounded
    ring window — so fleet memory is O(guests x series), independent of
    ``n_intervals``.  ``keep_history=True`` additionally materializes
    each full series (what ``FleetSim`` used to keep unconditionally)
    for timeline-hungry callers and the streaming-parity tests:
    ``mean(name)`` is computed the same way in both modes, so turning
    history on never changes a report number."""

    def __init__(self, keep_history: bool = False, window: int = 0,
                 alpha: float = 0.25) -> None:
        self.keep_history = bool(keep_history)
        self.window = int(window)
        self.alpha = float(alpha)
        self._series: Dict[str, _Series] = {}

    def _get(self, name: str) -> _Series:
        s = self._series.get(name)
        if s is None:
            s = _Series(self.keep_history, self.window, self.alpha)
            self._series[name] = s
        return s

    def add(self, name: str, value: float) -> None:
        self._get(name).add(value)

    def count(self, name: str) -> int:
        s = self._series.get(name)
        return s.mean.n if s else 0

    def mean(self, name: str) -> float:
        s = self._series.get(name)
        return s.mean.value() if s else 0.0

    def ewma(self, name: str) -> float:
        s = self._series.get(name)
        return s.ewma.value() if s else 0.0

    def last(self, name: str) -> float:
        s = self._series.get(name)
        return s.last if s else 0.0

    def history(self, name: str) -> List[float]:
        """The materialized series (empty unless ``keep_history``)."""
        s = self._series.get(name)
        return list(s.hist) if s is not None and s.hist is not None else []

    def window_values(self, name: str) -> List[float]:
        s = self._series.get(name)
        return s.ring.values() if s is not None and s.ring is not None \
            else []

    def retained_samples(self) -> int:
        """Total floats this accumulator holds — the memory-ceiling
        regression tests assert this stays flat in ``n_intervals`` when
        ``keep_history`` is off."""
        return sum(s.retained() for s in self._series.values())

    def names(self) -> List[str]:
        return sorted(self._series)


class ResidencyPhases:
    """Streaming pre/during/post attack-phase residency means.

    Replaces ``FleetSim._resid_hist`` + ``_residency_phases()``: each
    interval's quiet-domain residency is classified online into the
    pre-attack, under-attack, or post-defense bucket.  The only entries
    whose phase is genuinely unknowable at arrival time are those past
    the attacker's ``stop_interval`` while a defense is armed but has
    not fired yet (the defense may still fire later and claim them for
    the during-bucket); those are parked in a bounded ambiguity buffer
    and flushed on :meth:`finish` — with the shipped AttackSpecs
    (``stop_interval = 10**6``) the buffer stays empty, so memory is
    O(1) in practice and O(n_intervals - stop_interval) worst case."""

    def __init__(self, warmup: int, start: int, stop: int,
                 n_intervals: int, defend: bool) -> None:
        self.warmup = int(warmup)
        self.start = int(start)
        self.stop = int(stop)
        self.n_intervals = int(n_intervals)
        self.defend = bool(defend)
        self.pre = StreamingMean()
        self.dur = StreamingMean()
        self.post = StreamingMean()
        self._pending: List[Tuple[int, float]] = []

    def add(self, k: int, value: float, defended: bool,
            defended_at: int) -> None:
        """Record interval ``k``'s residency.  ``defended``/``defended_at``
        are the latched defense state *as of this interval* — once the
        defense fires, ``defended_at`` never moves, which is what makes
        the online classification exact."""
        if k < self.start:
            if k >= self.warmup:    # only the pre phase skips warmup
                self.pre.add(value)
        elif defended:
            (self.dur if k <= defended_at else self.post).add(value)
        elif k <= min(self.stop, self.n_intervals):
            # a later defense can only set defended_at >= k: still "dur"
            self.dur.add(value)
        elif self.defend:
            # past the attacker's stop with an armed, unfired defense:
            # a late defense at k' > stop would claim k <= k' for "dur"
            self._pending.append((k, value))
        else:
            self.post.add(value)

    def finish(self, defended: bool, defended_at: int) -> None:
        """Flush the ambiguity buffer with the run's final defense
        state; call once, after the last interval."""
        end = defended_at if defended else min(self.stop, self.n_intervals)
        for k, value in self._pending:
            (self.dur if k <= end else self.post).add(value)
        self._pending = []

    def means(self) -> Tuple[float, float, float]:
        return (self.pre.value(), self.dur.value(), self.post.value())
