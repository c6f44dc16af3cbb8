"""PlanCost — the analytic ProbePlan cost model's counting terms.

Every physical engine dispatch notes its padded shape in the process-wide
:data:`SHAPE_CACHE` (`host_model._note_shape`), and :func:`plan_cost`
predicts, for any ``ProbePlan`` x ``PlanLowering``:

  - ``dispatches``           engine launches one execution issues
                             (lockstep: shared across all guests),
  - ``padded_steps``         total padded lane-work elements, derived
                             with the executor's own bucket+ladder math
                             (:func:`plan_shapes`),
  - ``compile_hits/misses``  how many of those dispatches repeat a shape
                             the process has already dispatched.

These are counts, the same on any device, and they match the JAX
package's model (`repro.core.plancost`) term for term.  The JAX package
also turns them into a wall estimate and a measured lowering autotuner
(``tune_lowering``) with time constants fit for XLA; the CUDA engine has
different costs (no per-shape compile, one kernel launch per dispatch),
so those constants and the tuner are not carried over until they are
re-measured on the card.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Set, Tuple

import numpy as np

from repro_torch.core.host_model import (_BATCH_BUCKET, _LANE_BUCKET,
                                         _STREAM_BUCKET, _ladder, _round_up,
                                         shard_slices)
from repro_torch.core.probeplan import (Commit, DEFAULT_LOWERING, Measure,
                                        PlanLowering, ProbePlan, Validate,
                                        Vote)


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
    """Predicted counts for one plan execution (see :func:`plan_cost`)."""

    dispatches: int
    padded_steps: int
    compile_hits: int
    compile_misses: int
    shapes: Tuple[Tuple[str, Tuple[int, ...]], ...]


def plan_cost(plan: ProbePlan, lowering: Optional[PlanLowering] = None,
              platform=None, n_guests: int = 1,
              shape_cache: Optional[ShapeCache] = None) -> PlanCost:
    """Predict dispatch count, padded lane work and shape hits/misses for
    one execution of ``plan`` under ``lowering`` on ``platform`` (a
    :class:`~repro_torch.core.platforms.CachePlatform`; None matches cached
    shapes geometry-agnostically).  A shape is a miss only the first time
    it appears — across ``shape_cache`` (default: the process-wide
    :data:`SHAPE_CACHE`) *and* within this plan's own dispatch walk."""
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
    return PlanCost(dispatches=len(shapes), padded_steps=steps,
                    compile_hits=hits, compile_misses=misses,
                    shapes=tuple(shapes))
