"""CacheShield-style attack detection over VSCAN snapshots.

A Prime+Probe attacker and VSCAN's own monitor are the same machinery
pointed in opposite directions: the attacker primes a handful of target
(set, slice) cells with its own eviction sets every window and times the
re-probe, so from the *victim's* monitor the attack shows up as periodic
whole-set evictions concentrated on few monitored sets.  CacheShield
(Briongos et al., PAPERS.md) observed that victims can self-monitor for
exactly this signature; `CacheShield` here is the VSCAN consumer that
does so, fed per-window eviction fractions from `VScanSnapshot`.

The classifier is a per-set CUSUM over *burst* indicators:

  ``x_i = 1`` when set ``i`` lost ``>= high_frac`` of its lines this
  window (a whole-set eviction burst), else 0.  The background
  ``b = mean(x)`` absorbs broad load, and each set accumulates
  ``S_i = max(0, S_i + x_i - b - slack)`` while bursting (fast decay
  ``-clear_decay`` while quiet).  An attack verdict needs sets over the
  CUSUM ``threshold`` that are *concentrated* — at most
  ``max_attack_frac`` of the monitored population — for ``min_windows``
  consecutive windows.

That shape separates the three-way taxonomy without hypercalls:

  * **benign contention** — co-tenant traffic spread over the cache
    saturates many sets (``b -> 1`` kills the CUSUM growth) or evicts
    only part of a set per window (``x_i = 0``);
  * **drift** — a CAT shrink self-conflicts every live set at fraction
    ``(w_old - w_new)/w_old`` (< ``high_frac``) and a remap *under*-fills
    its cells, so neither bursts; drift stays VSCAN's job
    (`confirm_drift`'s zero-wait check is contention- and attacker-proof
    because co-tenants only emit while the guest waits);
  * **attack** — near-total eviction of a *minority* of sets, window
    after window, which honest load almost never sustains.

`CacheXSession` owns the wiring: the shield only runs once
`subscribe_attack()` has a subscriber, onset quarantines the attacked
sets (`VScan.flag_sets`) so their garbage stops feeding CAS/CAP
aggregates, and the cleared transition runs `VScan.confirm_clean()` to
un-quarantine structurally intact sets once the attacker stops.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

#: Per-window eviction fraction at/above which a set counts as a
#: whole-set burst.  Attack priming refills the victim set's cell every
#: window (fraction ~1.0); a CAT capacity loss self-conflicts at
#: (w_old-w_new)/w_old (0.25-0.5 for the modeled platforms) and honest
#: traffic rarely clears a whole set within one window.
HIGH_FRAC = 0.9
#: CUSUM alarm level: with concentrated bursts growing the score by
#: roughly ``1 - slack`` per window, 2.0 is ~3 windows of evidence.
THRESHOLD = 2.0
#: Per-window slack subtracted from the burst indicator before it feeds
#: the CUSUM (tolerates occasional full evictions from load spikes).
SLACK = 0.25
#: Consecutive attack-shaped windows (some-but-few sets over threshold)
#: required before an AttackSignal is emitted.
MIN_WINDOWS = 2
#: An attack verdict requires the alarming sets to be a minority:
#: at most this fraction of the monitored population.  Broad elevation
#: (contention storms, domain-wide pollution) classifies as "broad".
MAX_ATTACK_FRAC = 0.34
#: CUSUM decay per quiet (non-burst) window — much faster than the
#: symmetric CUSUM so detection clears promptly after the attacker stops.
CLEAR_DECAY = 0.75
#: Consecutive windows with no set over threshold before an ongoing
#: attack is declared cleared.
CLEAR_WINDOWS = 2


@dataclasses.dataclass(frozen=True)
class AttackSignal:
    """Sustained Prime+Probe-shaped interference distilled to an event.

    The analogue of `DriftSignal` for the adversarial signal class:
    emitted once per attack episode when concentrated whole-set eviction
    bursts persist for ``min_windows`` windows.  ``set_indices`` are
    monitored-set indices (the victim's frame of reference, same
    indexing as `VScan.monitored`)."""

    kind: str                  # "prime_probe" (burst signature)
    set_indices: Tuple[int, ...]
    score: float               # max per-set CUSUM at onset
    time_ms: float
    windows: int               # consecutive attack-shaped windows


@dataclasses.dataclass(frozen=True)
class WindowVerdict:
    """Per-window classification: ``label`` is one of ``"benign"``,
    ``"attack"``, ``"broad"`` (broad elevation = contention or drift —
    not the shield's call to make; VSCAN's drift machinery arbitrates).
    ``onset``/``cleared`` mark attack state transitions."""

    label: str
    alarm_sets: Tuple[int, ...]
    score: float
    onset: Optional[AttackSignal] = None
    cleared: bool = False


class CacheShield:
    """Streaming detector; feed one `VScanSnapshot` per window."""

    def __init__(self, n_sets: int = 0, *, threshold: float = THRESHOLD,
                 slack: float = SLACK, high_frac: float = HIGH_FRAC,
                 min_windows: int = MIN_WINDOWS,
                 max_attack_frac: float = MAX_ATTACK_FRAC,
                 clear_decay: float = CLEAR_DECAY,
                 clear_windows: int = CLEAR_WINDOWS):
        self.threshold = threshold
        self.slack = slack
        self.high_frac = high_frac
        self.min_windows = max(1, int(min_windows))
        self.max_attack_frac = max_attack_frac
        self.clear_decay = clear_decay
        self.clear_windows = max(1, int(clear_windows))
        self.score = np.zeros(n_sets)
        self.under_attack = False
        self.attacked: set = set()     # union of alarming sets this episode
        self._attack_streak = 0
        self._quiet_streak = 0
        self.windows = 0
        self.signals: List[AttackSignal] = []

    # -- streaming interface ---------------------------------------------------
    def observe(self, snap) -> WindowVerdict:
        """Classify one `VScanSnapshot` window."""
        return self.observe_frac(np.asarray(snap.eviction_frac, float),
                                 time_ms=float(snap.time_ms))

    def observe_frac(self, frac: np.ndarray,
                     time_ms: float = 0.0) -> WindowVerdict:
        """Core classifier on a raw per-set eviction-fraction vector —
        also the replay entry point for recorded traces (benchmarks' ROC
        sweep, the labeled-fixture tests)."""
        frac = np.asarray(frac, float)
        n = len(frac)
        if n != len(self.score):          # monitor population changed
            self.score = np.zeros(n)
        self.windows += 1
        burst = frac >= self.high_frac
        b = float(np.mean(burst)) if n else 0.0
        grow = burst.astype(float) - b - self.slack
        self.score = np.where(burst,
                              np.minimum(np.maximum(0.0, self.score + grow),
                                         2.0 * self.threshold),
                              np.maximum(0.0, self.score - self.clear_decay))
        alarm = np.flatnonzero(self.score >= self.threshold)
        limit = max(1, int(self.max_attack_frac * n))

        onset: Optional[AttackSignal] = None
        cleared = False
        if 0 < len(alarm) <= limit:
            label = "attack"
            self._attack_streak += 1
            self._quiet_streak = 0
            self.attacked.update(int(i) for i in alarm)
            if not self.under_attack and self._attack_streak >= self.min_windows:
                self.under_attack = True
                onset = AttackSignal(
                    kind="prime_probe",
                    set_indices=tuple(sorted(self.attacked)),
                    score=float(np.max(self.score[alarm])),
                    time_ms=time_ms,
                    windows=self._attack_streak)
                self.signals.append(onset)
        else:
            label = "broad" if len(alarm) else "benign"
            self._attack_streak = 0
            if not len(alarm):
                self._quiet_streak += 1
                if self.under_attack and self._quiet_streak >= self.clear_windows:
                    self.under_attack = False
                    self.attacked.clear()
                    cleared = True
            else:
                self._quiet_streak = 0
        return WindowVerdict(label=label,
                             alarm_sets=tuple(int(i) for i in alarm),
                             score=float(np.max(self.score)) if n else 0.0,
                             onset=onset, cleared=cleared)


def classify_trace(fracs: Sequence[np.ndarray], **params) -> Dict:
    """Replay a recorded per-window eviction-fraction trace through a
    fresh `CacheShield`.  Returns ``{"detected", "detect_window",
    "onsets", "labels"}`` — the contract the ROC benchmark sweep and the
    labeled-fixture differential test share."""
    sh = CacheShield(**params)
    labels: List[str] = []
    detect_window = -1
    onsets = 0
    for w, frac in enumerate(fracs):
        v = sh.observe_frac(np.asarray(frac, float), time_ms=float(w))
        labels.append(v.label)
        if v.onset is not None:
            onsets += 1
            if detect_window < 0:
                detect_window = w
    return {"detected": detect_window >= 0, "detect_window": detect_window,
            "onsets": onsets, "labels": labels}
