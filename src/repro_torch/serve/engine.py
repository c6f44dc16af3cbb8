"""Batched serving engine: wave-scheduled decode with CAS replica routing.
The port of `repro.serve.engine`.

Requests are packed into waves of up to `batch_slots` sequences that share
a position counter; while a slot is still inside its prompt the next input
token is teacher-forced from the prompt, afterwards it is the slot's own
argmax sample (taken on the host).  One decode step serves the whole wave
per position (static batching).  Like the JAX engine it has no prefill:
every prompt token goes through `lm.decode_step`.

Across model replicas `ReplicaRouter` applies CAS (paper §4.1): route to
the replica whose contention tier is best, ties by load.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.cas import TierTracker
from repro_torch.models import lm

__all__ = ["Request", "ReplicaRouter", "ServeEngine"]


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray             # (S,) int32
    max_new: int = 16
    out: List[int] = dataclasses.field(default_factory=list)
    replica: Optional[int] = None


class ReplicaRouter:
    """CAS routing across model replicas (tier-preferred, least-loaded).

    Every ``route()``/``assign()`` must be paired with a ``release()``/
    ``complete()`` when the request finishes: the load counters are the
    tie-breaker.  ``assign``/``complete`` carry the pairing on the request
    itself.
    """

    def __init__(self, n_replicas: int, tiers: Optional[TierTracker] = None):
        self.n = n_replicas
        self.tiers = tiers or TierTracker(keys=list(range(n_replicas)))
        self.load = np.zeros(n_replicas, int)

    def on_contention(self, view) -> None:
        """`CacheXSession.subscribe` target: feed a published contention
        view's per-domain rates into the tier tracker (replica index ==
        LLC domain)."""
        self.tiers.on_contention(view)

    def route(self) -> int:
        t = self.tiers.tier
        order = sorted(range(self.n), key=lambda r: (t.get(r, 0),
                                                     self.load[r]))
        r = order[0]
        self.load[r] += 1
        return r

    def assign(self, req: Request) -> int:
        """Route ``req`` and record the binding on it."""
        req.replica = self.route()
        return req.replica

    def release(self, r: int) -> None:
        if self.load[r] <= 0:
            raise ValueError(f"release of replica {r} with zero in-flight "
                             f"load: unbalanced route/release pairing")
        self.load[r] -= 1

    def complete(self, req: Request) -> None:
        """Request finished: drop its replica's in-flight load (no-op for
        a request that was never assigned)."""
        if req.replica is None:
            return
        self.release(req.replica)
        req.replica = None


class ServeEngine:
    """Serves requests on one device: ``device`` None means the CUDA card,
    and the parameters must live on the device.  Every family that
    decodes is served (vlm text-only, through `lm.decode_step`); the
    encoder, whose config has ``supports_decode`` False, is refused here
    with ``ValueError``."""

    def __init__(self, cfg: ArchConfig, params, batch_slots: int = 8,
                 max_len: int = 512, dtype=torch.bfloat16,
                 router: Optional[ReplicaRouter] = None, device=None):
        lm._refuse_decode(cfg)
        self.device = lm._on(params, device)
        self.cfg = cfg
        self.params = params
        self.slots = batch_slots
        self.max_len = max_len
        self.dtype = dtype
        self.queue: deque = deque()
        self.done: List[Request] = []
        self.router = router

    def _decode(self, caches, tokens: torch.Tensor, pos: int):
        return lm.decode_step(self.cfg, self.params, caches, tokens, pos,
                              self.dtype)

    def submit(self, req: Request) -> None:
        if self.router is not None and req.replica is None:
            self.router.assign(req)
        self.queue.append(req)

    # -- one wave -----------------------------------------------------------------
    def _run_wave(self, wave: List[Request]) -> None:
        B = self.slots
        caches = lm.init_caches(self.cfg, B, self.max_len, self.dtype,
                                self.device)
        prompts = [r.prompt for r in wave]
        plens = np.array([len(p) for p in prompts] + [1] * (B - len(wave)))
        need = np.array([r.max_new for r in wave] + [0] * (B - len(wave)))
        horizon = int(min(self.max_len - 1, (plens + need).max()))
        tokens = np.zeros((B, 1), np.int32)
        for i, p in enumerate(prompts):
            tokens[i, 0] = p[0]

        for pos in range(horizon):
            logits, caches = self._decode(
                caches, torch.as_tensor(tokens, device=self.device), pos)
            nxt = logits[:, -1, :].argmax(dim=-1).cpu().numpy()
            for i, r in enumerate(wave):
                gen_started = pos + 1 >= plens[i]
                if gen_started and len(r.out) < r.max_new:
                    r.out.append(int(nxt[i]))
                # next input: teacher-forced prompt token or own sample
                if pos + 1 < plens[i]:
                    tokens[i, 0] = prompts[i][pos + 1]
                else:
                    tokens[i, 0] = int(nxt[i])
            if all(len(r.out) >= r.max_new for r in wave):
                break
        if self.router is not None:
            for r in wave:
                self.router.complete(r)
        self.done.extend(wave)

    def run_until_drained(self, max_waves: int = 1000) -> List[Request]:
        waves = 0
        while self.queue and waves < max_waves:
            wave = []
            while self.queue and len(wave) < self.slots:
                wave.append(self.queue.popleft())
            self._run_wave(wave)
            waves += 1
        return self.done
