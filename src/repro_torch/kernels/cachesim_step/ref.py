"""Plain PyTorch per-set LRU simulation of pre-partitioned streams.

Cache sets are mutually independent under LRU, so a batch of per-set
access substreams (padded with -1) can be simulated step by step,
vectorized over rows.  Mirrors `repro.kernels.cachesim_step.ref
.lru_sets_ref`; the CUDA kernel (`csrc/cachesim_step.cu`) is held
against it.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels._lru import lru_touch


def lru_sets_ref(tags: torch.Tensor, age: torch.Tensor,
                 streams: torch.Tensor, clock0: int = 1
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """tags/age: (rows, ways) int32; streams: (rows, T) int32, -1 padded.
    Returns (tags, age, hits (rows, T) bool)."""
    hits = []
    for t in range(streams.shape[1]):
        tags, age, hit = lru_touch(tags, age, streams[:, t], clock0 + t)
        hits.append(hit)
    if not hits:
        return tags, age, torch.zeros(streams.shape, dtype=torch.bool,
                                      device=streams.device)
    return tags, age, torch.stack(hits, dim=1)
