"""Entry point for the per-set LRU simulation kernel
(`repro.kernels.cachesim_step.ops.simulate_rows` in the JAX package)."""

from __future__ import annotations

import torch

from repro_torch.kernels.cachesim_step.kernel import lru_sets


def simulate_rows(tags: torch.Tensor, age: torch.Tensor,
                  streams: torch.Tensor, clock0: int = 1):
    """Simulate every row's stream; returns (tags, age, hits).  The CUDA
    kernel takes any row count, so there is no row blocking to choose."""
    return lru_sets(tags, age, streams, clock0=clock0)
