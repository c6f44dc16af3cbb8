"""Entry point for the batched Prime+Probe verdict kernel
(`repro.kernels.cache_probe.ops.probe_verdicts` in the JAX package)."""

from __future__ import annotations

import torch

from repro_torch.kernels.cache_probe.kernel import prime_probe


def probe_verdicts(tags: torch.Tensor, age: torch.Tensor,
                   streams: torch.Tensor, targets: torch.Tensor,
                   clock0: int = 1) -> torch.Tensor:
    """Batched multi-set Prime+Probe eviction verdicts (one launch).

    B simultaneous single-set eviction tests over pre-resolved set rows.
    The probing pipeline (`run_cachex`) does not call it: its eviction
    tests run on the full machine engine, which adds slices, the L2 level
    and back-invalidation.  It is held against `ref.prime_probe_ref` and
    against that engine on a single-level geometry in the tests.
    """
    return prime_probe(tags, age, streams, targets, clock0=clock0)
