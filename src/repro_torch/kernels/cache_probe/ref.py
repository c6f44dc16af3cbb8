"""Plain PyTorch batched multi-set Prime+Probe verdict.

Mirrors `repro.kernels.cache_probe.ref.prime_probe_ref`; the CUDA kernel
(`csrc/cache_probe.cu`) is held against it.  The STREAM triad of the JAX
module belongs to the accelerator probes and is not part of this package
yet.
"""

from __future__ import annotations

import torch

from repro_torch.kernels._lru import lru_touch


def prime_probe_ref(tags: torch.Tensor, age: torch.Tensor,
                    streams: torch.Tensor, targets: torch.Tensor,
                    clock0: int = 1) -> torch.Tensor:
    """Per-lane Prime+Probe over independent LRU sets.

    tags/age: (B, W) int32 set states (-1 empty); streams: (B, T) int32
    prime accesses, -1 padded; targets: (B,) int32.  Each lane accesses its
    target (install, MRU), applies its prime stream, then probes the target:
    ``evicted[b]`` is True iff the target is no longer resident.
    """
    tags, age, _ = lru_touch(tags, age, targets, clock0)
    for t in range(streams.shape[1]):
        tags, age, _ = lru_touch(tags, age, streams[:, t], clock0 + 1 + t)
    return ~(tags == targets.to(tags.dtype)[:, None]).any(dim=1)
