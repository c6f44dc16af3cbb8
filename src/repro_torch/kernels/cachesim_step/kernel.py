"""`lru_sets`: the wrapper of the CUDA per-set LRU simulation kernel
(`csrc/cachesim_step.cu`), the port of the Pallas kernel
`repro.kernels.cachesim_step.kernel.lru_sets`.

On CUDA tensors it launches the kernel (and counts the launch in
``_build.LAUNCHES["lru_sets"]``) or raises; on CPU tensors it runs the
plain version, `ref.lru_sets_ref`.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch import _build
from repro_torch.kernels.cachesim_step.ref import lru_sets_ref


def lru_sets(tags: torch.Tensor, age: torch.Tensor, streams: torch.Tensor,
             clock0: int = 1
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """tags/age: (rows, ways) int32; streams: (rows, T) int32, -1 padded.
    Returns (new_tags, new_age, hits (rows, T) bool)."""
    if tags.dim() != 2 or age.shape != tags.shape or streams.dim() != 2 \
            or streams.shape[0] != tags.shape[0]:
        raise ValueError(f"lru_sets: shapes tags {tuple(tags.shape)}, "
                         f"age {tuple(age.shape)}, streams "
                         f"{tuple(streams.shape)}")
    if tags.device.type == "cpu":
        return lru_sets_ref(tags, age, streams, clock0=clock0)
    _build.check_cuda("lru_sets", tags, age, streams,
                      dtypes=(torch.int32,) * 3)
    rows, ways = tags.shape
    T = streams.shape[1]
    out_tags = torch.empty_like(tags)
    out_age = torch.empty_like(age)
    hits = torch.empty((rows, T), dtype=torch.bool, device=tags.device)
    if rows == 0:
        return out_tags, out_age, hits
    _build.call("cachesim_step", "lru_sets_launch",
                _build.ptr(tags), _build.ptr(age), _build.ptr(streams),
                _build.ptr(out_tags), _build.ptr(out_age), _build.ptr(hits),
                rows, ways, T, int(clock0), _build.stream(tags.device))
    _build.LAUNCHES["lru_sets"] += 1
    return out_tags, out_age, hits
