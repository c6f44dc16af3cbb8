"""`prime_probe`: the wrapper of the CUDA batched Prime+Probe verdict
kernel (`csrc/cache_probe.cu`), the port of the Pallas kernel
`repro.kernels.cache_probe.kernel.prime_probe`.

On CUDA tensors it launches the kernel (and counts the launch in
``_build.LAUNCHES["prime_probe"]``) or raises; on CPU tensors it runs the
plain version, `ref.prime_probe_ref`.
"""

from __future__ import annotations

import torch

from repro_torch import _build
from repro_torch.kernels.cache_probe.ref import prime_probe_ref


def prime_probe(tags: torch.Tensor, age: torch.Tensor,
                streams: torch.Tensor, targets: torch.Tensor,
                clock0: int = 1) -> torch.Tensor:
    """tags/age: (B, W) int32; streams: (B, T) -1-padded prime accesses;
    targets: (B,) int32.  Returns evicted verdicts (B,) bool."""
    if tags.dim() != 2 or age.shape != tags.shape or streams.dim() != 2 \
            or streams.shape[0] != tags.shape[0] \
            or tuple(targets.shape) != (tags.shape[0],):
        raise ValueError(f"prime_probe: shapes tags {tuple(tags.shape)}, "
                         f"age {tuple(age.shape)}, streams "
                         f"{tuple(streams.shape)}, targets "
                         f"{tuple(targets.shape)}")
    if tags.device.type == "cpu":
        return prime_probe_ref(tags, age, streams, targets, clock0=clock0)
    _build.check_cuda("prime_probe", tags, age, streams, targets,
                      dtypes=(torch.int32,) * 4)
    B, W = tags.shape
    T = streams.shape[1]
    evicted = torch.empty(B, dtype=torch.bool, device=tags.device)
    if B == 0:
        return evicted
    work_tags = torch.empty_like(tags)
    work_age = torch.empty_like(age)
    _build.call("cache_probe", "prime_probe_launch",
                _build.ptr(tags), _build.ptr(age), _build.ptr(streams),
                _build.ptr(targets), _build.ptr(work_tags),
                _build.ptr(work_age), _build.ptr(evicted), B, W, T,
                int(clock0), _build.stream(tags.device))
    _build.LAUNCHES["prime_probe"] += 1
    return evicted
