"""`triad` and `prime_probe`: the wrappers of the CUDA STREAM triad
(`csrc/triad.cu`) and batched Prime+Probe verdict (`csrc/cache_probe.cu`)
kernels, the ports of the Pallas kernels of
`repro.kernels.cache_probe.kernel`.

On CUDA tensors each launches its kernel (and counts the launch in
``_build.LAUNCHES`` under its name) or raises; on CPU tensors it runs the
plain version in `ref` (`triad` counts that in ``_build.PLAIN_CALLS``).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch import _build
from repro_torch.kernels.cache_probe.ref import prime_probe_ref, triad_ref

__all__ = ["triad", "triad_device_seconds", "prime_probe"]

#: the widest row `csrc/cache_probe.cu` takes: four rows of W tags and W
#: ages in the shared memory of one block
PRIME_PROBE_MAX_WAYS = _build.SMEM_PER_BLOCK // (4 * 2 * 4)


def triad(a: torch.Tensor, b: torch.Tensor,
          scale: torch.Tensor) -> torch.Tensor:
    """a, b: (N, 128) f32 (any equal shapes on the card); scale: (1,) f32
    on the same device.  Returns ``a * scale + b``.  Unlike the Pallas
    kernel (blocks of min(512, N) rows, N a multiple of the block) it takes
    any N; its ``block`` and ``interpret`` arguments have no counterpart."""
    if a.shape != b.shape or tuple(scale.shape) != (1,):
        raise ValueError(f"triad: shapes a {tuple(a.shape)}, b "
                         f"{tuple(b.shape)}, scale {tuple(scale.shape)}")
    _build.refuse_grad("triad", a, b, scale)
    if a.device.type == "cpu":
        _build.PLAIN_CALLS["triad"] += 1
        return triad_ref(a, b, scale)
    _build.check_cuda("triad", a, b, scale, dtypes=(torch.float32,) * 3)
    out = torch.empty_like(a)
    _build.call("triad", "triad_launch", _build.ptr(a), _build.ptr(b),
                _build.ptr(scale), _build.ptr(out), a.numel(),
                _build.stream(a.device))
    _build.LAUNCHES["triad"] += 1
    return out


def triad_device_seconds(a: torch.Tensor, b: torch.Tensor,
                         scale: torch.Tensor, reps: int = 1) -> float:
    """Device seconds per triad over ``reps`` launches on CUDA tensors,
    between CUDA events that no host time falls between
    (``triad_timed_launch``: a spin first, then the start event, the
    launches and the end event, all enqueued by one C call).  A reading
    whose start event had already passed once all was enqueued is
    repeated with a spin twice as long; every launch counts."""
    if a.shape != b.shape or tuple(scale.shape) != (1,) or reps < 1:
        raise ValueError(f"triad: shapes a {tuple(a.shape)}, b "
                         f"{tuple(b.shape)}, scale {tuple(scale.shape)}, "
                         f"reps {reps}")
    _build.check_cuda("triad", a, b, scale, dtypes=(torch.float32,) * 3)
    _build.refuse_grad("triad", a, b, scale)
    out = torch.empty_like(a)
    ms, hidden = ctypes.c_float(), ctypes.c_int()
    spin_us = 200.0
    for _ in range(6):
        _build.call("triad", "triad_timed_launch", _build.ptr(a),
                    _build.ptr(b), _build.ptr(scale), _build.ptr(out),
                    a.numel(), int(reps), spin_us, _build.stream(a.device),
                    ctypes.addressof(ms), ctypes.addressof(hidden))
        _build.LAUNCHES["triad"] += reps
        if hidden.value:
            return ms.value / 1e3 / reps
        spin_us *= 2
    raise RuntimeError(f"triad: the host could not enqueue {reps} launches "
                       f"within a {spin_us / 2:.0f} us spin")


def prime_probe(tags: torch.Tensor, age: torch.Tensor,
                streams: torch.Tensor, targets: torch.Tensor,
                clock0: int = 1) -> torch.Tensor:
    """tags/age: (B, W) int32; streams: (B, T) -1-padded prime accesses;
    targets: (B,) int32.  Returns evicted verdicts (B,) bool.  On the card
    W is at most :data:`PRIME_PROBE_MAX_WAYS` (rows past 32 ways sit in
    shared memory, four rows a block)."""
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
    if not 0 < W <= PRIME_PROBE_MAX_WAYS:
        raise ValueError(f"prime_probe: {W} ways (the kernel takes 1 to "
                         f"{PRIME_PROBE_MAX_WAYS})")
    evicted = torch.empty(B, dtype=torch.bool, device=tags.device)
    if B == 0:
        return evicted
    _build.call("cache_probe", "prime_probe_launch",
                _build.ptr(tags), _build.ptr(age), _build.ptr(streams),
                _build.ptr(targets), _build.ptr(evicted), B, W, T,
                int(clock0), _build.stream(tags.device))
    _build.LAUNCHES["prime_probe"] += 1
    return evicted
