"""`triad` and `prime_probe`: the wrappers of the CUDA STREAM triad
(`csrc/triad.cu`) and batched Prime+Probe verdict (`csrc/cache_probe.cu`)
kernels, the ports of the Pallas kernels of
`repro.kernels.cache_probe.kernel`.

On CUDA tensors each launches its kernel (and counts the launch in
``_build.LAUNCHES`` under its name: ``triad_staged`` for the triad with a
``block`` tile) or raises; on CPU tensors it runs the plain version in
`ref` (`triad` counts that in ``_build.PLAIN_CALLS``, under the same
names).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch import _build
from repro_torch.kernels._lru import lru_touch  # noqa: F401  (as JAX's)
from repro_torch.kernels.cache_probe.ref import prime_probe_ref, triad_ref

__all__ = ["triad", "triad_device_seconds", "prime_probe", "TileError"]

#: the widest row `csrc/cache_probe.cu` takes: four rows of W tags and W
#: ages in the shared memory of one block
PRIME_PROBE_MAX_WAYS = _build.SMEM_PER_BLOCK // (4 * 2 * 4)


#: the largest staged tile a launch can name: its bytes set the kernel's
#: dynamic shared memory through a C ``int``
MAX_TILE_BYTES = 2 ** 31 - 1


class TileError(ValueError):
    """A staged `triad` tile larger than any launch can request."""


def triad(a: torch.Tensor, b: torch.Tensor, scale: torch.Tensor, *,
          block: Optional[int] = None) -> torch.Tensor:
    """a, b: (N, 128) f32 (any equal shapes on the card without
    ``block``); scale: (1,) f32 on the same device.  Returns ``a * scale +
    b``.  Unlike the Pallas kernel (blocks of min(block, N) rows, N a
    multiple of the block) it takes any N.

    ``block=None`` streams (the monitor's probe).  ``block=rows`` stages
    ``a`` through a tile of exactly ``rows`` x 128 f32 of shared memory, as
    the Pallas kernel's VMEM tile: every tile is whole but the last, which
    holds N mod rows rows (when that is not 0).  The card refuses a tile
    over its opt-in shared-memory limit with ``_build.CudaError`` (code
    ``_build.CUDA_ERROR_INVALID_VALUE``); a tile over
    :data:`MAX_TILE_BYTES` raises :class:`TileError` here.  The Pallas
    kernel's ``interpret`` argument has no counterpart."""
    if a.shape != b.shape or tuple(scale.shape) != (1,):
        raise ValueError(f"triad: shapes a {tuple(a.shape)}, b "
                         f"{tuple(b.shape)}, scale {tuple(scale.shape)}")
    name = "triad" if block is None else "triad_staged"
    if block is not None:
        if a.dim() != 2 or a.shape[1] != 128 or block < 1:
            raise ValueError(f"triad: a staged tile of {block} rows over "
                             f"a {tuple(a.shape)}: rows of 128, block >= 1")
        if block * 512 > MAX_TILE_BYTES:
            raise TileError(f"triad: a tile of {block} rows is "
                            f"{block * 512} bytes, over {MAX_TILE_BYTES}")
    _build.refuse_grad("triad", a, b, scale)
    if a.device.type == "cpu":
        _build.PLAIN_CALLS[name] += 1
        return triad_ref(a, b, scale)
    _build.check_cuda("triad", a, b, scale, dtypes=(torch.float32,) * 3)
    out = torch.empty_like(a)
    if block is None:
        _build.call("triad", "triad_launch", _build.ptr(a), _build.ptr(b),
                    _build.ptr(scale), _build.ptr(out), a.numel(),
                    _build.stream(a.device))
    elif a.shape[0]:
        _build.call("triad", "triad_staged_launch", _build.ptr(a),
                    _build.ptr(b), _build.ptr(scale), _build.ptr(out),
                    a.shape[0], int(block), _build.stream(a.device))
    else:
        return out
    _build.LAUNCHES[name] += 1
    return out


def triad_device_seconds(a: torch.Tensor, b: torch.Tensor,
                         scale: torch.Tensor, reps: int = 1) -> float:
    """Device seconds per triad over ``reps`` launches on CUDA tensors,
    between CUDA events that no host time falls between
    (``triad_timed_launch``: a spin first, then the start event, the
    launches and the end event, all enqueued by one C call).  A reading
    whose start event had already passed once all was enqueued is
    repeated with a spin twice as long; every launch counts in
    ``_build.LAUNCHES``, and those of a reading taken again in
    ``_build.REPEATED_LAUNCHES`` as well."""
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
        _build.REPEATED_LAUNCHES["triad"] += reps
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
