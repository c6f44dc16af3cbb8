"""Effective fast-memory probing + CAP tile selection, on the card.

The port of `repro.tpuprobe.vmem_probe`.  The vCache-size analogue (paper
§2.1 "Mismatched vCache Size"): a runtime keeps back an opaque share of
the nominal fast memory, and the budget a kernel may claim is what is
left.  On the TPU that memory is VMEM (16 MiB, :data:`NOMINAL_VMEM`) and
Mosaic refuses an over-budget tile at compile time.  On the card it is
the shared memory of one SM (228 KiB, :data:`NOMINAL_SMEM`), and CUDA
keeps back 1 KiB of it for each block: a launch asking for more dynamic
shared memory than the opt-in limit is refused with
``cudaErrorInvalidValue``.

`probe_effective_vmem` binary-searches the largest tile that a launch
takes (the probe *is* the eviction-set trick: detection without
documentation).  With ``reserved_model=None`` the oracle launches the
staged `triad` (`kernels.cache_probe.kernel.triad(..., block=rows)`) on
the card, so the card answers; run it with ``lo=1024, hi=NOMINAL_SMEM,
align=1024``.  There is no CPU fallback: without a card it raises.  With
a ``reserved_model`` the hidden reservation is injected and the search
logic runs anywhere, equal to the JAX module's.

`pick_attention_blocks` / `pick_ssd_block` turn a probed budget into
block shapes, the same arithmetic as the JAX module's.  As there, no
kernel calls them.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

import repro_torch
from repro_torch import _build
from repro_torch.kernels.cache_probe import kernel

__all__ = ["NOMINAL_VMEM", "NOMINAL_SMEM", "probe_effective_vmem",
           "pick_attention_blocks", "pick_ssd_block"]

NOMINAL_VMEM = 16 * (1 << 20)
#: the shared memory of one H100 SM, in bytes: 228 KiB (NVIDIA's Hopper
#: tuning guide); one block may claim 227 KiB of it
NOMINAL_SMEM = 233472


def _launch_tile(rows: int) -> None:
    """One staged triad over ``rows`` rows with a tile of ``rows`` rows
    (``rows`` x 512 bytes of shared memory) on the card, synchronized."""
    dev = repro_torch.resolve_device(None)
    a = torch.ones((rows, 128), dtype=torch.float32, device=dev)
    s = torch.ones((1,), dtype=torch.float32, device=dev)
    kernel.triad(a, a, s, block=rows)
    torch.cuda.synchronize(dev)


def _tile_fits_card(tile_bytes: int) -> bool:
    """Whether the card launches a staged triad whose tile is
    ``tile_bytes`` (rows of 512 bytes).

    Only a refused tile counts as "doesn't fit": the card's
    ``cudaErrorInvalidValue`` and the wrapper's own `kernel.TileError`.
    Anything else (a fault in the kernel, a bad argument, no card) is a
    real bug and propagates instead of being misread as a small budget.
    """
    try:
        _launch_tile(tile_bytes // 512)
        return True
    except kernel.TileError:
        return False
    except _build.CudaError as e:
        if e.code == _build.CUDA_ERROR_INVALID_VALUE:
            return False
        raise


def probe_effective_vmem(reserved_model: Optional[int] = None,
                         lo: int = 1 << 20,
                         hi: int = NOMINAL_VMEM,
                         align: int = 1 << 18) -> int:
    """Binary search the largest usable fast-memory working set (bytes).

    `reserved_model`: injected hidden reservation (of
    :data:`NOMINAL_VMEM`); None makes the card the oracle.

    The search runs over multiples of ``align`` (default 256 KiB, the
    tile quantum), so the returned budget is always tile-aligned and is
    exactly the largest aligned size the oracle accepts.
    """
    if reserved_model is not None:
        oracle = lambda b: b <= NOMINAL_VMEM - reserved_model  # noqa: E731
    else:
        oracle = _tile_fits_card
    lo_q = max(1, lo // align)
    hi_q = hi // align
    if hi_q < lo_q or not oracle(lo_q * align):
        return 0
    while lo_q < hi_q:
        mid = (lo_q + hi_q + 1) // 2
        if oracle(mid * align):
            lo_q = mid
        else:
            hi_q = mid - 1
    return lo_q * align


def pick_attention_blocks(effective_vmem: int, head_dim: int,
                          dtype_bytes: int = 2) -> Tuple[int, int]:
    """(block_q, block_k) for a flash kernel given the probed budget.

    Working set per program ~= q(bq,D) + k/v(bk,D)*2 + acc f32(bq,D)
    + p(bq,bk) f32; choose the largest aligned blocks that fit in ~70% of
    the budget (double-buffering headroom).
    """
    budget = 0.7 * effective_vmem

    def fits(bq, bk):
        ws = (bq * head_dim * dtype_bytes + 2 * bk * head_dim * dtype_bytes +
              bq * head_dim * 4 + bq * bk * 4 + 2 * bq * 4)
        return ws <= budget

    best = (128, 128)
    for bq in (512, 256, 128):
        for bk in (1024, 512, 256, 128):
            if fits(bq, bk):
                return (bq, bk)
    return best


def pick_ssd_block(effective_vmem: int, head_dim: int, d_state: int,
                   chunk: int, dtype_bytes: int = 4) -> int:
    """block_h for the SSD kernel: state (hb,p,n) f32 + chunk tiles."""
    budget = 0.7 * effective_vmem
    for hb in (16, 8, 4, 2, 1):
        ws = (hb * head_dim * d_state * 4 +                 # carried state
              hb * chunk * head_dim * dtype_bytes +         # x tile
              hb * chunk * chunk * 4 +                      # decay matrix
              2 * chunk * d_state * dtype_bytes)            # B/C tiles
        if ws <= budget:
            return hb
    return 1
