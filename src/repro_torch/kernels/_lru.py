"""Shared vectorized LRU-touch row update: the plain PyTorch version of
``csrc/lru_touch.cuh``.

`cachesim_step` (per-set simulation), `cache_probe` (Prime+Probe
verdicts) and the engine in `repro_torch.core.cachesim` apply the same
predicated access to a block of independent cache-set rows; keeping the
hit/empty/victim selection in one place keeps them bit-identical by
construction, on the CPU here as in CUDA.  Mirrors
`repro.kernels._lru.lru_touch` (and the engine's ``_touch``): ties pick
the first way, as ``jnp.argmin``/``jnp.argmax`` do.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

INT_MAX = torch.iinfo(torch.int32).max


def lru_touch_victim(tags: torch.Tensor, age: torch.Tensor,
                     blk: torch.Tensor, clk,
                     rand_bits: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                torch.Tensor]:
    """One predicated access across a block of rows, with the victim.

    tags/age: (R, W) int32 (-1 marks an empty way); blk: (R,) block per
    row (-1 = no-op); clk: timestamp written to the touched way (an int or
    an (R,) tensor); rand_bits: None for LRU, else (R,) non-negative
    random bits choosing the way ``rand_bits % W`` on a miss with no empty
    way.  Returns (tags, age, hit, victim): hit (R,) bool (False for
    no-ops), victim (R,) the evicted block (-1 on a hit, a fill of an
    empty way, or a no-op)."""
    R, W = tags.shape
    blk = blk.to(tags.dtype)
    valid = blk >= 0
    hit_mask = tags == blk[:, None]
    hit = hit_mask.any(dim=1) & valid
    empty = tags == -1
    has_empty = empty.any(dim=1)
    repl = torch.where(empty, INT_MAX, age).argmin(dim=1)
    if rand_bits is not None:
        repl = torch.remainder(rand_bits, W)
    victim_way = torch.where(has_empty, empty.to(torch.int8).argmax(dim=1),
                             repl)
    way = torch.where(hit, hit_mask.to(torch.int8).argmax(dim=1), victim_way)
    victim = torch.where(hit | has_empty | ~valid, -1,
                         tags.gather(1, victim_way[:, None])[:, 0])
    write = (torch.arange(W, device=tags.device)[None, :] == way[:, None]) \
        & valid[:, None]
    clk = torch.as_tensor(clk, dtype=age.dtype, device=age.device)
    if clk.dim() == 1:
        clk = clk[:, None]
    tags = torch.where(write, blk[:, None], tags)
    age = torch.where(write, clk, age)
    return tags, age, hit, victim


def lru_touch(tags: torch.Tensor, age: torch.Tensor, blk: torch.Tensor,
              clk) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One predicated LRU access across a block of rows
    (`repro.kernels._lru.lru_touch`): returns (tags, age, hit)."""
    tags, age, hit, _ = lru_touch_victim(tags, age, blk, clk)
    return tags, age, hit
