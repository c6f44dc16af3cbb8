// One predicated access of one cache-set row: the LRU law shared by every
// kernel of this package (cachesim_engine.cu, cachesim_step.cu,
// cache_probe.cu), so the three stay bit-identical by construction.
//
// Replaces src/repro/kernels/_lru.py:17 `lru_touch` (the Pallas helper the
// `lru_sets` and `prime_probe` kernels share) and the engine's `_touch`
// (src/repro/core/cachesim.py:155).  Semantics, as in the reference:
//   * blk < 0 is a no-op (hit = 0, no victim, nothing written);
//   * a hit rewrites the first matching way (jnp.argmax: first index wins);
//   * otherwise the first empty way (-1) is filled, or else the victim is
//     `rand_bits % W` when rand_bits >= 0 (random replacement) or the way
//     with the smallest age (jnp.argmin: first index wins) when
//     rand_bits == -1 (LRU);
//   * the touched way gets tag = blk and age = clk;
//   * `victim` is the evicted block, -1 on a hit or when an empty way was
//     filled.
// One thread owns the row; W is a runtime width (the loops are W long).
#pragma once

#include <climits>
#include <cstdint>

struct LruTouch {
  int hit;     // 1 iff blk was resident
  int way;     // way written (-1 for a no-op)
  int victim;  // evicted block, -1 if none
};

__device__ __forceinline__ LruTouch lru_touch(int* __restrict__ tags,
                                              int* __restrict__ age, int W,
                                              int blk, int clk,
                                              int rand_bits) {
  LruTouch r{0, -1, -1};
  if (blk < 0) return r;
  int hit_way = -1, empty_way = -1, lru_way = 0, lru_age = INT_MAX;
  for (int w = 0; w < W; ++w) {
    const int t = tags[w];
    if (t == blk && hit_way < 0) hit_way = w;
    if (t == -1) {
      if (empty_way < 0) empty_way = w;
    } else {
      const int a = age[w];
      if (a < lru_age) {
        lru_age = a;
        lru_way = w;
      }
    }
  }
  int way;
  if (hit_way >= 0) {
    r.hit = 1;
    way = hit_way;
  } else if (empty_way >= 0) {
    way = empty_way;
  } else {
    way = rand_bits >= 0 ? rand_bits % W : lru_way;
    r.victim = tags[way];
  }
  tags[way] = blk;
  age[way] = clk;
  r.way = way;
  return r;
}
