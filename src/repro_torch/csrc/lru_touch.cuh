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
// The law's CUDA form is the warp touch, `lru_touch_warp`: the 32 lanes
// of a warp share the row, lane l holding ways l, l + 32, l + 64, ... (any
// W, a runtime width), so a touch is a few warp votes and reductions
// instead of a W-long chain of loads.  All three kernels run it, one warp
// a row (`lru_sets`, `prime_probe`) or a lane (the engine).
#pragma once

#include <climits>
#include <cstdint>

struct LruTouch {
  int hit;     // 1 iff blk was resident
  int way;     // way written (-1 for a no-op)
  int victim;  // evicted block, -1 if none
};

// ---------------------------------------------------------------------------
// The warp touch.  Every lane of the warp calls it with the same blk, clk,
// rand_way and W, and the full warp must be converged.  Where the
// reference takes rand_bits, it takes rand_way: the way random
// replacement evicts (rand_bits % W, which the caller may compute by a
// cheaper division than `%`), or -1 under LRU.  It has no branch: the
// hit, empty and LRU ways are all found and the result selected, so two
// touches of one step (the engine's L2 and LLC rows) interleave.  The row
// is reached through `Row`, one of the two holders below:
//   Row::tag(k), Row::age(k)  this lane's way 32 k + lane (k < rounds(W));
//   Row::tag_at(way)          any way's tag, the same value in every lane;
//   Row::set(way, t, a, on)   writes one way if `on`.
// A row in memory that another lane reads next needs the caller's
// __syncwarp() after the touch.  First index wins, as in the reference:
// the hit and empty ways are the lowest set bit of a ballot in the
// first round that has one; the LRU way is the lowest way index whose age
// equals the warp's minimum age (__reduce_min_sync over each lane's first
// minimum), and way 0 when every age is INT_MAX, as the reference's
// argmin over all-equal ages.
constexpr unsigned kFullWarp = 0xffffffffu;

__device__ __forceinline__ int warp_lane() { return threadIdx.x & 31; }

// The row in registers: lane l holds ways l + 32 k for k < NR, so W is at
// most 32 NR.  Ways at or past W hold tag -2 (never a hit, never empty) and
// age INT_MAX (never the LRU way).  `load` reads the lane's ways from a
// row in memory (shared or device).  With kMemory, `bind` also makes `set`
// store the written way back there, and `bind_copy` does so into a second
// row, which gets the lane's ways first.  Every memory access to way w is
// lane (w mod 32)'s own (kLaneOwned), so the row needs no __syncwarp().
template <int NR, bool kMemory = true>
struct RegRow {
  static constexpr bool kLaneOwned = true;
  int t[NR], a[NR];
  int* mt;
  int* ma;
  static __device__ constexpr int rounds(int) { return NR; }
  __device__ __forceinline__ void load(const int* tags, const int* age,
                                       int W) {
#pragma unroll
    for (int k = 0; k < NR; ++k) {
      const int w = 32 * k + warp_lane();
      t[k] = w < W ? tags[w] : -2;
      a[k] = w < W ? age[w] : INT_MAX;
    }
  }
  __device__ __forceinline__ void bind(int* tags, int* age, int W) {
    load(tags, age, W);
    mt = tags;
    ma = age;
  }
  __device__ __forceinline__ void bind_copy(const int* tags, const int* age,
                                            int* to_tags, int* to_age,
                                            int W) {
    load(tags, age, W);
#pragma unroll
    for (int k = 0; k < NR; ++k) {
      const int w = 32 * k + warp_lane();
      if (w < W) {
        to_tags[w] = t[k];
        to_age[w] = a[k];
      }
    }
    mt = to_tags;
    ma = to_age;
  }
  __device__ __forceinline__ int tag(int k) const { return t[k]; }
  __device__ __forceinline__ int age(int k) const { return a[k]; }
  __device__ __forceinline__ int tag_at(int way) const {
    int v = t[0];
#pragma unroll
    for (int k = 1; k < NR; ++k)
      if (k == (way >> 5)) v = t[k];
    return __shfl_sync(kFullWarp, v, way & 31);
  }
  __device__ __forceinline__ void set(int way, int tag_, int age_, bool on) {
    if (on && warp_lane() == (way & 31)) {
#pragma unroll
      for (int k = 0; k < NR; ++k)
        if (k == (way >> 5)) {
          t[k] = tag_;
          a[k] = age_;
        }
      if (kMemory) {
        mt[way] = tag_;
        ma[way] = age_;
      }
    }
  }
};

// The row in memory (shared or device), for any W: every read goes to it,
// and lanes read ways other lanes wrote (tag_at): sync after a touch.
struct MemRow {
  static constexpr bool kLaneOwned = false;
  int* mt;
  int* ma;
  int W;
  static __device__ int rounds(int W_) { return (W_ + 31) >> 5; }
  __device__ __forceinline__ void bind(int* tags, int* age, int W_) {
    mt = tags;
    ma = age;
    W = W_;
  }
  __device__ __forceinline__ void bind_copy(const int* tags, const int* age,
                                            int* to_tags, int* to_age,
                                            int W_) {
    for (int w = warp_lane(); w < W_; w += 32) {
      to_tags[w] = tags[w];
      to_age[w] = age[w];
    }
    __syncwarp();
    bind(to_tags, to_age, W_);
  }
  __device__ __forceinline__ int tag(int k) const {
    const int w = 32 * k + warp_lane();
    return w < W ? mt[w] : -2;
  }
  __device__ __forceinline__ int age(int k) const {
    const int w = 32 * k + warp_lane();
    return w < W ? ma[w] : INT_MAX;
  }
  __device__ __forceinline__ int tag_at(int way) const { return mt[way]; }
  __device__ __forceinline__ void set(int way, int tag_, int age_, bool on) {
    if (on && warp_lane() == (way & 31)) {
      mt[way] = tag_;
      ma[way] = age_;
    }
  }
};

// The touch in three phases, so that a caller touching two rows (the
// engine's L2 and LLC rows) can interleave them and overlap their warp
// votes and reductions: `warp_scan` votes on the row, `warp_choose` picks
// the way, `warp_write` reads the victim and writes the way.
struct WarpScan {
  int hit_way, empty_way;  // first hit and first empty way, -1 if none
  int my_age, my_way;      // this lane's first minimum-age way
};

template <class Row>
__device__ __forceinline__ WarpScan warp_scan(const Row& row, int W,
                                              int blk) {
  const int lane = warp_lane();
  const bool valid = blk >= 0;
  WarpScan x{-1, -1, INT_MAX, INT_MAX};
  const int R = Row::rounds(W);
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const int t = row.tag(k);
    const int a = row.age(k);
    const unsigned hits = __ballot_sync(kFullWarp, valid && t == blk);
    const unsigned empties = __ballot_sync(kFullWarp, t == -1);
    if (x.hit_way < 0 && hits) x.hit_way = 32 * k + __ffs(hits) - 1;
    if (x.empty_way < 0 && empties) x.empty_way = 32 * k + __ffs(empties) - 1;
    if (t != -1 && a < x.my_age) {  // ways past W: age INT_MAX, never taken
      x.my_age = a;
      x.my_way = 32 * k + lane;
    }
  }
  return x;
}

template <class Row>
__device__ __forceinline__ int warp_choose(const WarpScan& x, int W,
                                           int rand_way) {
  const int m = __reduce_min_sync(kFullWarp, x.my_age);
  int lru;
  if (Row::rounds(W) == 1) {  // my_way is the lane: the lowest lane at m
    const unsigned at_min =
        __ballot_sync(kFullWarp, x.my_way != INT_MAX && x.my_age == m);
    lru = at_min ? __ffs(at_min) - 1 : 0;
  } else {
    lru = __reduce_min_sync(kFullWarp, x.my_age == m ? x.my_way : INT_MAX);
    if (lru == INT_MAX) lru = 0;
  }
  const int miss_way =
      x.empty_way >= 0 ? x.empty_way : (rand_way >= 0 ? rand_way : lru);
  return x.hit_way >= 0 ? x.hit_way : miss_way;
}

template <class Row>
__device__ __forceinline__ LruTouch warp_write(Row& row, const WarpScan& x,
                                               int way, int blk, int clk) {
  const bool valid = blk >= 0;
  const int old = row.tag_at(way);
  row.set(way, blk, clk, valid);
  LruTouch r;
  r.hit = valid && x.hit_way >= 0;
  r.way = valid ? way : -1;
  r.victim = valid && x.hit_way < 0 && x.empty_way < 0 ? old : -1;
  return r;
}

template <class Row>
__device__ __forceinline__ LruTouch lru_touch_warp(Row& row, int W, int blk,
                                                   int clk, int rand_way) {
  const WarpScan x = warp_scan(row, W, blk);
  return warp_write(row, x, warp_choose<Row>(x, W, rand_way), blk, clk);
}
