// lru_sets: per-set LRU simulation, sequential over T, parallel over rows.
//
// Replaces the Pallas kernel `lru_sets` (src/repro/kernels/cachesim_step/
// kernel.py:44, `_lru_kernel` at :27): rows independent cache sets, each
// applying its own (rows, T) -1-padded access stream with clock0 + t as the
// timestamp of step t.  Outputs the final tags/ages and a (rows, T) hit mask.
//
// What bounds it on an H100: not bytes.  It moves 4*rows*(4W + T) bytes plus
// rows*T hit bytes (about 0.8 MB for 1024 rows x 8 ways x 128 steps, a
// quarter of a microsecond at 3.35 TB/s), and does about rows*T*W compares.
// It is a chain of T dependent row updates per set: step t+1 reads the
// row step t wrote, so the floor is T times the latency of one row update,
// however many rows run at once.
//
// The design makes that update a warp touch on registers.  One warp owns a
// row, four rows a block (1024 rows: 256 blocks over every SM), and lane l
// holds ways l, l + 32, ... in registers (`RegRow<NR>`, NR = ceil(W / 32)
// rounded up to 1, 2, 4 or 8; rows past 256 ways stay in the output arrays,
// `MemRow`).  A step is `lru_touch_warp` (lru_touch.cuh): ballots and warp
// minima with no branch and no memory round trip, so the floor is T times
// the latency of those votes.  The stream arrives 32 steps at a time, one
// coalesced load a chunk issued a chunk ahead, one step a lane, handed to
// the warp by shuffles; a step's hit flag is the same in every lane, so the
// chunk's 32 flags gather into one mask and leave as 32 coalesced bytes, a
// lane each.  At the end each lane writes its own ways.
#include <cuda_runtime.h>

#include <cstdint>

#include "lru_touch.cuh"

namespace {

constexpr int kWarps = 4;

template <int NR>
__device__ __forceinline__ void fill(RegRow<NR, false>& row, const int* tags,
                                     const int* age, int*, int*, int W) {
  row.load(tags, age, W);
}

__device__ __forceinline__ void fill(MemRow& row, const int* tags,
                                     const int* age, int* out_tags,
                                     int* out_age, int W) {
  row.bind_copy(tags, age, out_tags, out_age, W);
}

template <int NR>
__device__ __forceinline__ void store(const RegRow<NR, false>& row,
                                      int* out_tags, int* out_age, int W) {
#pragma unroll
  for (int k = 0; k < NR; ++k) {
    const int w = 32 * k + warp_lane();
    if (w < W) {
      out_tags[w] = row.tag(k);
      out_age[w] = row.age(k);
    }
  }
}

__device__ __forceinline__ void store(const MemRow&, int*, int*, int) {}

template <class Row>
__global__ void __launch_bounds__(32 * kWarps)
    lru_sets_kernel(const int* __restrict__ tags, const int* __restrict__ age,
                    const int* __restrict__ streams,
                    int* __restrict__ out_tags, int* __restrict__ out_age,
                    uint8_t* __restrict__ hits, int rows, int W, int T,
                    int clock0) {
  const int r = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (r >= rows) return;  // the whole warp
  const int lane = warp_lane();
  const size_t at = (size_t)r * W;
  Row row;
  fill(row, tags + at, age + at, out_tags + at, out_age + at, W);
  const int* s = streams + (size_t)r * T;
  uint8_t* h = hits + (size_t)r * T;
  int next = lane < T ? s[lane] : -1;
  for (int t0 = 0; t0 < T; t0 += 32) {
    const int chunk = next;
    if (t0 + 32 + lane < T) next = s[t0 + 32 + lane];
    const int n = min(32, T - t0);
    unsigned hit = 0;  // bit j: step t0 + j hit (the same in every lane)
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      if (j == n) break;
      const LruTouch res = lru_touch_warp(
          row, W, __shfl_sync(kFullWarp, chunk, j), clock0 + t0 + j, -1);
      if (!Row::kLaneOwned) __syncwarp();  // every lane reads the row next
      hit |= (unsigned)res.hit << j;
    }
    if (lane < n) h[t0 + lane] = (uint8_t)((hit >> lane) & 1u);
  }
  store(row, out_tags + at, out_age + at, W);
}

template <class Row>
int launch(const int* tags, const int* age, const int* streams, int* out_tags,
           int* out_age, uint8_t* hits, int rows, int W, int T, int clock0,
           cudaStream_t stream) {
  lru_sets_kernel<Row>
      <<<(rows + kWarps - 1) / kWarps, 32 * kWarps, 0, stream>>>(
          tags, age, streams, out_tags, out_age, hits, rows, W, T, clock0);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int lru_sets_launch(const void* tags, const void* age,
                               const void* streams, void* out_tags,
                               void* out_age, void* hits, int rows, int W,
                               int T, int clock0, void* stream) {
  const auto go = [&](auto row) {
    return launch<decltype(row)>(
        (const int*)tags, (const int*)age, (const int*)streams,
        (int*)out_tags, (int*)out_age, (uint8_t*)hits, rows, W, T, clock0,
        (cudaStream_t)stream);
  };
  if (W <= 32) return go(RegRow<1, false>{});
  if (W <= 64) return go(RegRow<2, false>{});
  if (W <= 128) return go(RegRow<4, false>{});
  if (W <= 256) return go(RegRow<8, false>{});
  return go(MemRow{});
}

extern "C" const char* lru_sets_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
