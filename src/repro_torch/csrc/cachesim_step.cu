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
// row step t wrote, so the floor is T times the latency of one row update
// (a few L1 round trips of a W-way scan), however many rows run at once.
//
// The simple design: one thread per row (rows spread over ceil(rows/128)
// blocks), the row kept in the output arrays (the thread's own cache
// lines), and the shared `lru_touch` (lru_touch.cuh) applied T times.
// Rows run in parallel; nothing is shared between threads.
#include <cuda_runtime.h>

#include <cstdint>

#include "lru_touch.cuh"

namespace {

__global__ void lru_sets_kernel(const int* __restrict__ tags,
                                const int* __restrict__ age,
                                const int* __restrict__ streams,
                                int* __restrict__ out_tags,
                                int* __restrict__ out_age,
                                uint8_t* __restrict__ hits, int rows, int W,
                                int T, int clock0) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  int* rt = out_tags + (size_t)r * W;
  int* ra = out_age + (size_t)r * W;
  for (int w = 0; w < W; ++w) {
    rt[w] = tags[(size_t)r * W + w];
    ra[w] = age[(size_t)r * W + w];
  }
  const int* s = streams + (size_t)r * T;
  uint8_t* h = hits + (size_t)r * T;
  for (int t = 0; t < T; ++t) {
    const LruTouch res = lru_touch(rt, ra, W, s[t], clock0 + t, -1);
    h[t] = (uint8_t)res.hit;
  }
}

}  // namespace

extern "C" int lru_sets_launch(const void* tags, const void* age,
                               const void* streams, void* out_tags,
                               void* out_age, void* hits, int rows, int W,
                               int T, int clock0, void* stream) {
  const int threads = 128;
  const int blocks = (rows + threads - 1) / threads;
  lru_sets_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int*)tags, (const int*)age, (const int*)streams, (int*)out_tags,
      (int*)out_age, (uint8_t*)hits, rows, W, T, clock0);
  return (int)cudaGetLastError();
}

extern "C" const char* lru_sets_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
