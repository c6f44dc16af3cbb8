// prime_probe: batched Prime+Probe verdicts over independent LRU sets.
//
// Replaces the Pallas kernel `prime_probe` (src/repro/kernels/cache_probe/
// kernel.py:80, `_prime_probe_kernel` at :53).  Per lane b: install
// targets[b] at MRU with timestamp clock0, apply the lane's -1-padded prime
// stream (step t at clock0 + 1 + t), then probe: evicted[b] is 1 iff the
// target no longer has a resident way.  The input set state is not
// modified: the lane works on its own copy in `work_tags`/`work_age`,
// scratch that the wrapper allocates.
//
// What bounds it on an H100: not bytes.  It reads 4*B*(2W + T + 1) bytes,
// writes 8*B*W bytes of scratch and B verdict bytes (about 80 KB for
// B = 128, W = 8, T = 128: tens of nanoseconds at 3.35 TB/s) and does about
// B*T*W compares.  Each lane is a chain of T + 1 dependent row updates, so
// the floor is (T + 1) times the latency of one W-way row update.
//
// The simple design: one thread per lane, the lane's row in its scratch
// slice, the shared `lru_touch` (lru_touch.cuh) applied T + 1 times, then
// one W-way scan for the verdict.
#include <cuda_runtime.h>

#include <cstdint>

#include "lru_touch.cuh"

namespace {

__global__ void prime_probe_kernel(const int* __restrict__ tags,
                                   const int* __restrict__ age,
                                   const int* __restrict__ streams,
                                   const int* __restrict__ targets,
                                   int* __restrict__ work_tags,
                                   int* __restrict__ work_age,
                                   uint8_t* __restrict__ evicted, int B,
                                   int W, int T, int clock0) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  int* rt = work_tags + (size_t)b * W;
  int* ra = work_age + (size_t)b * W;
  for (int w = 0; w < W; ++w) {
    rt[w] = tags[(size_t)b * W + w];
    ra[w] = age[(size_t)b * W + w];
  }
  const int target = targets[b];
  lru_touch(rt, ra, W, target, clock0, -1);
  const int* s = streams + (size_t)b * T;
  for (int t = 0; t < T; ++t) lru_touch(rt, ra, W, s[t], clock0 + 1 + t, -1);
  int resident = 0;
  for (int w = 0; w < W; ++w) resident |= (rt[w] == target);
  evicted[b] = (uint8_t)!resident;
}

}  // namespace

extern "C" int prime_probe_launch(const void* tags, const void* age,
                                  const void* streams, const void* targets,
                                  void* work_tags, void* work_age,
                                  void* evicted, int B, int W, int T,
                                  int clock0, void* stream) {
  const int threads = 128;
  const int blocks = (B + threads - 1) / threads;
  prime_probe_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int*)tags, (const int*)age, (const int*)streams,
      (const int*)targets, (int*)work_tags, (int*)work_age,
      (uint8_t*)evicted, B, W, T, clock0);
  return (int)cudaGetLastError();
}

extern "C" const char* prime_probe_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
