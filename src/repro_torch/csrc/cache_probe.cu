// prime_probe: batched Prime+Probe verdicts over independent LRU sets.
//
// Replaces the Pallas kernel `prime_probe` (src/repro/kernels/cache_probe/
// kernel.py:80, `_prime_probe_kernel` at :53).  Per lane b: install
// targets[b] at MRU with timestamp clock0, apply the lane's -1-padded prime
// stream (step t at clock0 + 1 + t), then probe: evicted[b] is 1 iff the
// target no longer has a resident way.  The input set state is not
// modified.
//
// What bounds it on an H100: not bytes.  It reads 4*B*(2W + T + 1) bytes
// and writes B verdict bytes (about 75 KB for B = 128, W = 8, T = 128:
// tens of nanoseconds at 3.35 TB/s) and does about B*T*W compares.  Each
// lane is a chain of T + 1 dependent row updates, so the floor is (T + 1)
// times the latency of one W-way row update.
//
// The design shortens that update.  The first design gave each lane one
// thread that walked its row in device-memory scratch, W loads and
// compares a step.  Here one warp owns a lane: lane l of the warp holds
// way l of the row in registers (ways l + 32 k in shared memory when W >
// 32), and each step is `lru_touch_warp` (lru_touch.cuh): two ballots and
// two warp minimum reductions, no branch.  The stream arrives 32
// steps at a time, one coalesced load a chunk issued a chunk ahead, and is
// handed to the steps by shuffles; the verdict is one ballot.  Four warps
// (four lanes) a block, so B = 128 spreads over 32 SMs.
#include <cuda_runtime.h>

#include <cstdint>

#include "lru_touch.cuh"

namespace {

constexpr int kWarps = 4;

template <int NR>
__device__ __forceinline__ void fill(RegRow<NR, false>& row, const int* tags,
                                     const int* age, int W, int*) {
  row.load(tags, age, W);
}

__device__ __forceinline__ void fill(MemRow& row, const int* tags,
                                     const int* age, int W, int* own) {
  for (int w = warp_lane(); w < W; w += 32) {
    own[w] = tags[w];
    own[W + w] = age[w];
  }
  __syncwarp();
  row.bind(own, own + W, W);
}

template <class Row>
__global__ void prime_probe_kernel(const int* __restrict__ tags,
                                   const int* __restrict__ age,
                                   const int* __restrict__ streams,
                                   const int* __restrict__ targets,
                                   uint8_t* __restrict__ evicted, int B,
                                   int W, int T, int clock0) {
  extern __shared__ __align__(16) int smem[];  // MemRow: 2 W ints a warp
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.x * kWarps + warp;
  if (b >= B) return;  // the whole warp
  const int lane = warp_lane();
  Row row;
  fill(row, tags + (size_t)b * W, age + (size_t)b * W, W,
       smem + (size_t)warp * 2 * W);
  const int target = targets[b];
  lru_touch_warp(row, W, target, clock0, -1);
  if (!Row::kLaneOwned) __syncwarp();  // every lane reads the row next
  const int* s = streams + (size_t)b * T;
  int next = lane < T ? s[lane] : -1;
  for (int t0 = 0; t0 < T; t0 += 32) {
    const int chunk = next;
    if (t0 + 32 + lane < T) next = s[t0 + 32 + lane];
    const int n = min(32, T - t0);
    for (int j = 0; j < n; ++j) {
      lru_touch_warp(row, W, __shfl_sync(kFullWarp, chunk, j),
                     clock0 + 1 + t0 + j, -1);
      if (!Row::kLaneOwned) __syncwarp();
    }
  }
  unsigned resident = 0;
  for (int k = 0; k < Row::rounds(W); ++k)
    resident |= __ballot_sync(kFullWarp,
                              32 * k + lane < W && row.tag(k) == target);
  if (lane == 0) evicted[b] = (uint8_t)(resident == 0);
}

template <class Row>
int launch(const int* tags, const int* age, const int* streams,
           const int* targets, uint8_t* evicted, int B, int W, int T,
           int clock0, int shared_bytes, cudaStream_t stream) {
  auto kernel = prime_probe_kernel<Row>;
  if (shared_bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, shared_bytes);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<(B + kWarps - 1) / kWarps, 32 * kWarps, shared_bytes, stream>>>(
      tags, age, streams, targets, evicted, B, W, T, clock0);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int prime_probe_launch(const void* tags, const void* age,
                                  const void* streams, const void* targets,
                                  void* evicted, int B, int W, int T,
                                  int clock0, void* stream) {
  // rows of up to 32 ways sit in one register a lane; wider rows in shared
  // memory, 2 W ints a warp (the wrapper refuses W past what a block takes)
  if (W <= 32)
    return launch<RegRow<1, false>>((const int*)tags, (const int*)age,
                             (const int*)streams, (const int*)targets,
                             (uint8_t*)evicted, B, W, T, clock0, 0,
                             (cudaStream_t)stream);
  return launch<MemRow>((const int*)tags, (const int*)age,
                        (const int*)streams, (const int*)targets,
                        (uint8_t*)evicted, B, W, T, clock0,
                        kWarps * 2 * W * (int)sizeof(int),
                        (cudaStream_t)stream);
}

extern "C" const char* prime_probe_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
