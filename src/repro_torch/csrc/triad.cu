// triad: the STREAM triad out = a * scale + b, the monitor's bandwidth probe.
//
// Replaces the Pallas kernel `triad` (src/repro/kernels/cache_probe/
// kernel.py:32, `_triad_kernel` at :28).  That kernel tiles (N, 128) f32
// rows into blocks of min(512, N) and asserts N % block == 0, so the
// monitor's own 64 MiB probe (43,688 rows) fails there.  This one takes any
// element count: a grid-stride loop over float4s and a scalar tail.
//
// `scale` is a one-element device buffer read in the kernel (the Pallas
// kernel's SMEM scalar), so a launch needs no host synchronization.  The
// product and the sum are rounded separately (__fmul_rn, __fadd_rn), which
// nvcc may not contract into an FMA: the result equals PyTorch's eager
// `a * scale + b` bit for bit.
//
// What bounds it on an H100: bytes.  12 bytes per element (two reads, one
// write) and 2 flops, so 20.0 us for the monitor's 64 MiB (67.1 MB moved)
// at 3.35 TB/s, if the inputs come from HBM and not from the 50 MB L2.  The
// design is the plain streaming one: 16-byte loads and stores, consecutive
// threads on consecutive addresses, a grid of a few blocks per SM.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

__device__ __forceinline__ float triad1(float a, float s, float b) {
  return __fadd_rn(__fmul_rn(a, s), b);
}

__global__ void triad_kernel(const float* __restrict__ a,
                             const float* __restrict__ b,
                             const float* __restrict__ scale,
                             float* __restrict__ out, int64_t n, int vec) {
  const float s = scale[0];
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t i0 = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  int64_t done = 0;
  if (vec) {
    const int64_t n4 = n / 4;
    const float4* a4 = reinterpret_cast<const float4*>(a);
    const float4* b4 = reinterpret_cast<const float4*>(b);
    float4* o4 = reinterpret_cast<float4*>(out);
    for (int64_t i = i0; i < n4; i += stride) {
      const float4 x = a4[i];
      const float4 y = b4[i];
      float4 r;
      r.x = triad1(x.x, s, y.x);
      r.y = triad1(x.y, s, y.y);
      r.z = triad1(x.z, s, y.z);
      r.w = triad1(x.w, s, y.w);
      o4[i] = r;
    }
    done = n4 * 4;
  }
  for (int64_t i = done + i0; i < n; i += stride) out[i] = triad1(a[i], s, b[i]);
}

}  // namespace

extern "C" int triad_launch(const void* a, const void* b, const void* scale,
                            void* out, int64_t n, void* stream) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
  }
  // float4 access needs 16-byte alignment of all three arrays
  const int vec = ((reinterpret_cast<uintptr_t>(a) |
                    reinterpret_cast<uintptr_t>(b) |
                    reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  const int threads = 256;
  const int64_t work = vec ? (n / 4 > 0 ? n / 4 : n) : n;
  int64_t blocks = (work + threads - 1) / threads;
  const int64_t cap = (int64_t)sms * 8;
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  triad_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)a, (const float*)b, (const float*)scale, (float*)out, n,
      vec);
  return (int)cudaGetLastError();
}

// Holds the stream for about `cycles` SM clocks (one thread).
__global__ void spin_kernel(long long cycles) {
  const long long t0 = clock64();
  while (clock64() - t0 < cycles) {
  }
}

// The monitor's probe: `reps` triad launches between two CUDA events, with
// the device time per launch in *ms_out.  A short spin is enqueued first,
// so the device reaches the start event only after this function has
// enqueued the event, the launches and the end event: no host time falls
// between the events.  (With the device idle, events around a launch made
// from Python also time the host's enqueue, which is of the order of the
// 20 us triad.)  *hidden_out is 1 if the start event was still pending
// once all was enqueued, else 0 and the reading includes host time: the
// caller then repeats with a longer spin.  Blocks until the end event.
extern "C" int triad_timed_launch(const void* a, const void* b,
                                  const void* scale, void* out, int64_t n,
                                  int reps, float spin_us, void* stream,
                                  void* ms_out, void* hidden_out) {
  cudaFuncAttributes attr;  // load both kernels before any event (lazy
  cudaError_t e = cudaFuncGetAttributes(&attr, spin_kernel);  // loading)
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, triad_kernel);
  int dev = 0, khz = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&khz, cudaDevAttrClockRate, dev);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = (cudaStream_t)stream;
  cudaEvent_t start, end;
  if ((e = cudaEventCreate(&start)) != cudaSuccess) return (int)e;
  if ((e = cudaEventCreate(&end)) != cudaSuccess) {
    cudaEventDestroy(start);
    return (int)e;
  }
  spin_kernel<<<1, 1, 0, s>>>((long long)(spin_us * 1e-3f * (float)khz));
  cudaEventRecord(start, s);
  for (int r = 0; r < reps && e == cudaSuccess; ++r)
    e = (cudaError_t)triad_launch(a, b, scale, out, n, stream);
  cudaEventRecord(end, s);
  *(int*)hidden_out = cudaEventQuery(start) == cudaErrorNotReady;
  if (e == cudaSuccess) e = cudaEventSynchronize(end);
  if (e == cudaSuccess) e = cudaEventElapsedTime((float*)ms_out, start, end);
  cudaEventDestroy(start);
  cudaEventDestroy(end);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

extern "C" const char* triad_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
