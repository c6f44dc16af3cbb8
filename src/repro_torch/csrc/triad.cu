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
//
// The staged form (`triad_staged_launch`) is the Pallas kernel's `block`
// argument: a tile of `block_rows` rows of 128 floats that `a` passes
// through.  On the TPU that tile lives in VMEM and Mosaic refuses one over
// the runtime's budget at compile time, which is what
// `repro/tpuprobe/vmem_probe.py` searches for.  Here the tile is dynamic
// shared memory of exactly block_rows x 512 bytes, and the card refuses a
// tile over its opt-in limit (cudaDevAttrMaxSharedMemoryPerBlockOptin,
// 227 KiB on an H100: the SM's 228 KiB less the 1 KiB CUDA keeps for each
// block) with cudaErrorInvalidValue, at cudaFuncSetAttribute or at the
// launch.  The entry point returns that code after clearing it (it is not
// sticky), so the next launch on the context works; the port's
// `tpuprobe/vmem_probe.py` searches for the largest tile the card takes.
// Tile t holds rows [t * block_rows, min((t + 1) * block_rows, rows)):
// every tile is whole but the last, which holds rows % block_rows rows
// (when that is not 0) in the first (rows % block_rows) x 512 bytes of the
// tile; any row count is taken.  Bound: the same 12 bytes an element as
// the streaming form; its design trades speed for the tile (one block an
// SM at 227 KiB, each loading its tile before it computes), since the
// probe's point is the tile, not the rate.
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

// The card's SM count, read once.
static cudaError_t sm_count(int* out) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
  }
  *out = sms;
  return cudaSuccess;
}

extern "C" int triad_launch(const void* a, const void* b, const void* scale,
                            void* out, int64_t n, void* stream) {
  int sms = 0;
  const cudaError_t e = sm_count(&sms);
  if (e != cudaSuccess) return (int)e;
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

__global__ void triad_staged_kernel(const float* __restrict__ a,
                                    const float* __restrict__ b,
                                    const float* __restrict__ scale,
                                    float* __restrict__ out, int64_t rows,
                                    int block_rows, int vec) {
  extern __shared__ float4 tile4[];  // block_rows x 128 floats
  float* tile = reinterpret_cast<float*>(tile4);
  const float s = scale[0];
  const int64_t n_tiles = (rows + block_rows - 1) / block_rows;
  for (int64_t t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const int64_t r0 = t * block_rows;
    const int r = (int)(rows - r0 < block_rows ? rows - r0 : block_rows);
    const int64_t base = r0 * 128;
    if (vec) {
      const int n4 = r * 32;
      const float4* a4 = reinterpret_cast<const float4*>(a + base);
      const float4* b4 = reinterpret_cast<const float4*>(b + base);
      float4* o4 = reinterpret_cast<float4*>(out + base);
      for (int i = threadIdx.x; i < n4; i += blockDim.x) tile4[i] = a4[i];
      __syncthreads();
      for (int i = threadIdx.x; i < n4; i += blockDim.x) {
        const float4 x = tile4[i];
        const float4 y = b4[i];
        float4 o;
        o.x = triad1(x.x, s, y.x);
        o.y = triad1(x.y, s, y.y);
        o.z = triad1(x.z, s, y.z);
        o.w = triad1(x.w, s, y.w);
        o4[i] = o;
      }
    } else {
      const int n = r * 128;
      for (int i = threadIdx.x; i < n; i += blockDim.x) tile[i] = a[base + i];
      __syncthreads();
      for (int i = threadIdx.x; i < n; i += blockDim.x)
        out[base + i] = triad1(tile[i], s, b[base + i]);
    }
    __syncthreads();  // the tile is refilled for the next one
  }
}

// The staged triad over (rows, 128) f32 with a tile of block_rows rows of
// dynamic shared memory.  Returns the CUDA error code; cudaErrorInvalidValue
// when the card refuses the tile.
extern "C" int triad_staged_launch(const void* a, const void* b,
                                   const void* scale, void* out,
                                   int64_t rows, int block_rows,
                                   void* stream) {
  int sms = 0;
  cudaError_t e = sm_count(&sms);
  if (e != cudaSuccess) return (int)e;
  const int threads = 256;
  const size_t smem = (size_t)block_rows * 128 * sizeof(float);
  if (smem > 48 * 1024)
    e = cudaFuncSetAttribute(triad_staged_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  int per_sm = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, triad_staged_kernel, threads, smem);
  if (e != cudaSuccess) {
    cudaGetLastError();  // clear it: a refused tile is not sticky
    return (int)e;
  }
  if (per_sm < 1) per_sm = 1;  // a tile over the limit: the launch refuses
  const int vec = ((reinterpret_cast<uintptr_t>(a) |
                    reinterpret_cast<uintptr_t>(b) |
                    reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  const int64_t tiles = (rows + block_rows - 1) / block_rows;
  int64_t blocks = (int64_t)sms * per_sm;
  if (blocks > tiles) blocks = tiles;
  if (blocks < 1) blocks = 1;
  triad_staged_kernel<<<(unsigned)blocks, threads, smem,
                        (cudaStream_t)stream>>>(
      (const float*)a, (const float*)b, (const float*)scale, (float*)out,
      rows, block_rows, vec);
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
