// ssd_scan: the Mamba2 SSD chunked scan (state-space duality), in f32.
//
// Replaces the Pallas kernel `ssd_scan_grid`
// (src/repro/kernels/ssd_scan/kernel.py:87, body `_ssd_kernel` at :33).
// Inputs, all f32 and contiguous:
//   x  (B, H, nc, L, P)   dt (B, H, nc, L) post-softplus step sizes
//   dA (B, H, nc, L) = dt * A, the negative log-decay increments
//   Bm, Cm (B, nc, L, N), shared by all heads
// Outputs: y (B, H, nc, L, P) and the final state (B, H, P, N).
// Per chunk, with seg = cumsum(dA) over the chunk (one thread, in order):
//   y[l]   = sum_{m<=l} (C_l . B_m) exp(seg_l - seg_m) dt_m x[m]
//          + exp(seg_l) (state C_l)
//   state' = state exp(seg_{L-1}) + sum_l exp(seg_{L-1} - seg_l) dt_l x_l B_l^T
// The decay is taken only for m <= l, where seg_l - seg_m <= 0: the upper
// triangle, whose exponents are positive, is never exponentiated (the
// "mask before the exp" of kernel.py:51-55).
//
// What bounds it on an H100: operations.  At zamba2-2.7b's prefill shape
// (B = 2, 80 heads, 16 chunks of 128, P = 64, N = 64) the four products
// need about 8 GFLOP (0.12 ms at the 67 TFLOP/s of f32 FMAs) against
// 0.17 GB of x and y (0.05 ms at 3.35 TB/s).
//
// The simple design: one block of 256 threads per (batch, head), the
// Pallas grid's sequential chunk axis a loop inside the block, and the
// head's P x N state in shared memory for the whole scan (16 KB at N = 64,
// 32 KB at N = 128), beside the chunk's x, B and C.  For y two threads own
// a row l (each P/2 columns, and half of each C_l . B_m dot product, summed
// by a shuffle); for the state update four threads own a row p (each N/4
// columns).  C . B^T is recomputed per head, and the rows of a causal
// chunk do unequal work (row l has l + 1 terms).  Scalar f32 FMAs, no
// tensor cores.  Later work: C . B^T once per (batch, chunk), balanced
// rows, `wgmma` for the three chunk products.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxL = 128;   // two threads per chunk row
constexpr int kMaxP = 64;    // P / 2 <= 32 y columns per thread
constexpr int kMaxN = 128;   // N / 4 <= 32 state columns per thread

__global__ void __launch_bounds__(kThreads)
    ssd_kernel(const float* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ dA, const float* __restrict__ Bm,
               const float* __restrict__ Cm, float* __restrict__ y,
               float* __restrict__ st_out, int H, int nc, int L, int P,
               int N) {
  extern __shared__ float sm[];
  const int sp = N + 1;   // padded row stride of the state
  const int cp = N + 2;   // padded row stride of C (two threads per row)
  float* state = sm;                 // P x sp
  float* xs = state + P * sp;        // L x P
  float* Bs = xs + L * P;            // L x N
  float* Cs = Bs + L * N;            // L x cp
  float* seg = Cs + L * cp;          // L: cumulative log decay
  float* dts = seg + L;              // L
  float* w = dts + L;                // L: exp(seg_{L-1} - seg_l) * dt_l
  float* ein = w + L;                // L: exp(seg_l)

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int tid = threadIdx.x;
  for (int i = tid; i < P * sp; i += kThreads) state[i] = 0.f;

  // y rows: two threads per row l, columns p = half + 2j
  const int yl = tid >> 1, half = tid & 1;
  const unsigned pair = 3u << ((tid & 31) & ~1);
  // state rows: four threads per row p, columns n = q4 + 4j
  const int sprow = tid >> 2, q4 = tid & 3;

  for (int c = 0; c < nc; ++c) {
    const size_t xo = ((size_t)bh * nc + c) * L * P;
    const size_t to = ((size_t)bh * nc + c) * L;
    const size_t bo = ((size_t)b * nc + c) * L * N;
    __syncthreads();  // the previous chunk is done with the buffers
    for (int i = tid; i < L * P; i += kThreads) xs[i] = x[xo + i];
    for (int i = tid; i < L * N; i += kThreads) {
      const int row = i / N, n = i - row * N;
      Bs[i] = Bm[bo + i];
      Cs[row * cp + n] = Cm[bo + i];
    }
    for (int i = tid; i < L; i += kThreads) {
      dts[i] = dt[to + i];
      seg[i] = dA[to + i];
    }
    __syncthreads();
    if (tid == 0) {
      float run = 0.f;
      for (int i = 0; i < L; ++i) {
        run += seg[i];
        seg[i] = run;
      }
    }
    __syncthreads();
    for (int i = tid; i < L; i += kThreads) {
      ein[i] = expf(seg[i]);
      w[i] = expf(seg[L - 1] - seg[i]) * dts[i];
    }
    __syncthreads();

    if (yl < L) {
      const float* crow = Cs + yl * cp;
      const float sl = seg[yl];
      float acc[kMaxP / 2];
#pragma unroll
      for (int j = 0; j < kMaxP / 2; ++j) acc[j] = 0.f;
      for (int mm = 0; mm <= yl; ++mm) {
        const float* brow = Bs + mm * N;
        float cb = 0.f;
        for (int n = half; n < N; n += 2) cb = fmaf(crow[n], brow[n], cb);
        cb += __shfl_xor_sync(pair, cb, 1);
        const float a = cb * expf(sl - seg[mm]) * dts[mm];
        const float* xr = xs + mm * P;
#pragma unroll
        for (int j = 0; j < kMaxP / 2; ++j) {
          const int p = half + 2 * j;
          if (p < P) acc[j] = fmaf(a, xr[p], acc[j]);
        }
      }
      const float e = ein[yl];
      float* yr = y + xo + (size_t)yl * P;
#pragma unroll
      for (int j = 0; j < kMaxP / 2; ++j) {
        const int p = half + 2 * j;
        if (p < P) {
          const float* srow = state + p * sp;
          float cs = 0.f;
          for (int n = 0; n < N; ++n) cs = fmaf(srow[n], crow[n], cs);
          yr[p] = acc[j] + e * cs;
        }
      }
    }
    __syncthreads();  // every y row has read the state before this chunk

    if (sprow < P) {
      float acc[kMaxN / 4];
#pragma unroll
      for (int j = 0; j < kMaxN / 4; ++j) acc[j] = 0.f;
      for (int l = 0; l < L; ++l) {
        const float xw = w[l] * xs[l * P + sprow];
        const float* brow = Bs + l * N;
#pragma unroll
        for (int j = 0; j < kMaxN / 4; ++j) {
          const int n = q4 + 4 * j;
          if (n < N) acc[j] = fmaf(xw, brow[n], acc[j]);
        }
      }
      const float total = ein[L - 1];
      float* srow = state + sprow * sp;
#pragma unroll
      for (int j = 0; j < kMaxN / 4; ++j) {
        const int n = q4 + 4 * j;
        if (n < N) srow[n] = srow[n] * total + acc[j];
      }
    }
  }
  __syncthreads();
  float* so = st_out + (size_t)bh * P * N;
  for (int i = tid; i < P * N; i += kThreads) {
    const int p = i / N, n = i - p * N;
    so[i] = state[p * sp + n];
  }
}

}  // namespace

extern "C" int ssd_scan_launch(const void* x, const void* dt, const void* dA,
                               const void* Bm, const void* Cm, void* y,
                               void* st, int B, int H, int nc, int L, int P,
                               int N, void* stream) {
  if (L < 1 || L > kMaxL || P < 1 || P > kMaxP || N < 1 || N > kMaxN)
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      sizeof(float) * ((size_t)P * (N + 1) + (size_t)L * P + (size_t)L * N +
                       (size_t)L * (N + 2) + 4 * (size_t)L);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  ssd_kernel<<<B * H, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)dt, (const float*)dA, (const float*)Bm,
      (const float*)Cm, (float*)y, (float*)st, H, nc, L, P, N);
  return (int)cudaGetLastError();
}

extern "C" const char* ssd_scan_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
