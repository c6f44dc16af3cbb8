// ssd_scan: the Mamba2 SSD chunked scan (state-space duality), in f32.
//
// Replaces the Pallas kernel `ssd_scan_grid`
// (src/repro/kernels/ssd_scan/kernel.py:87, body `_ssd_kernel` at :33).
// Inputs, all f32 and contiguous:
//   x  (B, H, nc, L, P)   dt (B, H, nc, L) post-softplus step sizes
//   dA (B, H, nc, L) = dt * A, the negative log-decay increments
//   Bm, Cm (B, nc, L, N), shared by all heads
// Outputs: y (B, H, nc, L, P) and the final state (B, H, P, N).
// Per chunk, with seg = cumsum(dA) over the chunk:
//   y[l]   = sum_{m<=l} (C_l . B_m) exp(seg_l - seg_m) dt_m x[m]
//          + exp(seg_l) (S_in C_l)
//   S_out  = S_in exp(seg_{L-1}) + sum_l exp(seg_{L-1} - seg_l) dt_l x_l B_l^T
// The decay is taken only for m <= l, where seg_l - seg_m <= 0: the upper
// triangle, whose exponents are positive, is never exponentiated (the
// "mask before the exp" of kernel.py:51-55).
//
// What bounds it on an H100: operations.  At zamba2-2.7b's prefill shape
// (B = 2, 80 heads, 16 chunks of 128, P = 64, N = 64) the products need
// about 8 GFLOP (0.12 ms at the 67 TFLOP/s of f32 FMAs; no TF32, the
// tolerance is 2e-5) against 0.17 GB of x and y (0.05 ms at 3.35 TB/s).
// The Pallas grid carries the state through the chunks in order, which on
// a GPU leaves one block per (batch, head) doing all of a head's work in
// sequence: 160 blocks for 132 SMs.
//
// The design: Mamba2's own chunk-parallel decomposition, four launches on
// the caller's stream.  Only stage 3 runs along the chunks, and it is one
// multiply-add per state element and chunk.
//   1. ssd_cb, per (batch, chunk, 64 x 64 tile on or below the diagonal):
//      CB = C.B^T, once for all heads, into a workspace (B, nc, L, L).
//   2. ssd_states, per (batch, head, chunk): seg = cumsum(dA) in order into
//      a workspace (B, H, nc, L), then the chunk's
//      state contribution sum_l exp(seg_{L-1} - seg_l) dt_l x_l B_l^T
//      (P x N) into a workspace (B, H, nc, P, N).
//   3. ssd_carry, per state element: S_c = S_{c-1} exp(seg_{L-1,c}) +
//      contribution_c, writing the state that enters each chunk over its
//      contribution, and the final state.
//   4. ssd_out, per (batch, head, chunk): y = (CB o decay o dt).x +
//      exp(seg) o (C.S_in^T).  Thread (rg, cg) of 32 x 8 owns rows rg +
//      32i (i < 4) and columns 4cg + 32j of y, so every thread has rows
//      spread over the chunk: keys are walked in blocks of 32, and row
//      block i takes part only from key block i on, which skips the upper
//      triangle with no divergence and the same work for every thread.
// The three chunk products are register tiles of f32 FMAs (float4 reads of
// shared memory).  Stage 4 reuses the shared memory of its first product
// for the second, so two blocks fit on an SM.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxL = 128;
constexpr int kMaxP = 64;
constexpr int kMaxN = 128;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 4 or 16 bytes from global to shared memory; ok = false writes zeros
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// Start copying rows [0, rows) x columns [0, cols) of a row-major block
// (row stride `stride`) into shared memory (row stride ds), zeros at or
// past row `vr` or column `vc`.  All copies are in flight at once; the
// caller waits for them.  `vec`: 16-byte copies (cols, stride and vc
// multiples of 4, src 16-byte aligned).
__device__ __forceinline__ void copy_block(float* dst, int ds,
                                           const float* src, size_t stride,
                                           int rows, int cols, int vr, int vc,
                                           bool vec) {
  if (vec) {
    const int c4 = cols / 4;
    for (int i = threadIdx.x; i < rows * c4; i += kThreads) {
      const int r = i / c4, c = (i - r * c4) * 4;
      const bool ok = r < vr && c < vc;
      cp_async16(dst + r * ds + c, ok ? src + r * stride + c : src, ok);
    }
  } else {
    for (int i = threadIdx.x; i < rows * cols; i += kThreads) {
      const int r = i / cols, c = i - r * cols;
      const bool ok = r < vr && c < vc;
      cp_async4(dst + r * ds + c, ok ? src + r * stride + c : src, ok);
    }
  }
}

// -- 1. CB = C . B^T per (batch, chunk) ---------------------------------------

constexpr int kT = 64;       // tile edge
constexpr int kTS = kT + 4;  // row stride of the transposed tiles

__global__ void __launch_bounds__(kThreads)
    ssd_cb(const float* __restrict__ Bm, const float* __restrict__ Cm,
           float* __restrict__ cb, int L, int N) {
  extern __shared__ __align__(16) float sm1[];
  float* Ct = sm1;             // N x kTS: C rows of the tile, transposed
  float* Bt = Ct + N * kTS;    // N x kTS: B rows of the tile, transposed
  // tile t -> (ti, tj), tj <= ti: 0 -> (0,0), 1 -> (1,0), 2 -> (1,1)
  const int t = blockIdx.x;
  const int ti = t == 0 ? 0 : 1, tj = t == 2 ? 1 : 0;
  const size_t bc = blockIdx.y;
  const float* cp = Cm + (bc * L + ti * kT) * N;
  const float* bp = Bm + (bc * L + tj * kT) * N;
  const int lrows = min(kT, L - ti * kT), mrows = min(kT, L - tj * kT);
  const int tid = threadIdx.x;
  for (int i = tid; i < kT * N; i += kThreads) {
    const int r = i / N, n = i - r * N;
    cp_async4(Ct + n * kTS + r, cp + (size_t)r * N + n, r < lrows);
    cp_async4(Bt + n * kTS + r, bp + (size_t)r * N + n, r < mrows);
  }
  cp_async_wait_all();
  __syncthreads();
  // C_l . B_m by one FMA chain over n from 0, as the plain version's matmul
  const int rg = tid >> 4, cg = tid & 15;
  float acc[4][4] = {};
  for (int n = 0; n < N; ++n) {
    const float4 c4 = *reinterpret_cast<const float4*>(Ct + n * kTS + rg * 4);
    const float4 b4 = *reinterpret_cast<const float4*>(Bt + n * kTS + cg * 4);
    const float cv[4] = {c4.x, c4.y, c4.z, c4.w};
    const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(cv[i], bv[j], acc[i][j]);
  }
  float* out = cb + bc * L * L;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int l = ti * kT + rg * 4 + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int mm = tj * kT + cg * 4 + j;
      if (l < L && mm < L) out[(size_t)l * L + mm] = acc[i][j];
    }
  }
}

// -- 2. seg and the chunk's state contribution per (batch, head, chunk) -------

__global__ void __launch_bounds__(kThreads)
    ssd_states(const float* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ dA, const float* __restrict__ Bm,
               float* __restrict__ seg_ws, float* __restrict__ st_ws, int H,
               int nc, int L, int P, int N) {
  constexpr int XS = kMaxP;            // row stride of x (zero past P)
  const int BS = N > 64 ? kMaxN : 64;  // row stride of B (zero past N)
  extern __shared__ __align__(16) float sm2[];
  float* Xs = sm2;           // L x XS: w_l x_l
  float* Bs = Xs + L * XS;   // L x BS
  float* seg = Bs + L * BS;  // L
  float* w = seg + kMaxL;    // L

  const size_t blk = blockIdx.x;  // (b * H + h) * nc + c
  const int c = (int)(blk % nc);
  const size_t b = blk / nc / H;
  const int tid = threadIdx.x;
  const float* xp = x + blk * L * P;
  const float* bp = Bm + (b * nc + c) * L * N;

  copy_block(Xs, XS, xp, P, L, XS, L, P, (P & 3) == 0);
  copy_block(Bs, BS, bp, N, L, BS, L, N, (N & 3) == 0);
  if (tid < 32) {
    // seg = cumsum(dA) one add at a time from 0, while the copies above are
    // in flight: the order of the plain versions' cumsum along the chunk
    // (PyTorch scans a non-innermost dim in order; a parallel scan rounds
    // elsewhere, and at |seg| ~ 100 one ulp is 8e-6)
    for (int i = tid; i < L; i += 32) seg[i] = dA[blk * L + i];
    __syncwarp();
    if (tid == 0) {
      float run = 0.f;
      for (int i = 0; i < L; ++i) {
        run += seg[i];
        seg[i] = run;
      }
    }
    __syncwarp();
    for (int i = tid; i < L; i += 32) seg_ws[blk * L + i] = seg[i];
  }
  __syncthreads();
  for (int i = tid; i < L; i += kThreads)
    w[i] = expf(seg[L - 1] - seg[i]) * dt[blk * L + i];
  cp_async_wait_all();
  __syncthreads();
  for (int i = tid; i < L * XS; i += kThreads) Xs[i] *= w[i / XS];
  __syncthreads();

  // contribution[p][n] = sum_l (w_l x_l[p]) B_l[n], one FMA chain over l
  // from 0: thread (pg, ng) of 16 x 16 owns p = 4pg + i, n = 4ng + 64j + e
  const int pg = tid >> 4, ng = tid & 15;
  const int nj = N > 64 ? 2 : 1;
  float acc[4][2][4] = {};
  for (int l = 0; l < L; ++l) {
    const float4 xv = *reinterpret_cast<const float4*>(Xs + l * XS + pg * 4);
    const float xa[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      if (j < nj) {
        const float4 bv =
            *reinterpret_cast<const float4*>(Bs + l * BS + ng * 4 + 64 * j);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][j][0] = fmaf(xa[i], bv.x, acc[i][j][0]);
          acc[i][j][1] = fmaf(xa[i], bv.y, acc[i][j][1]);
          acc[i][j][2] = fmaf(xa[i], bv.z, acc[i][j][2]);
          acc[i][j][3] = fmaf(xa[i], bv.w, acc[i][j][3]);
        }
      }
    }
  }
  float* out = st_ws + blk * P * N;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int p = pg * 4 + i;
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int n = ng * 4 + 64 * j + e;
        if (p < P && n < N) out[(size_t)p * N + n] = acc[i][j][e];
      }
  }
}

// -- 3. carry the state across the chunks, per (batch, head, p, n) ------------

constexpr int kCarryBatch = 8;  // chunks whose loads are in flight together

__global__ void __launch_bounds__(kThreads)
    ssd_carry(const float* __restrict__ seg_ws, float* __restrict__ st_ws,
              float* __restrict__ st_out, int BH, int nc, int L, int PN) {
  const size_t idx = (size_t)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= (size_t)BH * PN) return;
  const size_t bh = idx / PN, e = idx - bh * PN;
  float* base = st_ws + bh * nc * PN + e;
  const float* segl = seg_ws + bh * nc * L + L - 1;
  float S = 0.f;
  for (int c0 = 0; c0 < nc; c0 += kCarryBatch) {
    float contrib[kCarryBatch], total[kCarryBatch];
#pragma unroll
    for (int u = 0; u < kCarryBatch; ++u) {
      const int c = c0 + u;
      contrib[u] = c < nc ? base[(size_t)c * PN] : 0.f;
      total[u] = c < nc ? segl[(size_t)c * L] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kCarryBatch; ++u) {
      const int c = c0 + u;
      if (c < nc) {
        base[(size_t)c * PN] = S;  // the state entering chunk c
        // two roundings, as the plain version's S * total + contribution
        S = __fadd_rn(__fmul_rn(S, expf(total[u])), contrib[u]);
      }
    }
  }
  st_out[idx] = S;
}

// -- 4. y per (batch, head, chunk) --------------------------------------------

__global__ void __launch_bounds__(kThreads)
    ssd_out(const float* __restrict__ x, const float* __restrict__ dt,
            const float* __restrict__ Cm, const float* __restrict__ cb,
            const float* __restrict__ seg_ws, const float* __restrict__ st_ws,
            float* __restrict__ y, int H, int nc, int L, int P, int N) {
  constexpr int XS = kMaxP;      // row stride of x
  constexpr int TS = kMaxP + 4;  // row stride of S_in^T (transposed stores
                                 // of a warp fall in 8 banks, not 1)
  constexpr int AS = kMaxL + 4;  // row stride of the decayed CB
  const int N4 = (N + 3) & ~3;
  const int CS = N4 + 4;         // row stride of C
  const int L4 = (L + 3) & ~3;
  extern __shared__ __align__(16) float sm4[];
  float* seg = sm4;            // kMaxL
  float* dts = seg + kMaxL;    // kMaxL
  float* buf = dts + kMaxL;
  // phase A: C (kMaxL rows x CS) and S_in^T (N4 x TS)
  float* Cs = buf;
  float* St = Cs + kMaxL * CS;
  // phase B, over the same memory: A = CB o decay o dt (kMaxL x AS), x
  float* As = buf;
  float* Xs = As + kMaxL * AS;  // L4 x XS

  const size_t blk = blockIdx.x;  // (b * H + h) * nc + c
  const int c = (int)(blk % nc);
  const size_t b = blk / nc / H;
  const int tid = threadIdx.x;
  const int rg = tid >> 3, cg = tid & 7;
  const float* cp = Cm + (b * nc + c) * L * N;
  const float* sp = st_ws + blk * P * N;

  copy_block(seg, 0, seg_ws + blk * L, 0, 1, L, 1, L, false);
  copy_block(dts, 0, dt + blk * L, 0, 1, L, 1, L, false);
  copy_block(Cs, CS, cp, N, kMaxL, N4, L, N, (N & 3) == 0);
  for (int i = tid; i < N4 * kMaxP; i += kThreads) {
    const int p = i / N4, n = i - p * N4;  // reads S_in row by row
    cp_async4(St + n * TS + p, sp + (size_t)p * N + n, p < P && n < N);
  }
  cp_async_wait_all();
  __syncthreads();

  // inter-chunk term C_l . S_in[p], one FMA chain over n from 0
  float inter[4][2][4] = {};
  for (int n = 0; n < N4; n += 4) {
    float4 cv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      cv[i] = *reinterpret_cast<const float4*>(Cs + (rg + 32 * i) * CS + n);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float4 sv = *reinterpret_cast<const float4*>(
            St + (n + u) * TS + cg * 4 + 32 * j);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float a = u == 0 ? cv[i].x
                        : u == 1 ? cv[i].y
                        : u == 2 ? cv[i].z
                                 : cv[i].w;
          inter[i][j][0] = fmaf(a, sv.x, inter[i][j][0]);
          inter[i][j][1] = fmaf(a, sv.y, inter[i][j][1]);
          inter[i][j][2] = fmaf(a, sv.z, inter[i][j][2]);
          inter[i][j][3] = fmaf(a, sv.w, inter[i][j][3]);
        }
      }
    }
  }
  __syncthreads();  // phase A's memory becomes phase B's

  copy_block(As, AS, cb + (b * nc + c) * L * L, L, kMaxL, L4, L, L,
             (L & 3) == 0);
  copy_block(Xs, XS, x + blk * L * P, P, L4, XS, L, P, (P & 3) == 0);
  cp_async_wait_all();
  __syncthreads();
  // A[l][m] = CB[l][m] exp(seg_l - seg_m) dt_m for m <= l, else 0
  for (int i = tid; i < kMaxL * kMaxL; i += kThreads) {
    const int l = i >> 7, m = i & (kMaxL - 1);
    if (m < L4) {
      float* a = As + l * AS + m;
      *a = (l < L && m <= l) ? *a * expf(seg[l] - seg[m]) * dts[m] : 0.f;
    }
  }
  __syncthreads();

  // intra-chunk term, one FMA chain over m from 0: row block i (rows
  // rg + 32i) meets key block kb only for kb <= i (A is zero above)
  float acc[4][2][4] = {};
#pragma unroll
  for (int kb = 0; kb < 4; ++kb) {
    const int mend = min(32 * kb + 32, L4);
    for (int m = 32 * kb; m < mend; m += 4) {
      float4 av[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (i >= kb)
          av[i] = *reinterpret_cast<const float4*>(As + (rg + 32 * i) * AS + m);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float4 xv = *reinterpret_cast<const float4*>(
              Xs + (m + u) * XS + cg * 4 + 32 * j);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            if (i >= kb) {
              const float a = u == 0 ? av[i].x
                            : u == 1 ? av[i].y
                            : u == 2 ? av[i].z
                                     : av[i].w;
              acc[i][j][0] = fmaf(a, xv.x, acc[i][j][0]);
              acc[i][j][1] = fmaf(a, xv.y, acc[i][j][1]);
              acc[i][j][2] = fmaf(a, xv.z, acc[i][j][2]);
              acc[i][j][3] = fmaf(a, xv.w, acc[i][j][3]);
            }
          }
        }
      }
    }
  }

  // y = y_intra + (C.S_in) exp(seg): two roundings, as the plain version
  float* yp = y + blk * L * P;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int l = rg + 32 * i;
    if (l >= L) continue;
    const float e = expf(seg[l]);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        v[u] = __fadd_rn(acc[i][j][u], __fmul_rn(inter[i][j][u], e));
      const int p0 = cg * 4 + 32 * j;
      if ((P & 3) == 0 && p0 < P) {
        *reinterpret_cast<float4*>(yp + (size_t)l * P + p0) =
            make_float4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (p0 + u < P) yp[(size_t)l * P + p0 + u] = v[u];
      }
    }
  }
}

}  // namespace

// Workspaces, allocated by the caller: cb (B, nc, L, L), seg (B, H, nc, L),
// states (B, H, nc, P, N).  Four launches on `stream`.
extern "C" int ssd_scan_launch(const void* x, const void* dt, const void* dA,
                               const void* Bm, const void* Cm, void* y,
                               void* st, void* cb_ws, void* seg_ws,
                               void* st_ws, int B, int H, int nc, int L,
                               int P, int N, void* stream) {
  if (L < 1 || L > kMaxL || P < 1 || P > kMaxP || N < 1 || N > kMaxN ||
      B < 1 || H < 1 || nc < 1 || B * nc > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const size_t sm1 = sizeof(float) * 2 * (size_t)N * kTS;
  const int BS = N > 64 ? kMaxN : 64;
  const size_t sm2 =
      sizeof(float) * ((size_t)L * (kMaxP + BS) + 2 * kMaxL);
  const int N4 = (N + 3) & ~3, L4 = (L + 3) & ~3;
  const size_t phase_a = (size_t)kMaxL * (N4 + 4) + (size_t)N4 * (kMaxP + 4);
  const size_t phase_b = (size_t)kMaxL * (kMaxL + 4) + (size_t)L4 * kMaxP;
  const size_t sm4 = sizeof(float) *
                     (2 * kMaxL + (phase_a > phase_b ? phase_a : phase_b));
  cudaError_t err;
  if ((err = cudaFuncSetAttribute(ssd_cb,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)sm1)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(ssd_states,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)sm2)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(ssd_out,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)sm4)) != cudaSuccess)
    return (int)err;
  const int nb = (L + kT - 1) / kT;
  ssd_cb<<<dim3(nb * (nb + 1) / 2, B * nc), kThreads, sm1, s>>>(
      (const float*)Bm, (const float*)Cm, (float*)cb_ws, L, N);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)B * H * nc;
  ssd_states<<<blocks, kThreads, sm2, s>>>(
      (const float*)x, (const float*)dt, (const float*)dA, (const float*)Bm,
      (float*)seg_ws, (float*)st_ws, H, nc, L, P, N);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const size_t elems = (size_t)B * H * P * N;
  ssd_carry<<<(unsigned)((elems + kThreads - 1) / kThreads), kThreads, 0,
              s>>>((const float*)seg_ws, (float*)st_ws, (float*)st, B * H,
                   nc, L, P * N);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ssd_out<<<blocks, kThreads, sm4, s>>>(
      (const float*)x, (const float*)dt, (const float*)Cm,
      (const float*)cb_ws, (const float*)seg_ws, (const float*)st_ws,
      (float*)y, H, nc, L, P, N);
  return (int)cudaGetLastError();
}

extern "C" const char* ssd_scan_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
