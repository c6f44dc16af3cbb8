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
//
// Any chunk L, head dim P and state width N, as the Pallas grid takes them:
// the register tiles are fixed (kPT = 64 columns of P, kNT = 128 of N, kL =
// 128 rows of the chunk), and the stages walk the rest in tiles, each sum
// still one chain in the order of its index.  ssd_cb sums over N in passes
// of kNT and covers the chunk's lower triangle of 64 x 64 tiles; ssd_states
// walks (P tile, N tile) and the chunk in blocks of kL rows, seg carried
// through seg_ws; ssd_out runs one block per (kL rows, P tile) of a chunk,
// summing C.S_in^T over N in passes of kNT and the decayed CB.x over the
// key blocks up to its diagonal one, so no L x L tile is ever held.  Every
// grid is one dimension (blocks of (batch, chunk) or (batch, head, chunk)
// with their tiles fastest), so no B nc meets gridDim.y's 65,535.  Shapes
// within one tile (L <= 128, P <= 64, N <= 128) take one pass of each loop,
// the work of the untiled kernels.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kL = 128;   // rows of the chunk a tile of ssd_states, ssd_out
constexpr int kPT = 64;   // columns of P a tile
constexpr int kNT = 128;  // columns of N a tile, or a pass of a sum over N

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
           float* __restrict__ cb, int L, int N, int ntri) {
  extern __shared__ __align__(16) float sm1[];
  const int NW = min(N, kNT);  // columns of N a pass
  float* Ct = sm1;             // NW x kTS: C rows of the tile, transposed
  float* Bt = Ct + NW * kTS;   // NW x kTS: B rows of the tile, transposed
  // tile t -> (ti, tj), tj <= ti, row by row: 0 -> (0,0), 1 -> (1,0),
  // 2 -> (1,1), 3 -> (2,0), ...
  const int t = (int)(blockIdx.x % ntri);
  const size_t bc = blockIdx.x / ntri;
  int ti = 0;
  while ((ti + 1) * (ti + 2) / 2 <= t) ++ti;
  const int tj = t - ti * (ti + 1) / 2;
  const float* cp = Cm + (bc * L + ti * kT) * N;
  const float* bp = Bm + (bc * L + tj * kT) * N;
  const int lrows = min(kT, L - ti * kT), mrows = min(kT, L - tj * kT);
  const int tid = threadIdx.x;
  // C_l . B_m by one FMA chain over n from 0, as the plain version's matmul
  const int rg = tid >> 4, cg = tid & 15;
  float acc[4][4] = {};
  for (int n0 = 0; n0 < N; n0 += NW) {
    const int nw = min(NW, N - n0);
    if (n0 > 0) __syncthreads();  // the last pass is done with the tiles
    for (int i = tid; i < kT * nw; i += kThreads) {
      const int r = i / nw, n = i - r * nw;
      cp_async4(Ct + n * kTS + r, cp + (size_t)r * N + n0 + n, r < lrows);
      cp_async4(Bt + n * kTS + r, bp + (size_t)r * N + n0 + n, r < mrows);
    }
    cp_async_wait_all();
    __syncthreads();
    for (int n = 0; n < nw; ++n) {
      const float4 c4 =
          *reinterpret_cast<const float4*>(Ct + n * kTS + rg * 4);
      const float4 b4 =
          *reinterpret_cast<const float4*>(Bt + n * kTS + cg * 4);
      const float cv[4] = {c4.x, c4.y, c4.z, c4.w};
      const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(cv[i], bv[j], acc[i][j]);
    }
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

// TILED = false: one tile holds the chunk (L <= kL, P <= kPT, N <= kNT),
// and every loop below runs once.
template <bool TILED>
__global__ void __launch_bounds__(kThreads)
    ssd_states(const float* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ dA, const float* __restrict__ Bm,
               float* __restrict__ seg_ws, float* __restrict__ st_ws, int H,
               int nc, int L, int P, int N) {
  constexpr int XS = kPT;              // row stride of x (zero past P)
  const int BS = N > 64 ? kNT : 64;    // row stride of B (zero past N)
  const int LB = TILED ? min(L, kL) : L;  // rows of a block of the chunk
  extern __shared__ __align__(16) float sm2[];
  __shared__ float total;    // seg_{L-1}, TILED
  float* Xs = sm2;           // LB x XS: w_l x_l of a block of rows
  float* Bs = Xs + LB * XS;  // LB x BS
  float* seg = Bs + LB * BS; // kL: seg of the block
  float* w = seg + kL;       // kL

  const size_t blk = blockIdx.x;  // (b * H + h) * nc + c
  const int c = (int)(blk % nc);
  const size_t b = blk / nc / H;
  const int tid = threadIdx.x;
  const float* xp = x + blk * L * P;
  const float* bp = Bm + (b * nc + c) * L * N;
  const int nlb = TILED ? (L + kL - 1) / kL : 1;
  auto copy_tile = [&](int l0, int p0, int n0) {
    const int rows = TILED ? min(kL, L - l0) : L;
    copy_block(Xs, XS, xp + (size_t)l0 * P + p0, P, rows, XS, rows, P - p0,
               (P & 3) == 0);
    copy_block(Bs, BS, bp + (size_t)l0 * N + n0, N, rows, BS, rows, N - n0,
               (N & 3) == 0);
  };

  copy_tile(0, 0, 0);
  if (tid < 32) {
    // seg = cumsum(dA) one add at a time from 0, while the copies above are
    // in flight: the order of the plain versions' cumsum along the chunk
    // (PyTorch scans a non-innermost dim in order; a parallel scan rounds
    // elsewhere, and at |seg| ~ 100 one ulp is 8e-6), a block of kL at a
    // time into seg_ws
    float run = 0.f;
    for (int l0 = 0; l0 < (TILED ? L : 1); l0 += kL) {
      const int rows = TILED ? min(kL, L - l0) : L;
      for (int i = tid; i < rows; i += 32) seg[i] = dA[blk * L + l0 + i];
      __syncwarp();
      if (tid == 0) {
        for (int i = 0; i < rows; ++i) {
          run += seg[i];
          seg[i] = run;
        }
      }
      __syncwarp();
      for (int i = tid; i < rows; i += 32) seg_ws[blk * L + l0 + i] = seg[i];
      if (TILED) __syncwarp();
    }
    if (TILED && tid == 0) total = run;
  }
  __syncthreads();
  const float tot = TILED ? total : seg[L - 1];

  // contribution[p][n] = sum_l (w_l x_l[p]) B_l[n], one FMA chain over l
  // from 0: thread (pg, ng) of 16 x 16 owns p = p0 + 4pg + i, n = n0 + 4ng
  // + 64j + e of a (P tile, N tile)
  const int pg = tid >> 4, ng = tid & 15;
  for (int p0 = 0; p0 < (TILED ? P : 1); p0 += kPT) {
    for (int n0 = 0; n0 < (TILED ? N : 1); n0 += kNT) {
      const int nj = N - n0 > 64 ? 2 : 1;
      float acc[4][2][4] = {};
      for (int l0 = 0; l0 < (TILED ? L : 1); l0 += kL) {
        const int rows = TILED ? min(kL, L - l0) : L;
        if (TILED && (p0 > 0 || n0 > 0 || l0 > 0)) {
          __syncthreads();  // the last block's products are done
          copy_tile(l0, p0, n0);
        }
        for (int i = tid; i < rows; i += kThreads) {
          // a block's seg is in shared memory only when it is the chunk
          const float sg = nlb > 1 ? seg_ws[blk * L + l0 + i] : seg[i];
          w[i] = expf(tot - sg) * dt[blk * L + l0 + i];
        }
        cp_async_wait_all();
        __syncthreads();
        for (int i = tid; i < rows * XS; i += kThreads) Xs[i] *= w[i / XS];
        __syncthreads();
        for (int l = 0; l < rows; ++l) {
          const float4 xv =
              *reinterpret_cast<const float4*>(Xs + l * XS + pg * 4);
          const float xa[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            if (j < nj) {
              const float4 bv = *reinterpret_cast<const float4*>(
                  Bs + l * BS + ng * 4 + 64 * j);
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
      }
      float* out = st_ws + blk * P * N;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int pp = p0 + pg * 4 + i;
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int n = n0 + ng * 4 + 64 * j + e;
            if (pp < P && n < N) out[(size_t)pp * N + n] = acc[i][j][e];
          }
      }
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

// The intra-chunk term of one key block, one FMA chain over m from 0:
// thread (rg, cg) owns rows rg + 32i and columns 4cg + 32j; on the
// diagonal block row block i (rows rg + 32i) meets key block kb only for
// kb <= i (A is zero above), below it every key.
template <bool DIAG>
__device__ __forceinline__ void intra_block(float (&acc)[4][2][4],
                                            const float* As, int AS,
                                            const float* Xs, int XS, int rg,
                                            int cg, int m4) {
#pragma unroll
  for (int kb = 0; kb < 4; ++kb) {
    const int mend = min(32 * kb + 32, m4);
    for (int m = 32 * kb; m < mend; m += 4) {
      float4 av[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (!DIAG || i >= kb)
          av[i] = *reinterpret_cast<const float4*>(As + (rg + 32 * i) * AS + m);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float4 xv = *reinterpret_cast<const float4*>(
              Xs + (m + u) * XS + cg * 4 + 32 * j);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            if (!DIAG || i >= kb) {
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
}

// Per (batch, head, chunk, block of kL rows, tile of kPT columns of P);
// TILED = false: one tile holds the chunk, and every loop below runs once.
template <bool TILED>
__global__ void __launch_bounds__(kThreads)
    ssd_out(const float* __restrict__ x, const float* __restrict__ dt,
            const float* __restrict__ Cm, const float* __restrict__ cb,
            const float* __restrict__ seg_ws, const float* __restrict__ st_ws,
            float* __restrict__ y, int H, int nc, int L, int P, int N) {
  constexpr int XS = kPT;      // row stride of x
  constexpr int TS = kPT + 4;  // row stride of S_in^T (transposed stores
                               // of a warp fall in 8 banks, not 1)
  constexpr int AS = kL + 4;   // row stride of the decayed CB
  const int NW = TILED ? min(N, kNT) : N;  // columns of N a pass
  const int N4 = (NW + 3) & ~3;
  const int CS = N4 + 4;       // row stride of C
  extern __shared__ __align__(16) float sm4[];
  float* seg = sm4;            // kL: seg of the block's rows
  float* dts = seg + kL;       // kL: dt of the key block
  float* segk = dts + kL;      // kL: seg of a key block below the diagonal
  float* buf = segk + kL;
  // phase A: C (kL rows x CS) and S_in^T (N4 x TS)
  float* Cs = buf;
  float* St = Cs + kL * CS;
  // phase B, over the same memory: A = CB o decay o dt (kL x AS), x
  float* As = buf;
  float* Xs = As + kL * AS;    // up to kL x XS

  const int nrb = TILED ? (L + kL - 1) / kL : 1;
  const int npt = TILED ? (P + kPT - 1) / kPT : 1;
  const size_t blk = blockIdx.x / (nrb * npt);  // (b * H + h) * nc + c
  const int tile = (int)(blockIdx.x % (nrb * npt));
  const int rb = tile / npt, p0 = (tile - rb * npt) * kPT;
  const int r0 = rb * kL, rows = TILED ? min(kL, L - r0) : L;
  const int c = (int)(blk % nc);
  const size_t b = blk / nc / H;
  const int tid = threadIdx.x;
  const int rg = tid >> 3, cg = tid & 7;
  const float* cp = Cm + ((b * nc + c) * L + r0) * N;
  const float* sp = st_ws + blk * P * N + (size_t)p0 * N;

  // seg of the rows; dt (and seg, below the diagonal) of key block 0
  const int mrows0 = TILED ? min(kL, L) : L;
  copy_block(seg, 0, seg_ws + blk * L + r0, 0, 1, rows, 1, rows, false);
  copy_block(dts, 0, dt + blk * L, 0, 1, mrows0, 1, mrows0, false);
  if (TILED && rb > 0)
    copy_block(segk, 0, seg_ws + blk * L, 0, 1, kL, 1, kL, false);

  // inter-chunk term C_l . S_in[p], one FMA chain over n from 0
  float inter[4][2][4] = {};
  for (int n0 = 0; n0 < (TILED ? N : 1); n0 += NW) {
    const int nw = TILED ? min(NW, N - n0) : N, nw4 = (nw + 3) & ~3;
    if (TILED && n0 > 0) __syncthreads();  // the last pass is done
    copy_block(Cs, CS, cp + n0, N, kL, nw4, rows, nw, (N & 3) == 0);
    for (int i = tid; i < nw4 * kPT; i += kThreads) {
      const int pp = i / nw4, n = i - pp * nw4;  // reads S_in row by row
      cp_async4(St + n * TS + pp, sp + (size_t)pp * N + n0 + n,
                pp < P - p0 && n < nw);
    }
    cp_async_wait_all();
    __syncthreads();
    for (int n = 0; n < nw4; n += 4) {
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
  }

  // intra-chunk term over the key blocks up to the diagonal one
  float acc[4][2][4] = {};
  for (int kb = 0; kb <= rb; ++kb) {
    const int m0 = kb * kL, mrows = TILED ? min(kL, L - m0) : L;
    const int m4 = (mrows + 3) & ~3;
    const bool diag = kb == rb;
    __syncthreads();  // phase A's memory, or the last key block's, is free
    if (TILED && kb > 0) {
      copy_block(dts, 0, dt + blk * L + m0, 0, 1, mrows, 1, mrows, false);
      if (!diag)
        copy_block(segk, 0, seg_ws + blk * L + m0, 0, 1, kL, 1, kL, false);
    }
    copy_block(As, AS, cb + ((b * nc + c) * L + r0) * L + m0, L, kL, m4,
               rows, mrows, (L & 3) == 0);
    copy_block(Xs, XS, x + (blk * L + m0) * P + p0, P, m4, XS, mrows, P - p0,
               (P & 3) == 0);
    cp_async_wait_all();
    __syncthreads();
    // A[l][m] = CB[l][m] exp(seg_l - seg_m) dt_m for m <= l, else 0 (a key
    // block below the diagonal one is at or below every row)
    const float* sk = diag ? seg : segk;
    for (int i = tid; i < kL * kL; i += kThreads) {
      const int l = i >> 7, m = i & (kL - 1);
      if (m < m4) {
        float* a = As + l * AS + m;
        *a = (l < rows && (!diag || m <= l))
                 ? *a * expf(seg[l] - sk[m]) * dts[m]
                 : 0.f;
      }
    }
    __syncthreads();
    if (diag)
      intra_block<true>(acc, As, AS, Xs, XS, rg, cg, m4);
    else
      intra_block<false>(acc, As, AS, Xs, XS, rg, cg, m4);
  }

  // y = y_intra + (C.S_in) exp(seg): two roundings, as the plain version
  float* yp = y + (blk * L + r0) * P;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int l = rg + 32 * i;
    if (l >= rows) continue;
    const float e = expf(seg[l]);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        v[u] = __fadd_rn(acc[i][j][u], __fmul_rn(inter[i][j][u], e));
      const int pc = p0 + cg * 4 + 32 * j;
      if ((P & 3) == 0 && pc < P) {
        *reinterpret_cast<float4*>(yp + (size_t)l * P + pc) =
            make_float4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (pc + u < P) yp[(size_t)l * P + pc + u] = v[u];
      }
    }
  }
}

}  // namespace

// Workspaces, allocated by the caller: cb (B, nc, L, L), seg (B, H, nc, L),
// states (B, H, nc, P, N).  Four launches on `stream`, each grid one
// dimension.  More than 2^31 - 1 blocks in a grid would need workspaces no
// card holds.
extern "C" int ssd_scan_launch(const void* x, const void* dt, const void* dA,
                               const void* Bm, const void* Cm, void* y,
                               void* st, void* cb_ws, void* seg_ws,
                               void* st_ws, int B, int H, int nc, int L,
                               int P, int N, void* stream) {
  if (L < 1 || P < 1 || N < 1 || B < 1 || H < 1 || nc < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int nb = (L + kT - 1) / kT, ntri = nb * (nb + 1) / 2;
  const size_t cb_blocks = (size_t)B * nc * ntri;
  const size_t blocks = (size_t)B * H * nc;
  const size_t out_blocks =
      blocks * ((L + kL - 1) / kL) * ((P + kPT - 1) / kPT);
  const size_t elems = (size_t)B * H * P * N;
  const size_t carry_blocks = (elems + kThreads - 1) / kThreads;
  if (cb_blocks > 0x7fffffff || out_blocks > 0x7fffffff ||
      carry_blocks > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  // shapes within one tile take the untiled kernels (every loop once)
  const bool tiled = L > kL || P > kPT || N > kNT;
  const int NW = N < kNT ? N : kNT, LB = L < kL ? L : kL;
  const size_t sm1 = sizeof(float) * 2 * (size_t)NW * kTS;
  const int BS = N > 64 ? kNT : 64;
  const size_t sm2 = sizeof(float) * ((size_t)LB * (kPT + BS) + 2 * kL);
  const int N4 = (NW + 3) & ~3, L4 = ((LB + 3) & ~3);
  const size_t phase_a = (size_t)kL * (N4 + 4) + (size_t)N4 * (kPT + 4);
  const size_t phase_b = (size_t)kL * (kL + 4) + (size_t)L4 * kPT;
  const size_t sm4 =
      sizeof(float) * (3 * kL + (phase_a > phase_b ? phase_a : phase_b));
  auto states = tiled ? ssd_states<true> : ssd_states<false>;
  auto out = tiled ? ssd_out<true> : ssd_out<false>;
  cudaError_t err;
  if ((err = cudaFuncSetAttribute(ssd_cb,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)sm1)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(states,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)sm2)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(out,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)sm4)) != cudaSuccess)
    return (int)err;
  ssd_cb<<<(unsigned)cb_blocks, kThreads, sm1, s>>>(
      (const float*)Bm, (const float*)Cm, (float*)cb_ws, L, N, ntri);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  states<<<(unsigned)blocks, kThreads, sm2, s>>>(
      (const float*)x, (const float*)dt, (const float*)dA, (const float*)Bm,
      (float*)seg_ws, (float*)st_ws, H, nc, L, P, N);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ssd_carry<<<(unsigned)carry_blocks, kThreads, 0, s>>>(
      (const float*)seg_ws, (float*)st_ws, (float*)st, B * H, nc, L, P * N);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  out<<<(unsigned)out_blocks, kThreads, sm4, s>>>(
      (const float*)x, (const float*)dt, (const float*)Cm,
      (const float*)cb_ws, (const float*)seg_ws, (const float*)st_ws,
      (float*)y, H, nc, L, P, N);
  return (int)cudaGetLastError();
}

extern "C" const char* ssd_scan_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
