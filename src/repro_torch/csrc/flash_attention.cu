// flash_attention: GQA softmax attention, causal or bidirectional, with an
// online softmax in f32.
//
// Replaces the Pallas kernel `flash_attention_bhsd`
// (src/repro/kernels/flash_attention/kernel.py:80, body `_flash_kernel` at
// :29).  q is (B, Hq, Sq, D), k/v are (B, Hkv, Sk, D), in f32 or bf16, each
// given by its batch, head and sequence strides in elements (the head dim
// is contiguous), so the model's (B, S, H, D) tensors are read in place.
// The output is written in q's dtype.  Query head h reads kv head
// h / (Hq / Hkv) in place: grouped K/V are never repeated in memory.  The
// causal mask is q_pos >= k_pos with both counted from 0, masked scores are
// NEG_INF = -1e30 as in the Pallas kernel, and the final division floors the
// softmax sum at 1e-30 (kernel.py:26, :75-77).  Keys past Sk and query rows
// past Sq are masked here, for any Sq and Sk, and any D >= 1, as the Pallas
// kernel takes them; a batch or query-block count past the 65,535 of a
// grid's y and z takes several grids.
//
// What bounds it on an H100: operations.  Causal prefill at B = 2, 32 heads,
// S = 2048, D = 80 does 4*B*H*D*S*(S+1)/2 = 43 GFLOP over 84 MB of q, k, v
// and the output (bf16): 0.043 ms at the 989 TFLOP/s of the bf16 tensor
// cores, 0.64 ms at the 67 TFLOP/s of f32 FMAs, 0.025 ms for the bytes.  So
// each path has to keep its arithmetic units fed from registers, with
// shared memory read as little as the tiles allow.
//
// The design.  A block owns 128 query rows of one (batch, head) and walks
// the keys in tiles; K and V tiles go through a ring in shared memory
// (three stages for bf16, two for f32), filled by 16-byte `cp.async` (zero
// bytes, so zeros, past Sk and past D) while earlier tiles are computed.
// Where a pointer or a stride is off the 16-byte grid the loader copies
// element by element instead, with the same zero fill.  The head dim is
// padded to the next multiple of 16 in shared memory only.  When causal,
// tiles wholly above the diagonal are never loaded, only tiles that cross
// it (or the ragged end of Sk) are masked, and the grid runs its heaviest
// query blocks (the last ones) first, so the triangle balances over the
// 132 SMs.
//
// bf16 (on the tensor cores, by `wgmma`): two warpgroups of 64 query rows,
// key tiles of 64.  Q, K and V tiles sit in shared memory in the layout a
// `wgmma` descriptor reads (8-row x 16-column atoms, 32-byte swizzle), so
// the tensor cores read each K and V tile once per warpgroup, not once per
// warp as `ldmatrix` feeding `mma.sync` would.  S = Q.K^T is `wgmma`
// m64n64k16 with both operands in shared memory; the online softmax runs
// on the accumulator fragments (row max across the four threads of a row
// by shuffles, exp2 of scores scaled in the same FMA); P is rounded to
// bf16 in registers, where the accumulator layout of S is the A-fragment
// layout of P, and O += P.V is `wgmma` m64n{D}k16 with A from registers
// and V read N-major.  Rounding P to bf16 is the one step the Pallas
// kernel does not take (it keeps P in f32); the softmax sum is taken from
// the f32 P.  A warpgroup whose rows are all above a tile skips it.
// Not done: warp specialisation, TMA, and overlapping one tile's softmax
// with the next tile's products (the FlashAttention-3 pipeline).
//
// f32 (FP32 cores, no TF32: f32 inputs keep f32 accuracy): register tiles
// in the SGEMM manner, key tiles of 32.  Thread (rg, cg) of 32 x 8 owns
// query rows 4rg..4rg+3, keys cg + 8j of the tile and the head-dim
// columns 2cg + 16i of O: each step of four d reads 4 + 4 float4s from
// shared memory for 64 FMAs of S.  P goes through shared memory (a row's
// eight threads share one warp, so a __syncwarp orders it) and O += P.V
// reads 4 float4s of P and float2s of V for 16 FMAs each.
//
// Wide heads (head dim padded to 16 above 160).  The tiles above stop
// fitting there: the bf16 ring takes 2 (128 + 2 * 3 * 64) DP + 1024 bytes
// of shared memory, over the 232,448 a block may have above DP 224; its O
// accumulator takes DP / 2 registers a thread and `wgmma` N stops at 256;
// the f32 kernel holds 254 registers at DP 160 and its tiles pass the
// limit above DP 192.  So a wide block owns 128 query rows and one slice
// of kDV = 128 columns of O, in either dtype.  It walks the key tiles as
// above, but S = Q.K^T sums over the head dim in chunks (64 columns in
// bf16, 32 in f32) that stream through a ring of shared memory, one chunk
// a step; after a tile's last chunk the same online softmax as the narrow
// paths, then O_slice += P.V_slice.  The ceil(D / 128) blocks of one query
// block each compute the same S in the same order, so their softmax
// statistics are equal bit for bit and each writes its own columns; S is
// computed once a slice.  Q stays in shared memory for the whole walk where
// it fits (`kQResBf16`, `kQResF32`); past that its chunks stream beside K's,
// so no head dim is refused.  Each step waits for its own products (no
// overlap of the softmax with the tensor cores): right first, not fast.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

constexpr int kBQ = 128;       // query rows per block (both paths)
constexpr int kThreads = 256;  // 8 warps
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

struct Strides {  // in elements: batch, head, sequence
  int64_t b, h, s;
};

// The grid is (head [x slice of O's columns], batch, query block), the
// heaviest query blocks (the last ones) first.  gridDim.y and z stop at
// 65,535, so the launcher covers a larger batch or query-block count with
// several grids: each names its first batch b0 and the index of its first
// (heaviest) query block, ztop.
constexpr unsigned kMaxGridYZ = 65535;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared; src_bytes 0 writes 16 zero bytes
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ float zero<float>() {
  return 0.f;
}
template <>
__device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
}

// Copy rows [0, ROWS) x cols [0, DP) of a tile into shared memory (row
// stride SS elements): rows at or past `valid` and columns at or past D
// are zeros.  `vec`: 16-byte cp.async (every pointer, stride and D on the
// 16-byte grid); otherwise element by element, synchronously.
template <typename T, int ROWS, int DP, int SS>
__device__ __forceinline__ void load_tile(T* dst, const T* src,
                                          int64_t stride, int valid, int D,
                                          bool vec, int tid) {
  constexpr int E = 16 / sizeof(T);
  if (vec) {
    constexpr int CPR = DP / E;
    for (int i = tid; i < ROWS * CPR; i += kThreads) {
      const int r = i / CPR, c = (i - r * CPR) * E;
      const bool ok = r < valid && c < D;
      cp_async16(dst + r * SS + c, ok ? src + r * stride + c : src,
                 ok ? 16 : 0);
    }
  } else {
    for (int i = tid; i < ROWS * DP; i += kThreads) {
      const int r = i / DP, c = i - r * DP;
      dst[r * SS + c] = (r < valid && c < D) ? src[r * stride + c] : zero<T>();
    }
  }
}

// -- bf16: warpgroup MMA on the tensor cores ----------------------------------

// 2^x by the SFU (rel. error about 2^-22, far below the bf16 rounding of P
// that follows; tiny results flush to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// d (+)= a.b for one warpgroup, m64nNk16, bf16 -> f32: A from registers
// (the mma.sync A-fragment layout per warp), B from shared memory
// through a descriptor, read N-major (imm-trans-b 1)
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t desc, int scale_d);
template <>
__device__ __forceinline__ void wgmma_rs<16>(float (&d)[8],
                                              const uint32_t (&a)[4],
                                              uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7 "
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<32>(float (&d)[16],
                                              const uint32_t (&a)[4],
                                              uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15 "
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<48>(float (&d)[24],
                                              const uint32_t (&a)[4],
                                              uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23 "
      "}, {%24, %25, %26, %27}, %28, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31 "
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<80>(float (&d)[40],
                                              const uint32_t (&a)[4],
                                              uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39 "
      "}, {%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<96>(float (&d)[48],
                                              const uint32_t (&a)[4],
                                              uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47 "
      "}, {%48, %49, %50, %51}, %52, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<112>(float (&d)[56],
                                              const uint32_t (&a)[4],
                                              uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %61, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n112k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55 "
      "}, {%56, %57, %58, %59}, %60, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63 "
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<144>(float (&d)[72],
                                              const uint32_t (&a)[4],
                                              uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %77, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n144k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63, %64, %65, %66, %67, %68, %69, %70, %71 "
      "}, {%72, %73, %74, %75}, %76, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<160>(float (&d)[80],
                                              const uint32_t (&a)[4],
                                              uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %85, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, "
      "%74, %75, %76, %77, %78, %79 "
      "}, {%80, %81, %82, %83}, %84, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

// d (+)= a.b^T, m64n64k16: A and B both K-major in shared memory
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32],
                                                uint64_t desc_a,
                                                uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31 "
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}


constexpr int kBKh = 64;    // keys per tile
constexpr int kStages = 3;  // K/V tiles in the ring

// Tiles for wgmma live in shared memory as 8-row x 16-column atoms of 256
// bytes, atom (r/8, c/16) at ((r/8) * DP/16 + c/16) * 256, rows of 32 bytes
// whose two 16-byte halves are swapped in rows 4-7 (the 32-byte swizzle the
// descriptor names, which spreads ldmatrix-free reads of the tensor cores
// over all banks).  Q and K are read K-major (d contiguous), V N-major.
template <int DP>
__device__ __forceinline__ int atom_off(int r, int c) {
  return ((r >> 3) * (DP / 16) + (c >> 4)) * 256 + (r & 7) * 32 +
         ((((c >> 3) & 1) ^ ((r >> 2) & 1)) << 4) + (c & 7) * 2;
}
// wgmma shared-memory descriptor: start address, leading and stride byte
// offsets (in 16-byte units) and the 32-byte swizzle mode
__device__ __forceinline__ uint64_t wg_desc(uint32_t addr, int lbo, int sbo) {
  return ((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (3ull << 62);
}
__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
// keep the compiler from moving accumulators across the asynchronous MMAs
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// Copy rows [0, ROWS) x cols [0, DP) of a bf16 tile into the atom layout
// at shared address `dst`, zeros at or past row `valid` or column D.
template <int ROWS, int DP>
__device__ __forceinline__ void load_atoms(unsigned char* dst,
                                           const __nv_bfloat16* src,
                                           int64_t stride, int valid, int D,
                                           bool vec, int tid) {
  if (vec) {
    constexpr int CPR = DP / 8;
    for (int i = tid; i < ROWS * CPR; i += kThreads) {
      const int r = i / CPR, c = (i - r * CPR) * 8;
      const bool ok = r < valid && c < D;
      cp_async16(dst + atom_off<DP>(r, c), ok ? src + r * stride + c : src,
                 ok ? 16 : 0);
    }
  } else {
    for (int i = tid; i < ROWS * DP; i += kThreads) {
      const int r = i / DP, c = i - r * DP;
      *reinterpret_cast<__nv_bfloat16*>(dst + atom_off<DP>(r, c)) =
          (r < valid && c < D) ? src[r * stride + c] : zero<__nv_bfloat16>();
    }
  }
}

// The online softmax of one 64-key tile on a warp's S fragment (rows wq0
// + g and wq0 + g + 8 of the warp's 16; keys k0 + 8n + 2t + (e & 1)): masks
// keys at or past Sk and, when causal, above the diagonal (only on an
// `edge` tile); takes the new row maxima in log2 units, P = 2^(S sl2 - m)
// in place and this thread's share of the row sums; c0 and c1 rescale O.
__device__ __forceinline__ void softmax_bf16(float (&s)[32], float& m0,
                                             float& m1, float& l0, float& l1,
                                             float& c0, float& c1, bool edge,
                                             int k0, int wq0, int g, int t,
                                             int Sk, int causal, float sl2) {
  float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    if (edge) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kpos = k0 + n * 8 + 2 * t + (e & 1);
        const int qpos = wq0 + g + (e >> 1) * 8;
        if (kpos >= Sk || (causal && qpos < kpos)) s[n * 4 + e] = kNegInf;
      }
    }
    mx0 = fmaxf(mx0, fmaxf(s[n * 4], s[n * 4 + 1]));
    mx1 = fmaxf(mx1, fmaxf(s[n * 4 + 2], s[n * 4 + 3]));
  }
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
  const float mn0 = fmaxf(m0, mx0 * sl2), mn1 = fmaxf(m1, mx1 * sl2);
  c0 = ex2(m0 - mn0);
  c1 = ex2(m1 - mn1);
  m0 = mn0;
  m1 = mn1;
  float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    s[n * 4 + 0] = ex2(fmaf(s[n * 4 + 0], sl2, -mn0));
    s[n * 4 + 1] = ex2(fmaf(s[n * 4 + 1], sl2, -mn0));
    s[n * 4 + 2] = ex2(fmaf(s[n * 4 + 2], sl2, -mn1));
    s[n * 4 + 3] = ex2(fmaf(s[n * 4 + 3], sl2, -mn1));
    rs0 += s[n * 4 + 0] + s[n * 4 + 1];
    rs1 += s[n * 4 + 2] + s[n * 4 + 3];
  }
  l0 = l0 * c0 + rs0;  // this thread's share; summed over the quad last
  l1 = l1 * c1 + rs1;
}

// P (bf16, rounded in registers) as the A fragments of P.V: the accumulator
// layout of S is the A-fragment layout of P
__device__ __forceinline__ void pack_p(uint32_t (&pa)[4][4],
                                       const float (&s)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    pa[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
    pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
    pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
    pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
  }
}

// O's rows g and g + 8 of a warp's accumulator times c0 and c1
template <int N>
__device__ __forceinline__ void rescale(float (&acc)[N], float c0, float c1) {
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
    acc[j * 4 + 0] *= c0;
    acc[j * 4 + 1] *= c0;
    acc[j * 4 + 2] *= c1;
    acc[j * 4 + 3] *= c1;
  }
}

// DP: head dim padded to a multiple of 16.  Two warpgroups of 64 query
// rows; a warp owns 16 of them, as the wgmma accumulator lays them out.
template <int DP>
__global__ void __launch_bounds__(kThreads, DP <= 96 ? 2 : 1)
    flash_bf16(const __nv_bfloat16* __restrict__ q,
               const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v,
               __nv_bfloat16* __restrict__ o, int b0, int ztop, int Hq,
               int Hkv, int Sq, int Sk, int D, Strides qs, Strides ks,
               Strides vs, Strides os, int causal, float scale, int vec) {
  constexpr int TILE = kBKh * DP * 2;  // bytes of one K or V tile
  constexpr int SBO = (DP / 16) * 256; // bytes between 8-row groups
  extern __shared__ unsigned char smem_raw[];
  // the swizzle acts on address bits, so tiles start on 1024-byte bounds
  unsigned char* Qs = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* Ks = Qs + kBQ * DP * 2;     // kStages tiles
  unsigned char* Vs = Ks + kStages * TILE;   // kStages tiles

  const int h = blockIdx.x, b = b0 + blockIdx.y;
  const int q0 = (ztop - (int)blockIdx.z) * kBQ;  // heaviest first
  const int hk = h / (Hq / Hkv);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wg = warp >> 2;
  const int gq0 = q0 + wg * 64;              // the warpgroup's first row
  const int wq0 = gq0 + (warp & 3) * 16;     // the warp's first row

  const __nv_bfloat16* qp = q + b * qs.b + h * qs.h + (int64_t)q0 * qs.s;
  const __nv_bfloat16* kp = k + b * ks.b + hk * ks.h;
  const __nv_bfloat16* vp = v + b * vs.b + hk * vs.h;
  const bool vecb = vec != 0;

  const int kend = causal ? min(Sk, q0 + kBQ) : Sk;
  const int ntiles = (kend + kBKh - 1) / kBKh;
  // tiles [0, nlive) hold keys at or below some row of this warpgroup
  const int nlive = gq0 >= Sq ? 0
                  : causal ? min(ntiles, (gq0 + 63) / kBKh + 1)
                           : ntiles;

  load_atoms<kBQ, DP>(Qs, qp, qs.s, Sq - q0, D, vecb, tid);
  // the ring: tile kt + 1 lands while kt is computed, and tile kt + 2 is
  // loaded once tile kt - 1's P.V is done with its stage
  auto load_kv = [&](int kt) {
    const int st = kt % kStages, k0 = kt * kBKh;
    load_atoms<kBKh, DP>(Ks + st * TILE, kp + (int64_t)k0 * ks.s, ks.s,
                         Sk - k0, D, vecb, tid);
    load_atoms<kBKh, DP>(Vs + st * TILE, vp + (int64_t)k0 * vs.s, vs.s,
                         Sk - k0, D, vecb, tid);
  };
  load_kv(0);
  cp_async_commit();  // group: Q and tile 0
  if (ntiles > 1) load_kv(1);
  cp_async_commit();  // group: tile 1 (maybe empty)
  cp_async_wait<1>();
  // make this thread's copies visible to the tensor cores' reads
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  float acc[DP / 2];  // O: 16 rows x DP per warp, as DP / 8 n-blocks of 4
#pragma unroll
  for (int j = 0; j < DP / 2; ++j) acc[j] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;  // rows g, g + 8
  const float sl2 = scale * kLog2e;
  const uint32_t qa = smem_u32(Qs) + wg * 8 * SBO;
  uint32_t pa[4][4];  // P of the previous tile, in bf16, as A fragments
  auto issue_pv = [&](int kt) {  // O += P.V of tile kt, asynchronously
    const uint32_t va = smem_u32(Vs + (kt % kStages) * TILE);
    pin(acc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs<DP>(acc, pa[kk], wg_desc(va + kk * 2 * SBO, 256, SBO), 1);
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  };

  for (int kt = 0; kt < ntiles; ++kt) {
    const int k0 = kt * kBKh;
    if (kt < nlive) {
      // S = Q.K^T of tile kt, then P.V of tile kt - 1: the tensor cores
      // run that product while this warpgroup does tile kt's softmax
      const uint32_t ka = smem_u32(Ks + (kt % kStages) * TILE);
      float s[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = 0.f;
      pin(s);
      wg_fence();
#pragma unroll
      for (int kd = 0; kd < DP / 16; ++kd)
        wgmma_ss_n64(s, wg_desc(qa + kd * 256, 16, SBO),
                     wg_desc(ka + kd * 256, 16, SBO), kd > 0);
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      if (kt > 0) {
        issue_pv(kt - 1);
        asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
      } else {
        asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      }
      pin(s);
      const bool edge = (causal && k0 + kBKh - 1 > wq0) || k0 + kBKh > Sk;
      float c0, c1;
      softmax_bf16(s, m0, m1, l0, l1, c0, c1, edge, k0, wq0, g, t, Sk, causal,
                   sl2);
      // tile kt - 1's P.V is done: its P and O may change now
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      pin(acc);
      rescale(acc, c0, c1);
      pack_p(pa, s);
    } else if (kt == nlive && kt > 0) {
      issue_pv(kt - 1);  // the warpgroup's last P.V
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      pin(acc);
    }
    __syncthreads();  // every P.V of tile kt - 1 is done with its stage
    if (kt + 2 < ntiles) load_kv(kt + 2);
    cp_async_commit();
    cp_async_wait<1>();  // tile kt + 1 has landed
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
  }
  if (nlive == ntiles && nlive > 0) {
    issue_pv(ntiles - 1);
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    pin(acc);
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
  const int r0 = wq0 + g, r1 = r0 + 8;
  __nv_bfloat16* op = o + b * os.b + h * os.h;
#pragma unroll
  for (int j = 0; j < DP / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int d = j * 8 + 2 * t + e;
      if (d < D) {
        if (r0 < Sq)
          op[(int64_t)r0 * os.s + d] = __float2bfloat16(acc[j * 4 + e] * inv0);
        if (r1 < Sq)
          op[(int64_t)r1 * os.s + d] =
              __float2bfloat16(acc[j * 4 + 2 + e] * inv1);
      }
    }
  }
}

// -- f32: register tiles on the FP32 cores ------------------------------------

constexpr int kBKf = 32;        // keys per tile
constexpr int kPSf = kBKf + 4;  // row stride of P

// s[i][j] += Q[row0 + i][d] K[cg + 8j][d] over d in [0, DEPTH): one FMA
// chain per (i, j) in the order of d; Q and K rows qss and kss floats apart
template <int DEPTH>
__device__ __forceinline__ void qk_f32(float (&s)[4][4], const float* Qt,
                                       int qss, const float* Kt, int kss,
                                       int row0, int cg) {
#pragma unroll 4
  for (int d = 0; d < DEPTH; d += 4) {
    float4 qv[4], kv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      qv[i] = *reinterpret_cast<const float4*>(Qt + (row0 + i) * qss + d);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      kv[j] = *reinterpret_cast<const float4*>(Kt + (cg + 8 * j) * kss + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
        s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
        s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
        s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
      }
  }
}

// The online softmax of one 32-key tile on query rows q0 + row0 + i (keys
// k0 + cg + 8j): scale, mask keys at or past Sk and, when causal, above the
// diagonal (only on an `edge` tile), new row maxima across the row's 8
// threads, P = exp(S - m) into Ps, this thread's share of the row sums, and
// O rescaled.
template <int NC>
__device__ __forceinline__ void softmax_f32(float (&s)[4][4], float (&m)[4],
                                            float (&l)[4],
                                            float (&acc)[4][NC][2], float* Ps,
                                            int q0, int row0, int cg, int k0,
                                            bool edge, int Sk, int causal,
                                            float scale) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + row0 + i;
    float mx = kNegInf;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float x = s[i][j] * scale;
      if (edge) {
        const int kpos = k0 + cg + 8 * j;
        if (kpos >= Sk || (causal && qpos < kpos)) x = kNegInf;
      }
      s[i][j] = x;
      mx = fmaxf(mx, x);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
    const float mn = fmaxf(m[i], mx);
    const float corr = expf(m[i] - mn);
    m[i] = mn;
    float rs = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float p = expf(s[i][j] - mn);
      Ps[(row0 + i) * kPSf + cg + 8 * j] = p;
      rs += p;
    }
    l[i] = l[i] * corr + rs;  // this thread's share; summed over 8 last
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      acc[i][c][0] *= corr;
      acc[i][c][1] *= corr;
    }
  }
}

// O[row0 + i][2cg + 16c + e] += P[row0 + i][kk] V[kk][2cg + 16c + e] over
// the tile's 32 keys; V rows VS floats apart
template <int NC, int VS>
__device__ __forceinline__ void pv_f32(float (&acc)[4][NC][2], const float* Ps,
                                       const float* Vt, int row0, int cg) {
#pragma unroll 2
  for (int kk = 0; kk < kBKf; kk += 4) {
    float4 pv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      pv[i] = *reinterpret_cast<const float4*>(Ps + (row0 + i) * kPSf + kk);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float* vr = Vt + (kk + u) * VS + cg * 2;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float2 vv = *reinterpret_cast<const float2*>(vr + 16 * c);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = u == 0 ? pv[i].x
                        : u == 1 ? pv[i].y
                        : u == 2 ? pv[i].z
                                 : pv[i].w;
          acc[i][c][0] = fmaf(p, vv.x, acc[i][c][0]);
          acc[i][c][1] = fmaf(p, vv.y, acc[i][c][1]);
        }
      }
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(kThreads)
    flash_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o, int b0,
              int ztop, int Hq, int Hkv, int Sq, int Sk, int D, Strides qs,
              Strides ks, Strides vs, Strides os, int causal, float scale,
              int vec) {
  constexpr int SS = DP + 4;     // row stride of Q, K, V: float4 rows in
                                 // distinct banks for 8 consecutive rows
  constexpr int NC = DP / 16;    // float2 columns of O per thread
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);
  float* Ks = Qs + kBQ * SS;       // 2 stages of kBKf x SS
  float* Vs = Ks + 2 * kBKf * SS;  // 2 stages of kBKf x SS
  float* Ps = Vs + 2 * kBKf * SS;  // kBQ x kPSf

  const int h = blockIdx.x, b = b0 + blockIdx.y;
  const int q0 = (ztop - (int)blockIdx.z) * kBQ;  // heaviest first
  const int hk = h / (Hq / Hkv);
  const int tid = threadIdx.x;
  const int rg = tid >> 3, cg = tid & 7;
  const int row0 = rg * 4;  // rows row0..row0+3 of the block

  const float* qp = q + b * qs.b + h * qs.h + (int64_t)q0 * qs.s;
  const float* kp = k + b * ks.b + hk * ks.h;
  const float* vp = v + b * vs.b + hk * vs.h;
  const bool vecb = vec != 0;

  const int kend = causal ? min(Sk, q0 + kBQ) : Sk;
  const int ntiles = (kend + kBKf - 1) / kBKf;

  load_tile<float, kBQ, DP, SS>(Qs, qp, qs.s, Sq - q0, D, vecb, tid);
  load_tile<float, kBKf, DP, SS>(Ks, kp, ks.s, Sk, D, vecb, tid);
  load_tile<float, kBKf, DP, SS>(Vs, vp, vs.s, Sk, D, vecb, tid);
  cp_async_commit();

  float acc[4][NC][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c][0] = acc[i][c][1] = 0.f;
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
  }

  for (int kt = 0; kt < ntiles; ++kt) {
    const int k0 = kt * kBKf;
    if (kt + 1 < ntiles) {
      const int st = (kt + 1) & 1, kn = k0 + kBKf;
      load_tile<float, kBKf, DP, SS>(Ks + st * kBKf * SS,
                                     kp + (int64_t)kn * ks.s, ks.s, Sk - kn,
                                     D, vecb, tid);
      load_tile<float, kBKf, DP, SS>(Vs + st * kBKf * SS,
                                     vp + (int64_t)kn * vs.s, vs.s, Sk - kn,
                                     D, vecb, tid);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    const float* Kt = Ks + (kt & 1) * kBKf * SS;
    const float* Vt = Vs + (kt & 1) * kBKf * SS;
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
    qk_f32<DP>(s, Qs, SS, Kt, SS, row0, cg);
    const bool edge = (causal && k0 + kBKf - 1 > q0) || k0 + kBKf > Sk;
    softmax_f32(s, m, l, acc, Ps, q0, row0, cg, k0, edge, Sk, causal, scale);
    __syncwarp();  // a row's P was written by the 8 threads of its group
    pv_f32<NC, SS>(acc, Ps, Vt, row0, cg);
    __syncthreads();  // the stage read here is refilled next iteration
  }

  float* op = o + b * os.b + h * os.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float li = l[i];
    li += __shfl_xor_sync(0xffffffffu, li, 1);
    li += __shfl_xor_sync(0xffffffffu, li, 2);
    li += __shfl_xor_sync(0xffffffffu, li, 4);
    const float denom = fmaxf(li, 1e-30f);
    const int qpos = q0 + row0 + i;
    if (qpos < Sq) {
#pragma unroll
      for (int c = 0; c < NC; ++c) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int d = cg * 2 + 16 * c + e;
          if (d < D) op[(int64_t)qpos * os.s + d] = acc[i][c][e] / denom;
        }
      }
    }
  }
}

// -- wide heads: head-dim chunks and 128-column slices of O ---------------------

constexpr int kDV = 128;        // O columns a wide block owns
constexpr int kKCh = 64;        // head-dim columns of a chunk, bf16
constexpr int kKCf = 32;        // the same, f32
constexpr int kStagesW = 3;     // bf16 chunks in the ring
constexpr int kQResBf16 = 512;  // Q stays in shared memory up to this
constexpr int kQResF32 = 320;   // padded head dim (bf16, f32)

// load_tile / load_atoms with the row width (and stride) known at run
// time: the resident Q of the wide kernels
__device__ __forceinline__ int atom_off_rt(int r, int c, int dp) {
  return ((r >> 3) * (dp >> 4) + (c >> 4)) * 256 + (r & 7) * 32 +
         ((((c >> 3) & 1) ^ ((r >> 2) & 1)) << 4) + (c & 7) * 2;
}
__device__ __forceinline__ void load_atoms_rt(unsigned char* dst,
                                              const __nv_bfloat16* src,
                                              int64_t stride, int rows, int dp,
                                              int valid, int D, bool vec,
                                              int tid) {
  if (vec) {
    const int cpr = dp / 8;
    for (int i = tid; i < rows * cpr; i += kThreads) {
      const int r = i / cpr, c = (i - r * cpr) * 8;
      const bool ok = r < valid && c < D;
      cp_async16(dst + atom_off_rt(r, c, dp), ok ? src + r * stride + c : src,
                 ok ? 16 : 0);
    }
  } else {
    for (int i = tid; i < rows * dp; i += kThreads) {
      const int r = i / dp, c = i - r * dp;
      *reinterpret_cast<__nv_bfloat16*>(dst + atom_off_rt(r, c, dp)) =
          (r < valid && c < D) ? src[r * stride + c] : zero<__nv_bfloat16>();
    }
  }
}
__device__ __forceinline__ void load_tile_rt(float* dst, int ss,
                                             const float* src, int64_t stride,
                                             int rows, int cols, int valid,
                                             int D, bool vec, int tid) {
  if (vec) {
    const int cpr = cols / 4;
    for (int i = tid; i < rows * cpr; i += kThreads) {
      const int r = i / cpr, c = (i - r * cpr) * 4;
      const bool ok = r < valid && c < D;
      cp_async16(dst + r * ss + c, ok ? src + r * stride + c : src,
                 ok ? 16 : 0);
    }
  } else {
    for (int i = tid; i < rows * cols; i += kThreads) {
      const int r = i / cols, c = i - r * cols;
      dst[r * ss + c] = (r < valid && c < D) ? src[r * stride + c] : 0.f;
    }
  }
}

// bf16, wide: two warpgroups of 64 query rows, key tiles of 64, S summed
// over head-dim chunks of kKCh by wgmma m64n64k16 from shared memory, O's
// slice by wgmma m64n128k16 with P from registers.  Step i of the walk is
// chunk i % nd of key tile i / nd; its K chunk (with the Q chunk unless
// QRES, and with the tile's V slice at the tile's first chunk) is loaded
// two steps ahead into a ring of kStagesW.
template <bool QRES>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bf16_wide(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    __nv_bfloat16* __restrict__ o, int b0, int ztop,
                    int Hq, int Hkv, int Sq, int Sk, int D, Strides qs,
                    Strides ks, Strides vs, Strides os, int causal,
                    float scale, int vec) {
  constexpr int QT = kBQ * kKCh * 2;       // bytes of a streamed Q chunk
  constexpr int KT = kBKh * kKCh * 2;      // bytes of a K chunk
  constexpr int VT = kBKh * kDV * 2;       // bytes of a V slice
  constexpr int SBO = (kKCh / 16) * 256;   // chunks: bytes between 8-row groups
  constexpr int SBOV = (kDV / 16) * 256;   // V slices: the same
  const int DPQ = (D + kKCh - 1) / kKCh * kKCh;
  const int nd = DPQ / kKCh;               // chunks a key tile: 3 or more
  const int SBOQ = QRES ? (DPQ / 16) * 256 : SBO;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* Qs = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* Ks = Qs + (QRES ? kBQ * DPQ * 2 : kStagesW * QT);
  unsigned char* Vs = Ks + kStagesW * KT;  // 2 slices

  const int ns = (D + kDV - 1) / kDV;      // slices of O's columns
  const int h = blockIdx.x / ns, b = b0 + blockIdx.y;
  const int c0 = (blockIdx.x - h * ns) * kDV;
  const int q0 = (ztop - (int)blockIdx.z) * kBQ;  // heaviest first
  const int hk = h / (Hq / Hkv);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wg = warp >> 2;
  const int gq0 = q0 + wg * 64;
  const int wq0 = gq0 + (warp & 3) * 16;

  const __nv_bfloat16* qp = q + b * qs.b + h * qs.h + (int64_t)q0 * qs.s;
  const __nv_bfloat16* kp = k + b * ks.b + hk * ks.h;
  const __nv_bfloat16* vp = v + b * vs.b + hk * vs.h;
  const bool vecb = vec != 0;

  const int kend = causal ? min(Sk, q0 + kBQ) : Sk;
  const int ntiles = (kend + kBKh - 1) / kBKh;
  const int nlive = gq0 >= Sq ? 0
                  : causal ? min(ntiles, (gq0 + 63) / kBKh + 1)
                           : ntiles;
  const int nsteps = ntiles * nd;
  // V slice kt + 1 is loaded at step (kt + 1) nd - 2, after tile kt - 1's
  // P.V read the same slot, because nd >= 3
  auto load_step = [&](int i) {
    const int kt = i / nd, dc = i - kt * nd, st = i % kStagesW;
    const int k0 = kt * kBKh, d0 = dc * kKCh;
    if (!QRES)
      load_atoms<kBQ, kKCh>(Qs + st * QT, qp + d0, qs.s, Sq - q0, D - d0,
                            vecb, tid);
    load_atoms<kBKh, kKCh>(Ks + st * KT, kp + (int64_t)k0 * ks.s + d0, ks.s,
                           Sk - k0, D - d0, vecb, tid);
    if (dc == 0)
      load_atoms<kBKh, kDV>(Vs + (kt & 1) * VT, vp + (int64_t)k0 * vs.s + c0,
                            vs.s, Sk - k0, D - c0, vecb, tid);
  };
  if (QRES) load_atoms_rt(Qs, qp, qs.s, kBQ, DPQ, Sq - q0, D, vecb, tid);
  load_step(0);
  cp_async_commit();  // group: (Q and) step 0
  if (nsteps > 1) load_step(1);
  cp_async_commit();  // group: step 1 (maybe empty)

  float acc[kDV / 2];  // O's slice: 16 rows x kDV per warp
#pragma unroll
  for (int j = 0; j < kDV / 2; ++j) acc[j] = 0.f;
  float s[32];
  uint32_t pa[4][4];
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
  const float sl2 = scale * kLog2e;
  for (int i = 0; i < nsteps; ++i) {
    if (i + 2 < nsteps) load_step(i + 2);
    cp_async_commit();
    cp_async_wait<2>();  // step i has landed
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    const int kt = i / nd, dc = i - kt * nd, st = i % kStagesW;
    if (kt < nlive) {
      const uint32_t qa =
          QRES ? smem_u32(Qs) + wg * 8 * SBOQ + dc * (kKCh / 16) * 256
               : smem_u32(Qs + st * QT) + wg * 8 * SBO;
      const uint32_t ka = smem_u32(Ks + st * KT);
      if (dc == 0) {
#pragma unroll
        for (int j = 0; j < 32; ++j) s[j] = 0.f;
      }
      pin(s);
      wg_fence();
#pragma unroll
      for (int kd = 0; kd < kKCh / 16; ++kd)
        wgmma_ss_n64(s, wg_desc(qa + kd * 256, 16, SBOQ),
                     wg_desc(ka + kd * 256, 16, SBO), dc > 0 || kd > 0);
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      pin(s);
      if (dc == nd - 1) {
        const int k0 = kt * kBKh;
        const bool edge = (causal && k0 + kBKh - 1 > wq0) || k0 + kBKh > Sk;
        float c0f, c1f;
        softmax_bf16(s, m0, m1, l0, l1, c0f, c1f, edge, k0, wq0, g, t, Sk,
                     causal, sl2);
        rescale(acc, c0f, c1f);
        pack_p(pa, s);
        const uint32_t va = smem_u32(Vs + (kt & 1) * VT);
        pin(acc);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_rs<kDV>(acc, pa[kk], wg_desc(va + kk * 2 * SBOV, 256, SBOV),
                        1);
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
        pin(acc);
      }
    }
    __syncthreads();  // step i's slots are refilled from step i + 1 on
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
  const int r0 = wq0 + g, r1 = r0 + 8;
  __nv_bfloat16* op = o + b * os.b + h * os.h;
#pragma unroll
  for (int j = 0; j < kDV / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int d = c0 + j * 8 + 2 * t + e;
      if (d < D) {
        if (r0 < Sq)
          op[(int64_t)r0 * os.s + d] = __float2bfloat16(acc[j * 4 + e] * inv0);
        if (r1 < Sq)
          op[(int64_t)r1 * os.s + d] =
              __float2bfloat16(acc[j * 4 + 2 + e] * inv1);
      }
    }
  }
}

// f32, wide: the narrow f32 kernel's threads and tiles, with S summed over
// head-dim chunks of kKCf and O's slice of kDV columns.  Step i is chunk
// i % nd of key tile i / nd, loaded one step ahead into two slots.
template <bool QRES>
__global__ void __launch_bounds__(kThreads)
    flash_f32_wide(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, float* __restrict__ o, int b0,
                   int ztop, int Hq, int Hkv, int Sq, int Sk, int D,
                   Strides qs, Strides ks, Strides vs, Strides os, int causal,
                   float scale, int vec) {
  constexpr int SC = kKCf + 4;  // row stride of K and streamed Q chunks
  constexpr int SV = kDV + 4;   // row stride of V slices
  constexpr int NC = kDV / 16;  // float2 columns of O per thread
  const int DPQ = (D + kKCf - 1) / kKCf * kKCf;
  const int nd = DPQ / kKCf;
  const int SQ = QRES ? DPQ + 4 : SC;  // row stride of Q
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);
  float* Ks = Qs + (QRES ? kBQ * SQ : 2 * kBQ * SC);  // 2 chunks
  float* Vs = Ks + 2 * kBKf * SC;                     // 2 slices
  float* Ps = Vs + 2 * kBKf * SV;                     // kBQ x kPSf

  const int ns = (D + kDV - 1) / kDV;  // slices of O's columns
  const int h = blockIdx.x / ns, b = b0 + blockIdx.y;
  const int c0 = (blockIdx.x - h * ns) * kDV;
  const int q0 = (ztop - (int)blockIdx.z) * kBQ;  // heaviest first
  const int hk = h / (Hq / Hkv);
  const int tid = threadIdx.x;
  const int rg = tid >> 3, cg = tid & 7;
  const int row0 = rg * 4;

  const float* qp = q + b * qs.b + h * qs.h + (int64_t)q0 * qs.s;
  const float* kp = k + b * ks.b + hk * ks.h;
  const float* vp = v + b * vs.b + hk * vs.h;
  const bool vecb = vec != 0;

  const int kend = causal ? min(Sk, q0 + kBQ) : Sk;
  const int nsteps = (kend + kBKf - 1) / kBKf * nd;
  // V slice kt + 1 is loaded at step (kt + 1) nd - 1, after tile kt - 1's
  // P.V read the same slot
  auto load_step = [&](int i) {
    const int kt = i / nd, dc = i - kt * nd, st = i & 1;
    const int k0 = kt * kBKf, d0 = dc * kKCf;
    if (!QRES)
      load_tile<float, kBQ, kKCf, SC>(Qs + st * kBQ * SC, qp + d0, qs.s,
                                      Sq - q0, D - d0, vecb, tid);
    load_tile<float, kBKf, kKCf, SC>(Ks + st * kBKf * SC,
                                     kp + (int64_t)k0 * ks.s + d0, ks.s,
                                     Sk - k0, D - d0, vecb, tid);
    if (dc == 0)
      load_tile<float, kBKf, kDV, SV>(Vs + (kt & 1) * kBKf * SV,
                                      vp + (int64_t)k0 * vs.s + c0, vs.s,
                                      Sk - k0, D - c0, vecb, tid);
  };
  if (QRES) load_tile_rt(Qs, SQ, qp, qs.s, kBQ, DPQ, Sq - q0, D, vecb, tid);
  load_step(0);
  cp_async_commit();

  float acc[4][NC][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c][0] = acc[i][c][1] = 0.f;
  float m[4], l[4], s[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
  }

  for (int i = 0; i < nsteps; ++i) {
    if (i + 1 < nsteps) load_step(i + 1);
    cp_async_commit();
    cp_async_wait<1>();  // step i has landed
    __syncthreads();
    const int kt = i / nd, dc = i - kt * nd, st = i & 1;
    if (dc == 0) {
#pragma unroll
      for (int r = 0; r < 4; ++r) s[r][0] = s[r][1] = s[r][2] = s[r][3] = 0.f;
    }
    qk_f32<kKCf>(s, QRES ? Qs + dc * kKCf : Qs + st * kBQ * SC, SQ,
                 Ks + st * kBKf * SC, SC, row0, cg);
    if (dc == nd - 1) {
      const int k0 = kt * kBKf;
      const bool edge = (causal && k0 + kBKf - 1 > q0) || k0 + kBKf > Sk;
      softmax_f32(s, m, l, acc, Ps, q0, row0, cg, k0, edge, Sk, causal,
                  scale);
      __syncwarp();  // a row's P was written by the 8 threads of its group
      pv_f32<NC, SV>(acc, Ps, Vs + (kt & 1) * kBKf * SV, row0, cg);
    }
    __syncthreads();  // step i's slots are refilled from step i + 1 on
  }

  float* op = o + b * os.b + h * os.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float li = l[i];
    li += __shfl_xor_sync(0xffffffffu, li, 1);
    li += __shfl_xor_sync(0xffffffffu, li, 2);
    li += __shfl_xor_sync(0xffffffffu, li, 4);
    const float denom = fmaxf(li, 1e-30f);
    const int qpos = q0 + row0 + i;
    if (qpos < Sq) {
#pragma unroll
      for (int c = 0; c < NC; ++c) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int d = c0 + cg * 2 + 16 * c + e;
          if (d < D) op[(int64_t)qpos * os.s + d] = acc[i][c][e] / denom;
        }
      }
    }
  }
}

// -- launch -------------------------------------------------------------------

template <typename T>
bool aligned16(const void* p, const Strides& s, int D) {
  constexpr int E = 16 / sizeof(T);
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && s.b % E == 0 &&
         s.h % E == 0 && s.s % E == 0 && D % E == 0;
}

// Set the kernel's shared memory and launch it on grids of (x, batch,
// query block), as many as the 65,535 limit of y and z needs (one unless
// B or the query-block count passes it); return the first error.
template <typename T, typename... P, typename... A>
cudaError_t run(void (*kern)(P...), unsigned x, int B, int Sq, size_t smem,
                cudaStream_t stream, const T* q, const T* k, const T* v,
                T* o, A... rest) {
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int nqb = (Sq + kBQ - 1) / kBQ;
  for (int b0 = 0; b0 < B; b0 += kMaxGridYZ) {
    for (int z0 = 0; z0 < nqb; z0 += kMaxGridYZ) {
      const dim3 grid(x, std::min<unsigned>(kMaxGridYZ, B - b0),
                      std::min<unsigned>(kMaxGridYZ, nqb - z0));
      kern<<<grid, kThreads, smem, stream>>>(q, k, v, o, b0, nqb - 1 - z0,
                                              rest...);
    }
  }
  return cudaGetLastError();
}

template <typename T, int DP>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int Hq, int Hkv, int Sq, int Sk, int D,
                   const Strides* st, int causal, float scale,
                   cudaStream_t stream) {
  const int vec = aligned16<T>(q, st[0], D) && aligned16<T>(k, st[1], D) &&
                  aligned16<T>(v, st[2], D);
  if constexpr (sizeof(T) == 2) {
    // Q, the K and V rings, and slack to align the tiles to 1024 bytes
    const size_t smem =
        sizeof(T) * (size_t)(kBQ + 2 * kStages * kBKh) * DP + 1024;
    return run(flash_bf16<DP>, Hq, B, Sq, smem, stream,
               (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
               (const __nv_bfloat16*)v, (__nv_bfloat16*)o, Hq, Hkv, Sq, Sk,
               D, st[0], st[1], st[2], st[3], causal, scale, vec);
  } else {
    constexpr int SS = DP + 4;
    const size_t smem =
        sizeof(float) * ((size_t)(kBQ + 4 * kBKf) * SS + kBQ * kPSf);
    return run(flash_f32<DP>, Hq, B, Sq, smem, stream, (const float*)q,
               (const float*)k, (const float*)v, (float*)o, Hq, Hkv, Sq, Sk,
               D, st[0], st[1], st[2], st[3], causal, scale, vec);
  }
}

// head dims padded past 160: the wide kernels, Q resident where it fits
template <typename T>
cudaError_t launch_wide(const void* q, const void* k, const void* v, void* o,
                        int B, int Hq, int Hkv, int Sq, int Sk, int D,
                        const Strides* st, int causal, float scale,
                        cudaStream_t stream) {
  const int vec = aligned16<T>(q, st[0], D) && aligned16<T>(k, st[1], D) &&
                  aligned16<T>(v, st[2], D);
  // heads x slices of O's columns: more than 2^31 - 1 would be more than
  // 2^38 head-dim columns of q, which no card holds
  const size_t x = (size_t)Hq * ((D + kDV - 1) / kDV);
  if (x > 0x7fffffff) return cudaErrorInvalidValue;
  if constexpr (sizeof(T) == 2) {
    const size_t dpq = (D + kKCh - 1) / kKCh * kKCh;
    const bool qres = dpq <= kQResBf16;
    // Q (whole, or a ring of chunks), the K ring, two V slices, and slack
    // to align the tiles to 1024 bytes
    const size_t smem = 2 * ((qres ? kBQ * dpq : kStagesW * kBQ * kKCh) +
                             kStagesW * kBKh * kKCh + 2 * kBKh * kDV) +
                        1024;
    auto kern = qres ? flash_bf16_wide<true> : flash_bf16_wide<false>;
    return run(kern, (unsigned)x, B, Sq, smem, stream,
               (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
               (const __nv_bfloat16*)v, (__nv_bfloat16*)o, Hq, Hkv, Sq, Sk,
               D, st[0], st[1], st[2], st[3], causal, scale, vec);
  } else {
    const size_t dpq = (D + kKCf - 1) / kKCf * kKCf;
    const bool qres = dpq <= kQResF32;
    // Q (whole, or two chunks), two K chunks, two V slices, P
    const size_t smem =
        sizeof(float) * ((qres ? kBQ * (dpq + 4) : 2 * kBQ * (kKCf + 4)) +
                         2 * kBKf * (kKCf + 4) + 2 * kBKf * (kDV + 4) +
                         kBQ * kPSf);
    auto kern = qres ? flash_f32_wide<true> : flash_f32_wide<false>;
    return run(kern, (unsigned)x, B, Sq, smem, stream, (const float*)q,
               (const float*)k, (const float*)v, (float*)o, Hq, Hkv, Sq, Sk,
               D, st[0], st[1], st[2], st[3], causal, scale, vec);
  }
}

template <typename T>
cudaError_t launch_d(const void* q, const void* k, const void* v, void* o,
                     int B, int Hq, int Hkv, int Sq, int Sk, int D,
                     const Strides* st, int causal, float scale,
                     cudaStream_t stream) {
#define FA_CASE(DP)                                                        \
  case DP / 16:                                                            \
    return launch<T, DP>(q, k, v, o, B, Hq, Hkv, Sq, Sk, D, st, causal,    \
                         scale, stream);
  switch ((D + 15) / 16) {
    FA_CASE(16)
    FA_CASE(32)
    FA_CASE(48)
    FA_CASE(64)
    FA_CASE(80)
    FA_CASE(96)
    FA_CASE(112)
    FA_CASE(128)
    FA_CASE(144)
    FA_CASE(160)
  }
#undef FA_CASE
  return launch_wide<T>(q, k, v, o, B, Hq, Hkv, Sq, Sk, D, st, causal, scale,
                        stream);
}

}  // namespace

// dtype: 0 = f32, 1 = bf16.  Strides: q, k, v, o, each (batch, head, seq).
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, int B, int Hq,
    int Hkv, int Sq, int Sk, int D, int64_t qsb, int64_t qsh, int64_t qss,
    int64_t ksb, int64_t ksh, int64_t kss, int64_t vsb, int64_t vsh,
    int64_t vss, int64_t osb, int64_t osh, int64_t oss, int causal,
    int dtype, float scale, void* stream) {
  if (D < 1 || Hkv < 1 || Hq % Hkv != 0 || Sk < 1)
    return (int)cudaErrorInvalidValue;
  const Strides st[4] = {{qsb, qsh, qss}, {ksb, ksh, kss}, {vsb, vsh, vss},
                         {osb, osh, oss}};
  const cudaError_t err =
      dtype == 1
          ? launch_d<__nv_bfloat16>(q, k, v, o, B, Hq, Hkv, Sq, Sk, D, st,
                                    causal, scale, (cudaStream_t)stream)
          : launch_d<float>(q, k, v, o, B, Hq, Hkv, Sq, Sk, D, st, causal,
                            scale, (cudaStream_t)stream);
  return (int)err;
}

extern "C" const char* flash_attention_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
