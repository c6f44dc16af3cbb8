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
// past Sq are masked here, for any Sq and Sk.
//
// What bounds it on an H100: operations.  Causal prefill at B = 2, 32 heads,
// S = 2048, D = 80 does 4*B*H*D*S*(S+1)/2 = 43 GFLOP over 84 MB of q, k, v
// and the output (bf16): 0.64 ms at the 67 TFLOP/s of f32 FMAs, 0.043 ms
// at the 989 TFLOP/s of the bf16 tensor cores, and 0.025 ms for the bytes.
//
// The simple design: one block of 256 threads per (query block of 64 rows,
// q head, batch), looping over key blocks of 64.  Q, K and V tiles are
// converted to f32 in shared memory (rows padded by one float so the row
// reads of a warp fall in distinct banks); four threads own a query row,
// each computing 16 of the 64 scores of a key block and ceil(D/4) of the D
// output columns in registers; the row max and sum go across the four
// threads by warp shuffles.  Scalar f32 FMAs throughout, no tensor cores
// and no TF32, so f32 inputs give f32 accuracy.  When causal, the loop
// stops at the first key block wholly above the diagonal.  Later work:
// `wgmma` tiles fed by TMA, and more than one block per SM at D = 128.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per inner step
constexpr int kThreads = 256;  // four threads per query row
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// NJ: output columns per thread, at least ceil(D / 4).
template <typename T, int NJ>
__global__ void __launch_bounds__(kThreads)
    flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int Hq, int Hkv,
                 int Sq, int Sk, int D, int64_t qsb, int64_t qsh, int64_t qss,
                 int64_t ksb, int64_t ksh, int64_t kss, int64_t vsb,
                 int64_t vsh, int64_t vss, int64_t osb, int64_t osh,
                 int64_t oss, int causal, float scale) {
  extern __shared__ float smem[];
  const int dp = D + 1;                 // padded row stride of Q and K
  float* Qs = smem;                     // kBQ x dp
  float* Ks = Qs + kBQ * dp;            // kBK x dp
  float* Vs = Ks + kBK * dp;            // kBK x D
  float* Ps = Vs + kBK * D;             // kBQ x (kBK + 1)

  const int b = blockIdx.z, h = blockIdx.y;
  const int q0 = blockIdx.x * kBQ;
  const int hk = h / (Hq / Hkv);
  const int tid = threadIdx.x;
  const int r = tid >> 2;     // query row within the block
  const int c4 = tid & 3;     // which quarter of the columns
  const int qpos = q0 + r;

  const T* qp = q + b * qsb + h * qsh;
  const T* kp = k + b * ksb + hk * ksh;
  const T* vp = v + b * vsb + hk * vsh;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int row = i / D, d = i - row * D;
    const int qi = q0 + row;
    Qs[row * dp + d] = qi < Sq ? to_f32(qp[qi * qss + d]) : 0.f;
  }

  float acc[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) acc[j] = 0.f;
  float m = kNegInf, l = 0.f;

  // keys at or past q0 + kBQ are above every row of this block
  const int kend = causal ? min(Sk, q0 + kBQ) : Sk;
  for (int k0 = 0; k0 < kend; k0 += kBK) {
    __syncthreads();  // the previous step is done with Ks, Vs and Ps
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int row = i / D, d = i - row * D;
      const int ki = k0 + row;
      const bool ok = ki < Sk;
      Ks[row * dp + d] = ok ? to_f32(kp[ki * kss + d]) : 0.f;
      Vs[row * D + d] = ok ? to_f32(vp[ki * vss + d]) : 0.f;
    }
    __syncthreads();

    float s[kBK / 4];
#pragma unroll
    for (int j = 0; j < kBK / 4; ++j) s[j] = 0.f;
    for (int d = 0; d < D; ++d) {
      const float qv = Qs[r * dp + d];
#pragma unroll
      for (int j = 0; j < kBK / 4; ++j)
        s[j] = fmaf(qv, Ks[(c4 + 4 * j) * dp + d], s[j]);
    }
    float mx = kNegInf;
#pragma unroll
    for (int j = 0; j < kBK / 4; ++j) {
      const int kpos = k0 + c4 + 4 * j;
      const bool valid = kpos < Sk && (!causal || qpos >= kpos);
      s[j] = valid ? s[j] * scale : kNegInf;
      mx = fmaxf(mx, s[j]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m, mx);
    const float corr = expf(m - m_new);
    float rs = 0.f;
#pragma unroll
    for (int j = 0; j < kBK / 4; ++j) {
      const float p = expf(s[j] - m_new);
      Ps[r * (kBK + 1) + c4 + 4 * j] = p;
      rs += p;
    }
    rs += __shfl_xor_sync(0xffffffffu, rs, 1);
    rs += __shfl_xor_sync(0xffffffffu, rs, 2);
    l = l * corr + rs;
    m = m_new;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[j] *= corr;
    __syncwarp();  // a row's four threads share one warp
    for (int c = 0; c < kBK; ++c) {
      const float p = Ps[r * (kBK + 1) + c];
      const float* vr = Vs + c * D;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int d = c4 + 4 * j;
        if (d < D) acc[j] = fmaf(p, vr[d], acc[j]);
      }
    }
  }

  if (qpos < Sq) {
    const float denom = fmaxf(l, 1e-30f);
    T* op = o + b * osb + h * osh + qpos * oss;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = c4 + 4 * j;
      if (d < D) store(op + d, acc[j] / denom);
    }
  }
}

template <typename T, int NJ>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int Hq, int Hkv, int Sq, int Sk, int D,
                   const int64_t* st, int causal, float scale,
                   cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((size_t)(kBQ + kBK) * (D + 1) + (size_t)kBK * D +
                       (size_t)kBQ * (kBK + 1));
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, NJ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + kBQ - 1) / kBQ, Hq, B);
  flash_kernel<T, NJ><<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, Hq, Hkv, Sq, Sk, D,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9],
      st[10], st[11], causal, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const void* q, const void* k, const void* v, void* o,
                     int B, int Hq, int Hkv, int Sq, int Sk, int D,
                     const int64_t* st, int causal, float scale,
                     cudaStream_t stream) {
  const int nj = (D + 3) / 4;
  if (nj <= 8)
    return launch<T, 8>(q, k, v, o, B, Hq, Hkv, Sq, Sk, D, st, causal, scale,
                        stream);
  if (nj <= 16)
    return launch<T, 16>(q, k, v, o, B, Hq, Hkv, Sq, Sk, D, st, causal,
                         scale, stream);
  if (nj <= 20)
    return launch<T, 20>(q, k, v, o, B, Hq, Hkv, Sq, Sk, D, st, causal,
                         scale, stream);
  return launch<T, 32>(q, k, v, o, B, Hq, Hkv, Sq, Sk, D, st, causal, scale,
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
  if (D < 1 || D > 128 || Hkv < 1 || Hq % Hkv != 0 || Sk < 1)
    return (int)cudaErrorInvalidValue;
  const int64_t st[12] = {qsb, qsh, qss, ksb, ksh, kss,
                          vsb, vsh, vss, osb, osh, oss};
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
