// The cache-hierarchy engine: private L2s + sliced, shared LLC/directory
// with back-invalidation, one access per step, in one of two modes.
//
// Replaces the JAX engine (not a Pallas kernel): the `lax.scan` of
// `_access_one` in src/repro/core/cachesim.py:170-333 behind its four
// entry points `access_stream` (:235), `access_streams_committed` (:241),
// `access_streams_batched` (:294) and `access_streams_batched_multi`
// (:319).  Every step, as in the reference:
//   clock += 1; under random replacement the xorshift rng advances and
//   rand_bits = rng >> 1 (both also on -1 padding steps);
//   a -1 block is padding: latency 0, no state change;
//   otherwise the issuing core's L2 row is touched (prober accesses only),
//   the domain's LLC row (slice = slice_hash(block)) is touched with the
//   same rand_bits, and under an inclusive hierarchy the LLC victim is
//   invalidated from every L2 of the domain; latency 14 / 50 / 200 for an
//   L2 hit / LLC hit / miss.
//
// Commit mode (B == 1): guest g runs its (T,) stream against its own state
// and writes state, clock and rng back in place (`access_stream` with
// G == 1, `access_streams_committed`).  Cores and co-tenant flags are per
// step: (G, T).
// Measure mode: every (guest g, lane b) first copies guest g's state into
// its own slice of scratch (allocated by the wrapper), forks the rng as
// rng + salt * 0x7F4A7C15 + b * 0x9E3779B1 (mod 2^32), and runs T steps on
// that copy; nothing is written back (`access_streams_batched`,
// `access_streams_batched_multi`).  Cores and co-tenant flags are per
// lane: (G, B).
//
// What bounds it on an H100.  Bytes: the blocks read and latencies written
// (8*G*B*T bytes), plus, in measure mode, one read and one write of the
// lane's state copy (skylake_sp's scaled geometry: 96 KB a lane; the
// paper's Table 1 geometry: 3.9 MB a lane, so 1 GB for 256 lanes, about
// 0.6 ms at 3.35 TB/s).  Operations: about W compares per level per step.
// Neither is the limit at the main path's shapes: each lane is a chain of
// T dependent steps (step t+1 may read the row step t wrote), each of which
// is a handful of dependent global-memory round trips (L2 row, LLC row,
// back-invalidation rows).  The floor is T times that latency.
//
// The simple design: one block per (guest, lane).  In measure mode all
// 256 threads of the block copy the state; then one thread runs the T
// steps, calling the shared `lru_touch` (lru_touch.cuh) on each level's row
// with the step's rand_bits (-1 under LRU).  Lanes run in parallel on the
// SMs.  Copying only the rows a lane touches is left to later work.
#include <cuda_runtime.h>

#include <cstdint>

#include "lru_touch.cuh"

namespace {

struct EngineArgs {
  const int* l2_tags;  // (G, n_cores, l2_sets, l2_ways) source states
  const int* l2_age;
  const int* llc_tags;  // (G, n_domains, n_slices, llc_sets, llc_ways)
  const int* llc_age;
  int* clock;    // (G,)
  int64_t* rng;  // (G,) uint32 values held in int64
  int* w_l2_tags;  // working states: the sources in commit mode,
  int* w_l2_age;   // (G * B, ...) scratch in measure mode
  int* w_llc_tags;
  int* w_llc_age;
  const int* blocks;        // (G, B, T), -1 padded
  const int* cores;         // commit: (G, T); measure: (G, B)
  const uint8_t* cotenant;  // same layout as cores
  const int64_t* salts;     // (G,) measure mode only
  int* lat;                 // (G, B, T)
  int G, B, T;
  int n_cores, cores_per_domain, n_domains;
  int l2_sets, l2_ways, llc_sets, llc_ways, llc_slices;
  uint32_t slice_seed;
  int random, inclusive, commit;
};

__device__ __forceinline__ int slice_hash(int blk, int n_slices,
                                          uint32_t seed) {
  if (n_slices == 1) return 0;
  uint32_t x = (uint32_t)blk * seed;
  x ^= x >> 13;
  x *= 0x85EBCA6Bu;
  x ^= x >> 16;
  return (int)(x % (uint32_t)n_slices);
}

__global__ void cachesim_engine_kernel(const EngineArgs a) {
  const int lane = blockIdx.x;  // g * B + b
  const int g = lane / a.B;
  const int b = lane % a.B;
  const size_t l2n = (size_t)a.n_cores * a.l2_sets * a.l2_ways;
  const size_t llcn =
      (size_t)a.n_domains * a.llc_slices * a.llc_sets * a.llc_ways;
  int* l2t = a.w_l2_tags + (size_t)lane * l2n;
  int* l2a = a.w_l2_age + (size_t)lane * l2n;
  int* llt = a.w_llc_tags + (size_t)lane * llcn;
  int* lla = a.w_llc_age + (size_t)lane * llcn;
  if (!a.commit) {
    const int* s2t = a.l2_tags + (size_t)g * l2n;
    const int* s2a = a.l2_age + (size_t)g * l2n;
    const int* slt = a.llc_tags + (size_t)g * llcn;
    const int* sla = a.llc_age + (size_t)g * llcn;
    for (size_t i = threadIdx.x; i < l2n; i += blockDim.x) {
      l2t[i] = s2t[i];
      l2a[i] = s2a[i];
    }
    for (size_t i = threadIdx.x; i < llcn; i += blockDim.x) {
      llt[i] = slt[i];
      lla[i] = sla[i];
    }
    __syncthreads();
  }
  if (threadIdx.x != 0) return;

  uint32_t rng = (uint32_t)a.rng[g];
  int clk = a.clock[g];
  if (!a.commit)
    rng = rng + (uint32_t)a.salts[g] * 0x7F4A7C15u + (uint32_t)b * 0x9E3779B1u;
  const int* blocks = a.blocks + (size_t)lane * a.T;
  int* lat = a.lat + (size_t)lane * a.T;
  for (int t = 0; t < a.T; ++t) {
    clk += 1;
    int rand_bits = -1;
    if (a.random) {
      rng ^= rng << 13;
      rng ^= rng >> 17;
      rng ^= rng << 5;
      rand_bits = (int)(rng >> 1);
    }
    const int blk = blocks[t];
    if (blk < 0) {
      lat[t] = 0;
      continue;
    }
    const size_t who = a.commit ? (size_t)g * a.T + t : (size_t)lane;
    const int core = a.cores[who];
    const bool cotenant = a.cotenant[who] != 0;
    const int domain = core / a.cores_per_domain;

    int l2_hit = 0;
    if (!cotenant) {
      const size_t row = ((size_t)core * a.l2_sets + blk % a.l2_sets) *
                         a.l2_ways;
      l2_hit = lru_touch(l2t + row, l2a + row, a.l2_ways, blk, clk,
                         rand_bits).hit;
    }
    const int slice = slice_hash(blk, a.llc_slices, a.slice_seed);
    const size_t lrow =
        (((size_t)domain * a.llc_slices + slice) * a.llc_sets +
         blk % a.llc_sets) * a.llc_ways;
    const LruTouch llc = lru_touch(llt + lrow, lla + lrow, a.llc_ways, blk,
                                   clk, rand_bits);
    if (a.inclusive && llc.victim >= 0) {
      const int vset = llc.victim % a.l2_sets;
      const int c0 = domain * a.cores_per_domain;
      for (int c = c0; c < c0 + a.cores_per_domain; ++c) {
        int* row = l2t + ((size_t)c * a.l2_sets + vset) * a.l2_ways;
        for (int w = 0; w < a.l2_ways; ++w)
          if (row[w] == llc.victim) row[w] = -1;
      }
    }
    lat[t] = l2_hit ? 14 : (llc.hit ? 50 : 200);
  }
  if (a.commit) {
    a.clock[g] = clk;
    a.rng[g] = (int64_t)rng;
  }
}

}  // namespace

extern "C" int cachesim_engine_launch(
    const void* l2_tags, const void* l2_age, const void* llc_tags,
    const void* llc_age, void* clock, void* rng, void* w_l2_tags,
    void* w_l2_age, void* w_llc_tags, void* w_llc_age, const void* blocks,
    const void* cores, const void* cotenant, const void* salts, void* lat,
    int G, int B, int T, int n_cores, int cores_per_domain, int n_domains,
    int l2_sets, int l2_ways, int llc_sets, int llc_ways, int llc_slices,
    unsigned int slice_seed, int random, int inclusive, int commit,
    void* stream) {
  EngineArgs a;
  a.l2_tags = (const int*)l2_tags;
  a.l2_age = (const int*)l2_age;
  a.llc_tags = (const int*)llc_tags;
  a.llc_age = (const int*)llc_age;
  a.clock = (int*)clock;
  a.rng = (int64_t*)rng;
  a.w_l2_tags = (int*)w_l2_tags;
  a.w_l2_age = (int*)w_l2_age;
  a.w_llc_tags = (int*)w_llc_tags;
  a.w_llc_age = (int*)w_llc_age;
  a.blocks = (const int*)blocks;
  a.cores = (const int*)cores;
  a.cotenant = (const uint8_t*)cotenant;
  a.salts = (const int64_t*)salts;
  a.lat = (int*)lat;
  a.G = G;
  a.B = B;
  a.T = T;
  a.n_cores = n_cores;
  a.cores_per_domain = cores_per_domain;
  a.n_domains = n_domains;
  a.l2_sets = l2_sets;
  a.l2_ways = l2_ways;
  a.llc_sets = llc_sets;
  a.llc_ways = llc_ways;
  a.llc_slices = llc_slices;
  a.slice_seed = slice_seed;
  a.random = random;
  a.inclusive = inclusive;
  a.commit = commit;
  const int threads = commit ? 32 : 256;
  cachesim_engine_kernel<<<G * B, threads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

extern "C" const char* cachesim_engine_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
