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
// and the state, clock and rng it ends with are guest g's
// (`access_stream` with G == 1, `access_streams_committed`).  Cores and
// co-tenant flags are per step: (G, T).
// Measure mode: every (guest g, lane b) runs T steps on its own copy of
// guest g's state with the rng forked as
// rng + salt * 0x7F4A7C15 + b * 0x9E3779B1 (mod 2^32); nothing is written
// back (`access_streams_batched`, `access_streams_batched_multi`).  Cores
// and co-tenant flags are per lane: (G, B).
//
// What bounds it on an H100.  Not bytes: the blocks read and latencies
// written (8*G*B*T bytes) and the set rows the steps touch take
// nanoseconds at 3.35 TB/s.  Not operations: about 2 W compares per level
// per step.  Each lane is a chain of T dependent steps (step t+1 may read
// the row step t wrote), so the floor is T times the latency of one step.
// The first design (one thread per lane walking each W-way row in device
// memory, the lane's whole state first copied to device-memory scratch)
// took about 1.07 us a step on the main path: a chain of L1/L2 round
// trips and of `%` divisions.  This design shortens the step:
//   * one block per (guest, lane); its first warp runs the steps and
//     shares each row: lane l holds ways l, l + 32, ..., and a touch is
//     `lru_touch_warp`'s three phases (lru_touch.cuh: votes, minimum
//     reductions, one write) instead of a W-long chain of loads.  The L2
//     and LLC touches of a step run phase by phase side by side, so their
//     warp votes overlap.  Every access to way w is lane w's, the
//     back-invalidation's too (lane w clears way w of the domain's rows),
//     so rows held in registers need no warp barrier;
//   * what a step needs that does not depend on the state (slice hash,
//     sets, row ids) is computed for 32 steps at once, one step a lane, a
//     chunk ahead, with divisions by invariant integers (`FastDiv`) in
//     place of `%`, and handed to the steps by shuffles one step ahead;
//     the stream is read two chunks ahead, and the latencies leave 32 at
//     a time.
// Where the rows live is chosen by the wrapper from the geometry
// (`cachesim._engine_plan`), not by a failed launch:
//   * shared (every registered platform: 56-96 KB): the block stages the
//     guest's whole L2 and LLC state into dynamic shared memory with
//     cp.async, all threads, so every step reads shared memory.  Measure
//     mode needs no scratch; commit mode writes the state back at the end;
//   * touch (the paper's Table 1 geometry, 3.87 MB, or any state that does
//     not fit): commit mode works in place in device memory.  Measure mode
//     copies a row from the guest's state into the lane's compact pool the
//     first time the lane touches it, through a row -> slot table (in
//     shared memory where it fits, else per lane in device memory); a row
//     that back-invalidation only reads is not copied.  A lane copies at
//     most (1 + cores_per_domain) L2 rows and 1 LLC row a step, which is
//     how the wrapper sizes the pool.
#include <cuda_runtime.h>

#include <cstdint>

#include "lru_touch.cuh"

namespace {

constexpr int kStageThreads = 256;

// x / d and x % d for any uint32 x by a multiply and shifts (division by
// an invariant integer, Granlund and Montgomery), made on the host: the
// set, slice, domain and way indices of a step cost a few instructions
// instead of `%`'s tens.
struct FastDiv {
  uint32_t d, m;
  int s;
  __device__ __forceinline__ uint32_t div(uint32_t x) const {
    const uint32_t t = __umulhi(x, m);
    return d == 1 ? x : (t + ((x - t) >> 1)) >> s;
  }
  __device__ __forceinline__ uint32_t mod(uint32_t x) const {
    return x - div(x) * d;
  }
};

FastDiv fast_div(uint32_t d) {
  int l = 0;
  while (((uint64_t)1 << l) < d) ++l;  // ceil(log2 d)
  FastDiv f;
  f.d = d;
  f.m = (uint32_t)((((uint64_t)1 << 32) * (((uint64_t)1 << l) - d)) / d + 1);
  f.s = l > 0 ? l - 1 : 0;
  return f;
}

struct EngineArgs {
  int* l2_tags;  // (G, n_cores, l2_sets, l2_ways) the guests' states,
  int* l2_age;   // changed in place only by the touch design's commit mode
  int* llc_tags;  // (G, n_domains, n_slices, llc_sets, llc_ways)
  int* llc_age;
  int* clock;    // (G,)
  int64_t* rng;  // (G,) uint32 values held in int64
  int* pool_l2_tags;   // touch design, measure mode: (G * B, l2_pool_rows,
  int* pool_l2_age;    // l2_ways) and (G * B, llc_pool_rows, llc_ways)
  int* pool_llc_tags;
  int* pool_llc_age;
  int* table;          // touch, measure, table in device memory:
                       // (G * B, n_l2_rows + n_llc_rows)
  int* rows_copied;    // touch, measure: (G * B, 2) or null
  const int* blocks;        // (G, B, T), -1 padded
  const int* cores;         // commit: (G, T); measure: (G, B)
  const uint8_t* cotenant;  // same layout as cores
  const int64_t* salts;     // (G,) measure mode only
  int* lat;                 // (G, B, T)
  int G, B, T;
  int n_cores, cores_per_domain, n_domains;
  int l2_sets, l2_ways, llc_sets, llc_ways, llc_slices;
  FastDiv by_l2_sets, by_llc_sets, by_slices, by_cpd, by_l2_ways,
      by_llc_ways;
  uint32_t slice_seed;
  int random, inclusive, commit;
  int shared_state;  // 1: state staged in shared memory; 0: touch design
  int table_shared;  // touch, measure: the table in shared memory
  int l2_pool_rows, llc_pool_rows;
};

__device__ __forceinline__ int slice_hash(int blk, const FastDiv& n_slices,
                                          uint32_t seed) {
  uint32_t x = (uint32_t)blk * seed;
  x ^= x >> 13;
  x *= 0x85EBCA6Bu;
  x ^= x >> 16;
  return (int)n_slices.mod(x);  // 0 for one slice
}

__host__ __device__ __forceinline__ size_t pad4(size_t n) {
  return (n + 3) & ~(size_t)3;
}

// Block-wide copy of n ints from device memory into shared memory: 16-byte
// cp.async copies, all in flight at once, where both sides are 16-byte
// aligned; element by element otherwise.  The caller waits (cp.async
// .wait_all) and syncs the block.
__device__ void stage_in(int* dst, const int* src, size_t n) {
  if ((((uintptr_t)dst | (uintptr_t)src) & 15) == 0) {
    const size_t n4 = n >> 2;
    for (size_t i = threadIdx.x; i < n4; i += blockDim.x) {
      const unsigned d = (unsigned)__cvta_generic_to_shared(dst + 4 * i);
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                   "l"(src + 4 * i)
                   : "memory");
    }
    for (size_t i = 4 * n4 + threadIdx.x; i < n; i += blockDim.x)
      dst[i] = src[i];
  } else {
    for (size_t i = threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
  }
}

// Block-wide copy of n ints back to device memory (16-byte stores where
// both sides are aligned).
__device__ void stage_out(int* dst, const int* src, size_t n) {
  if ((((uintptr_t)dst | (uintptr_t)src) & 15) == 0) {
    const size_t n4 = n >> 2;
    for (size_t i = threadIdx.x; i < n4; i += blockDim.x)
      reinterpret_cast<int4*>(dst)[i] = reinterpret_cast<const int4*>(src)[i];
    for (size_t i = 4 * n4 + threadIdx.x; i < n; i += blockDim.x)
      dst[i] = src[i];
  } else {
    for (size_t i = threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
  }
}

// Where one lane's rows live.  Level 0 is the L2, level 1 the LLC; a row
// is (core, set) or (domain, slice, set) flattened.  Without `cow` the
// rows are the state itself (shared memory, or the guest's state in place)
// and row r starts at r * W.  With `cow` (touch design, measure mode) they
// are the lane's pool, reached through `slot`.
struct Work {
  int* t[2];
  int* a[2];
  const int* src_t[2];  // cow: the guest's state
  const int* src_a[2];
  int* slot[2];         // cow: row -> pool slot, -1 before the first touch
  int W[2];
  int used[2];          // cow: pool rows taken
  bool cow;

  // Bind `row` to row r of level lv.  Under cow, a row not yet in the pool
  // is copied there when the touch may write it (`write`), and otherwise
  // read from the guest's state (a touch of blk -1 writes nothing).
  // Warp-uniform arguments.
  template <class Row>
  __device__ __forceinline__ void bind(Row& row, int lv, int r, bool write) {
    const int Wl = W[lv];
    if (!cow) {
      row.bind(t[lv] + (size_t)r * Wl, a[lv] + (size_t)r * Wl, Wl);
      return;
    }
    int s = slot[lv][r];
    if (s >= 0) {
      row.bind(t[lv] + (size_t)s * Wl, a[lv] + (size_t)s * Wl, Wl);
      return;
    }
    const int* st = src_t[lv] + (size_t)r * Wl;
    const int* sa = src_a[lv] + (size_t)r * Wl;
    if (!write) {
      row.bind(const_cast<int*>(st), const_cast<int*>(sa), Wl);
      return;
    }
    s = used[lv]++;
    row.bind_copy(st, sa, t[lv] + (size_t)s * Wl, a[lv] + (size_t)s * Wl,
                  Wl);
    if (warp_lane() == 0) slot[lv][r] = s;
  }
};

// Invalidate `victim` from the L2 rows (c, vset) of the domain's cores.
// Without cow, lane w looks at way w (w + 32, ...) of every such row: the
// lane that holds the way in a touch, so a register row stays lane-owned.
__device__ __forceinline__ void back_invalidate(Work& w, const EngineArgs& a,
                                               int domain, int victim) {
  const int vset = (int)a.by_l2_sets.mod((uint32_t)victim);
  const int c0 = domain * a.cores_per_domain;
  const int W2 = a.l2_ways;
  if (!w.cow) {
    for (int way = warp_lane(); way < W2; way += 32)
      for (int c = c0; c < c0 + a.cores_per_domain; ++c) {
        int* x = w.t[0] + ((size_t)c * a.l2_sets + vset) * W2 + way;
        if (*x == victim) *x = -1;
      }
    return;
  }
  for (int c = c0; c < c0 + a.cores_per_domain; ++c) {
    const int r = c * a.l2_sets + vset;
    const int s = w.slot[0][r];
    const int* rt =
        s >= 0 ? w.t[0] + (size_t)s * W2 : w.src_t[0] + (size_t)r * W2;
    unsigned found = 0;
    for (int k = 0; 32 * k < W2; ++k) {
      const int way = 32 * k + warp_lane();
      found |= __ballot_sync(kFullWarp, way < W2 && rt[way] == victim);
    }
    if (!found) continue;  // only read: no copy
    MemRow row;
    w.bind(row, 0, r, true);
    for (int way = warp_lane(); way < W2; way += 32)
      if (row.mt[way] == victim) row.mt[way] = -1;
    __syncwarp();
  }
}

// What a step needs that does not depend on the state.  Each lane
// prepares the step it holds of a 32-step chunk, so the hashing and
// division for 32 steps run once, spread over the warp's lanes.
struct Access {
  int blk;     // -1: padding
  int r2, r3;  // its L2 and LLC rows
  int dc;      // domain * 2 + 1 if a co-tenant access (no L2 touch)
};

__device__ __forceinline__ Access prepare(const EngineArgs& a, int blk,
                                          int core, int cot) {
  const uint32_t ub = (uint32_t)max(blk, 0);
  const int domain = (int)a.by_cpd.div((uint32_t)core);
  Access x;
  x.blk = blk;
  x.r2 = core * a.l2_sets + (int)a.by_l2_sets.mod(ub);
  x.r3 = (domain * a.llc_slices +
          slice_hash((int)ub, a.by_slices, a.slice_seed)) *
             a.llc_sets +
         (int)a.by_llc_sets.mod(ub);
  x.dc = 2 * domain + (cot != 0);
  return x;
}

// The T steps of one lane, by the block's first warp.  The stream comes 32
// steps at a time, one step a lane: read two chunks ahead, prepared one
// chunk ahead, and handed to the steps by shuffles, one step ahead.
template <class Row>
__device__ __forceinline__ void run_lane(Work& w, const EngineArgs& a, int g,
                                         int b, int lid) {
  const int lane = warp_lane();
  uint32_t rng = (uint32_t)a.rng[g];
  int clk = a.clock[g];
  if (!a.commit)
    rng = rng + (uint32_t)a.salts[g] * 0x7F4A7C15u + (uint32_t)b * 0x9E3779B1u;
  const int* blocks = a.blocks + (size_t)lid * a.T;
  int* lat = a.lat + (size_t)lid * a.T;
  // commit: cores and co-tenant flags per step, read with the blocks
  const int* cores = a.cores + (size_t)g * a.T;
  const uint8_t* cots = a.cotenant + (size_t)g * a.T;
  const int lane_core = a.commit ? 0 : a.cores[lid];
  const int lane_cot = a.commit ? 0 : a.cotenant[lid];
  int rb, rc, rt;  // the chunk after next, raw
  auto read = [&](int t) {
    rb = -1;
    rc = lane_core;
    rt = lane_cot;
    if (t < a.T) {
      rb = blocks[t];
      if (a.commit) {
        rc = cores[t];
        rt = cots[t];
      }
    }
  };
  read(lane);
  Access cur = prepare(a, rb, rc, rt);  // this chunk
  read(32 + lane);
  Access nxt = prepare(a, rb, rc, rt);  // the next
  read(64 + lane);
  // step t0 + j of the chunk at t0, j in [0, 32]
  auto step_of = [&](int j) {
    const int src = j & 31;
    const bool here = j < 32;
    Access x;
    x.blk = __shfl_sync(kFullWarp, here ? cur.blk : nxt.blk, src);
    x.r2 = __shfl_sync(kFullWarp, here ? cur.r2 : nxt.r2, src);
    x.r3 = __shfl_sync(kFullWarp, here ? cur.r3 : nxt.r3, src);
    x.dc = __shfl_sync(kFullWarp, here ? cur.dc : nxt.dc, src);
    return x;
  };
  const bool rnd = a.random;
  const bool sync = !Row::kLaneOwned || w.cow;
  Access s = step_of(0);
  for (int t0 = 0; t0 < a.T; t0 += 32) {
    const int n = min(32, a.T - t0);
    int my_lat = 0;
    for (int j = 0; j < n; ++j) {
      clk += 1;
      int rand2 = -1, rand3 = -1;  // the ways random replacement evicts
      if (rnd) {
        rng ^= rng << 13;
        rng ^= rng >> 17;
        rng ^= rng << 5;
        rand2 = (int)a.by_l2_ways.mod(rng >> 1);  // rand_bits = rng >> 1
        rand3 = (int)a.by_llc_ways.mod(rng >> 1);
      }
      Access next;
      if (s.blk < 0) {  // padding: latency 0
        next = step_of(j + 1);
      } else {
        // the two touches, phase by phase, so their votes overlap
        const bool cot = s.dc & 1;
        Row l2, llc;
        w.bind(l2, 0, s.r2, !cot);
        w.bind(llc, 1, s.r3, true);
        const int b2 = cot ? -1 : s.blk;
        const WarpScan x2 = warp_scan(l2, a.l2_ways, b2);
        const WarpScan x3 = warp_scan(llc, a.llc_ways, s.blk);
        const int w2 = warp_choose<Row>(x2, a.l2_ways, rand2);
        const int w3 = warp_choose<Row>(x3, a.llc_ways, rand3);
        const int l2_hit = warp_write(l2, x2, w2, b2, clk).hit;
        const LruTouch res = warp_write(llc, x3, w3, s.blk, clk);
        next = step_of(j + 1);  // in the same basic block as the touches
        if (sync) __syncwarp();
        if (a.inclusive && res.victim >= 0) {
          back_invalidate(w, a, s.dc >> 1, res.victim);
          if (sync) __syncwarp();
        }
        if (lane == j) my_lat = l2_hit ? 14 : (res.hit ? 50 : 200);
      }
      s = next;
    }
    if (t0 + lane < a.T) lat[t0 + lane] = my_lat;
    cur = nxt;
    nxt = prepare(a, rb, rc, rt);
    read(t0 + 96 + lane);
  }
  if (lane == 0) {
    if (a.commit) {
      a.clock[g] = clk;
      a.rng[g] = (int64_t)rng;
    } else if (w.cow && a.rows_copied) {
      a.rows_copied[2 * (size_t)lid] = w.used[0];
      a.rows_copied[2 * (size_t)lid + 1] = w.used[1];
    }
  }
}

// kShared: the state staged in shared memory (the rows' address space is
// then known, so a step reads them with shared-memory loads).
template <class Row, bool kShared>
__global__ void cachesim_engine_kernel(const EngineArgs a) {
  extern __shared__ __align__(16) int smem[];
  const int lid = blockIdx.x;  // g * B + b
  const int g = lid / a.B;
  const int b = lid % a.B;
  const size_t l2n = (size_t)a.n_cores * a.l2_sets * a.l2_ways;
  const size_t llcn =
      (size_t)a.n_domains * a.llc_slices * a.llc_sets * a.llc_ways;
  const int n_l2_rows = a.n_cores * a.l2_sets;
  const int n_llc_rows = a.n_domains * a.llc_slices * a.llc_sets;
  int* const gs[4] = {a.l2_tags + g * l2n, a.l2_age + g * l2n,
                      a.llc_tags + g * llcn, a.llc_age + g * llcn};
  Work w;
  w.W[0] = a.l2_ways;
  w.W[1] = a.llc_ways;
  w.used[0] = w.used[1] = 0;
  w.cow = !kShared && !a.commit;
  if (kShared) {
    w.t[0] = smem;
    w.a[0] = smem + pad4(l2n);
    w.t[1] = smem + 2 * pad4(l2n);
    w.a[1] = w.t[1] + pad4(llcn);
    stage_in(w.t[0], gs[0], l2n);
    stage_in(w.a[0], gs[1], l2n);
    stage_in(w.t[1], gs[2], llcn);
    stage_in(w.a[1], gs[3], llcn);
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
  } else if (a.commit) {
    w.t[0] = gs[0];
    w.a[0] = gs[1];
    w.t[1] = gs[2];
    w.a[1] = gs[3];
  } else {
    w.src_t[0] = gs[0];
    w.src_a[0] = gs[1];
    w.src_t[1] = gs[2];
    w.src_a[1] = gs[3];
    const size_t p2 = (size_t)a.l2_pool_rows * a.l2_ways;
    const size_t p3 = (size_t)a.llc_pool_rows * a.llc_ways;
    w.t[0] = a.pool_l2_tags + lid * p2;
    w.a[0] = a.pool_l2_age + lid * p2;
    w.t[1] = a.pool_llc_tags + lid * p3;
    w.a[1] = a.pool_llc_age + lid * p3;
    const int n_rows = n_l2_rows + n_llc_rows;
    int* table = a.table_shared ? smem : a.table + (size_t)lid * n_rows;
    for (int i = threadIdx.x; i < n_rows; i += blockDim.x) table[i] = -1;
    w.slot[0] = table;
    w.slot[1] = table + n_l2_rows;
    __syncthreads();
  }
  if (threadIdx.x < 32) run_lane<Row>(w, a, g, b, lid);
  if (kShared && a.commit) {
    __syncthreads();
    stage_out(gs[0], w.t[0], l2n);
    stage_out(gs[1], w.a[0], l2n);
    stage_out(gs[2], w.t[1], llcn);
    stage_out(gs[3], w.a[1], llcn);
  }
}

template <class Row, bool kShared>
int launch(const EngineArgs& a, int shared_bytes, cudaStream_t stream) {
  auto kernel = cachesim_engine_kernel<Row, kShared>;
  if (shared_bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, shared_bytes);
    if (err != cudaSuccess) return (int)err;
  }
  // one warp runs the steps; the others only stage state or clear the table
  const int threads = (kShared || !a.commit) ? kStageThreads : 32;
  kernel<<<a.G * a.B, threads, shared_bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

template <class Row>
int launch(const EngineArgs& a, int shared_bytes, cudaStream_t stream) {
  return a.shared_state ? launch<Row, true>(a, shared_bytes, stream)
                        : launch<Row, false>(a, shared_bytes, stream);
}

}  // namespace

extern "C" int cachesim_engine_launch(
    const void* l2_tags, const void* l2_age, const void* llc_tags,
    const void* llc_age, void* clock, void* rng, void* pool_l2_tags,
    void* pool_l2_age, void* pool_llc_tags, void* pool_llc_age, void* table,
    void* rows_copied, const void* blocks, const void* cores,
    const void* cotenant, const void* salts, void* lat, int G, int B, int T,
    int n_cores, int cores_per_domain, int n_domains, int l2_sets,
    int l2_ways, int llc_sets, int llc_ways, int llc_slices,
    unsigned int slice_seed, int random, int inclusive, int commit,
    int shared_state, int table_shared, int l2_pool_rows, int llc_pool_rows,
    int shared_bytes, void* stream) {
  EngineArgs a;
  a.l2_tags = (int*)l2_tags;
  a.l2_age = (int*)l2_age;
  a.llc_tags = (int*)llc_tags;
  a.llc_age = (int*)llc_age;
  a.clock = (int*)clock;
  a.rng = (int64_t*)rng;
  a.pool_l2_tags = (int*)pool_l2_tags;
  a.pool_l2_age = (int*)pool_l2_age;
  a.pool_llc_tags = (int*)pool_llc_tags;
  a.pool_llc_age = (int*)pool_llc_age;
  a.table = (int*)table;
  a.rows_copied = (int*)rows_copied;
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
  a.shared_state = shared_state;
  a.table_shared = table_shared;
  a.l2_pool_rows = l2_pool_rows;
  a.llc_pool_rows = llc_pool_rows;
  a.by_l2_sets = fast_div(l2_sets);
  a.by_llc_sets = fast_div(llc_sets);
  a.by_slices = fast_div(llc_slices);
  a.by_cpd = fast_div(cores_per_domain);
  a.by_l2_ways = fast_div(l2_ways);
  a.by_llc_ways = fast_div(llc_ways);
  // rows of up to 32 ways sit in one register a lane; wider rows are read
  // from where they live
  if (l2_ways <= 32 && llc_ways <= 32)
    return launch<RegRow<1>>(a, shared_bytes, (cudaStream_t)stream);
  return launch<MemRow>(a, shared_bytes, (cudaStream_t)stream);
}

extern "C" const char* cachesim_engine_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
