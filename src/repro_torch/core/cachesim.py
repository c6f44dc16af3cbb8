"""Bit-exact set-associative cache-hierarchy simulator in PyTorch + CUDA.

The port of `repro.core.cachesim`: the "hardware" the CacheX probing
stack runs against, with the same geometry, semantics and public names
(see the JAX module for the model itself):

  * per-core private L2s; a sliced, shared LLC per domain with directory
    semantics — evicting an LLC entry back-invalidates the line from every
    L2 of the domain when ``MachineGeometry.inclusion == "inclusive"``;
  * LLC slice selection by a hidden hash of the block address;
  * true-LRU or ``random`` replacement per set.

Machine state is a dict of torch tensors on one device: ``l2`` and
``llc`` as (tags, ages) int32 pairs (-1 marks an empty way), ``clock``
(int32) and ``rng`` (the uint32 xorshift state, held in an int64).
Addresses are block addresses (HPA >> 6) as int32; ``-1`` pads streams
(padding steps still advance the clock and, under ``random``, the rng).

The engine behind the four entry points (`access_stream`,
`access_streams_committed`, `access_streams_batched`,
`access_streams_batched_multi`) has two backends, chosen by where the
state lies: on a CUDA device the hand-written kernel
``csrc/cachesim_engine.cu`` (one launch per call, counted in
``_build.LAUNCHES["cachesim_engine"]``; :func:`_engine_plan` picks from
the geometry where it keeps a lane's rows), on the CPU a plain PyTorch
loop over steps, vectorized over lanes and guests (counted in
``_build.PLAIN_CALLS["cachesim_engine"]``).  Committed calls update the
state in place (the JAX entry points donate it) and return it.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import _build, resolve_device
from repro_torch.kernels._lru import lru_touch_victim

LINE_BITS = 6   # 64-byte cache lines
PAGE_BITS = 12  # 4 kB pages
BLOCKS_PER_PAGE = 1 << (PAGE_BITS - LINE_BITS)  # 64

# Simulated access latencies (cycles) by hit level.
LAT_L2, LAT_LLC, LAT_DRAM = 14, 50, 200
# Thresholds used by probing code ("was this evicted from L2 / the LLC?").
L2_MISS_THRESHOLD = (LAT_L2 + LAT_LLC) // 2     # 32
LLC_MISS_THRESHOLD = (LAT_LLC + LAT_DRAM) // 2  # 125

_M32 = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class CacheGeometry:
    n_sets: int
    n_ways: int
    n_slices: int = 1

    @property
    def n_lines(self) -> int:
        return self.n_sets * self.n_ways * self.n_slices

    @property
    def size_bytes(self) -> int:
        return self.n_lines << LINE_BITS


# Paper Table 1 geometries.
SKYLAKE_L2 = CacheGeometry(n_sets=1024, n_ways=16)


def skylake_llc(n_slices: int = 20, n_ways: int = 11) -> CacheGeometry:
    return CacheGeometry(n_sets=2048, n_ways=n_ways, n_slices=n_slices)


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for int64 ``x`` in [0, 2**32) without overflowing
    int64: split ``c`` into 16-bit halves (each partial product < 2**48)."""
    c &= _M32
    lo = x * (c & 0xFFFF)
    hi = (x * (c >> 16)) & 0xFFFF
    return (lo + (hi << 16)) & _M32


def slice_hash(block_addr: torch.Tensor, n_slices: int,
               seed: int = 0x9E3779B9) -> torch.Tensor:
    """Balanced hidden hash of the block address -> LLC slice id (int32).

    The uint32 xorshift-multiply mix of `repro.core.cachesim.slice_hash`,
    in int64 arithmetic masked to 32 bits (``csrc/cachesim_engine.cu``
    computes the same in ``uint32_t``).
    """
    if n_slices == 1:
        return torch.zeros_like(block_addr, dtype=torch.int32)
    x = block_addr.to(torch.int64) & _M32
    x = _mul32(x, seed)
    x = x ^ (x >> 13)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 16)
    return torch.remainder(x, n_slices).to(torch.int32)


@dataclasses.dataclass(frozen=True)
class MachineGeometry:
    """`n_domains` LLC domains, each with `cores_per_domain` private-L2 cores.

    ``inclusion`` selects the hierarchy variant: ``"inclusive"`` (evicting
    an LLC/directory entry back-invalidates the line from every private L2
    of the domain) or ``"non_inclusive"`` (L2-resident lines survive).
    """

    n_domains: int = 1
    cores_per_domain: int = 2
    l2: CacheGeometry = SKYLAKE_L2
    llc: CacheGeometry = dataclasses.field(default_factory=lambda: skylake_llc(4))
    replacement: str = "lru"  # "lru" | "random"
    slice_seed: int = 0x9E3779B9
    inclusion: str = "inclusive"  # "inclusive" | "non_inclusive"

    @property
    def n_cores(self) -> int:
        return self.n_domains * self.cores_per_domain


def init_machine(geom: MachineGeometry, device=None) -> Dict:
    """A cold machine on ``device`` (None: the CUDA card)."""
    dev = resolve_device(device)
    l2 = (geom.n_cores, geom.l2.n_sets, geom.l2.n_ways)
    llc = (geom.n_domains, geom.llc.n_slices, geom.llc.n_sets,
           geom.llc.n_ways)
    return {
        "l2": (torch.full(l2, -1, dtype=torch.int32, device=dev),
               torch.zeros(l2, dtype=torch.int32, device=dev)),
        "llc": (torch.full(llc, -1, dtype=torch.int32, device=dev),
                torch.zeros(llc, dtype=torch.int32, device=dev)),
        "clock": torch.zeros((), dtype=torch.int32, device=dev),
        "rng": torch.tensor(0x12345678, dtype=torch.int64, device=dev),
    }


def state_from_numpy(d: Dict, device=None) -> Dict:
    """A machine state from numpy arrays laid out as the JAX package's
    (``{"l2": (tags, age), "llc": (tags, age), "clock", "rng"}``, with or
    without a leading guest axis), on ``device`` (None: the CUDA card)."""
    dev = resolve_device(device)

    def t(x, dtype):
        return torch.as_tensor(np.array(x, dtype=np.int64), dtype=dtype,
                               device=dev)
    return {"l2": tuple(t(x, torch.int32) for x in d["l2"]),
            "llc": tuple(t(x, torch.int32) for x in d["llc"]),
            "clock": t(d["clock"], torch.int32),
            "rng": t(np.asarray(d["rng"]).astype(np.uint32), torch.int64)}


def state_to_numpy(state: Dict) -> Dict:
    """The inverse of :func:`state_from_numpy`: numpy arrays with the JAX
    package's dtypes (int32, and uint32 for ``rng``)."""
    def n(x):
        return x.detach().cpu().numpy()
    return {"l2": tuple(n(x) for x in state["l2"]),
            "llc": tuple(n(x) for x in state["llc"]),
            "clock": n(state["clock"]).astype(np.int32),
            "rng": n(state["rng"]).astype(np.uint32)}


def _next_rand(rng: torch.Tensor):
    """xorshift32 step on uint32 values held in int64; returns (rng,
    rand_bits) with rand_bits = rng >> 1 (non-negative, < 2**31)."""
    rng = rng ^ ((rng << 13) & _M32)
    rng = rng ^ (rng >> 17)
    rng = rng ^ ((rng << 5) & _M32)
    return rng, rng >> 1


# Per-lane rng fork for the batched engine.  Lane 0 keeps the machine rng
# verbatim so a single-lane batched call is bit-identical to access_stream.
RNG_LANE_STRIDE = 0x9E3779B1
RNG_SALT_STRIDE = 0x7F4A7C15


# ---------------------------------------------------------------------------
# the engine: G guests x B lanes x T steps
# ---------------------------------------------------------------------------

def _single(state: Dict) -> Dict:
    """One machine state as a stacked state of one guest (views, so
    in-place updates land in ``state``)."""
    return {"l2": tuple(x.unsqueeze(0) for x in state["l2"]),
            "llc": tuple(x.unsqueeze(0) for x in state["llc"]),
            "clock": state["clock"].view(1), "rng": state["rng"].view(1)}


def _normalize(states, blocks, cores, cotenant, salts, commit):
    dev = states["clock"].device
    blocks = torch.as_tensor(blocks, dtype=torch.int32, device=dev)
    cores = torch.as_tensor(cores, dtype=torch.int32, device=dev)
    cotenant = torch.as_tensor(cotenant, dtype=torch.bool, device=dev)
    G, B, T = blocks.shape
    want = (G, T) if commit else (G, B)
    if commit and B != 1 or tuple(cores.shape) != want \
            or tuple(cotenant.shape) != want:
        raise ValueError(f"engine: blocks {tuple(blocks.shape)}, cores "
                         f"{tuple(cores.shape)}, cotenant "
                         f"{tuple(cotenant.shape)} (commit={commit})")
    if salts is not None:
        salts = torch.as_tensor(salts, dtype=torch.int64, device=dev)
    return blocks, cores, cotenant, salts


def engine(states: Dict, geom: MachineGeometry, blocks, cores, cotenant,
           salts, commit: bool) -> torch.Tensor:
    """The engine behind the four entry points: run (G, B, T) ``blocks``
    against stacked ``states`` (leading guest axis); returns (G, B, T) int32
    latencies.  ``commit``: B == 1, ``cores``/``cotenant`` are (G, T) and
    every guest's state advances in place.  Otherwise every (guest, lane)
    runs on its own copy of its guest's state with its rng forked by
    ``salts`` (G,) and the lane index, and ``cores``/``cotenant`` are
    (G, B).  On a CUDA state it launches ``csrc/cachesim_engine.cu`` (or
    raises); on a CPU state it runs :func:`engine_ref`."""
    if states["clock"].device.type == "cpu":
        return engine_ref(states, geom, blocks, cores, cotenant, salts,
                          commit)
    blocks, cores, cotenant, salts = _normalize(states, blocks, cores,
                                                cotenant, salts, commit)
    return _engine_cuda(states, geom, blocks, cores, cotenant, salts, commit)


#: the shared memory the engine's plan may give a block
SMEM_BUDGET = _build.SMEM_PER_BLOCK


@dataclasses.dataclass(frozen=True)
class EnginePlan:
    """Where ``csrc/cachesim_engine.cu`` keeps a lane's rows.

    ``design`` "shared": the block stages its guest's whole state in
    ``shared_bytes`` of shared memory (commit mode writes it back).
    "touch": the rows stay in device memory; commit mode works in place,
    measure mode copies a row into the lane's pool of ``l2_pool_rows`` /
    ``llc_pool_rows`` rows at its first touch, through a row -> slot table
    in shared memory (``table_shared``, then ``shared_bytes`` is its size)
    or in device memory."""
    design: str
    shared_bytes: int
    table_shared: bool
    l2_pool_rows: int
    llc_pool_rows: int


def _pad4(n: int) -> int:
    return (n + 3) // 4 * 4


def _engine_plan(geom: MachineGeometry, T: int, commit: bool,
                 smem_budget: int = SMEM_BUDGET) -> EnginePlan:
    """The engine's design for ``geom`` and ``T`` steps: "shared" when one
    guest's state (tags and ages, each segment padded to 16 bytes) fits in
    ``smem_budget`` bytes, else "touch", whose pools hold every row a lane
    can copy: per step one L2 row and the domain's ``cores_per_domain``
    back-invalidated ones, and one LLC row."""
    l2_rows = geom.n_cores * geom.l2.n_sets
    llc_rows = geom.n_domains * geom.llc.n_slices * geom.llc.n_sets
    state = 8 * (_pad4(l2_rows * geom.l2.n_ways)
                 + _pad4(llc_rows * geom.llc.n_ways))
    if state <= smem_budget:
        return EnginePlan("shared", state, False, 0, 0)
    if commit:
        return EnginePlan("touch", 0, False, 0, 0)
    table = 4 * (l2_rows + llc_rows)
    shared = table <= smem_budget
    return EnginePlan("touch", table if shared else 0, shared,
                      min(l2_rows, (1 + geom.cores_per_domain) * T),
                      min(llc_rows, T))


def _engine_cuda(states, geom, blocks, cores, cotenant, salts, commit, *,
                 smem_budget: int = SMEM_BUDGET,
                 rows_copied: Optional[torch.Tensor] = None):
    """Launch the engine kernel on normalized inputs, in the design
    :func:`_engine_plan` picks under ``smem_budget``.  ``rows_copied``, a
    (G * B, 2) int32 CUDA tensor, receives the L2 and LLC rows each lane
    copied (touch design, measure mode only)."""
    l2t, l2a = states["l2"]
    llt, lla = states["llc"]
    G, B, T = blocks.shape
    i32 = torch.int32
    _build.check_cuda(
        "cachesim_engine", l2t, l2a, llt, lla, states["clock"],
        states["rng"], blocks, cores, cotenant,
        dtypes=(i32, i32, i32, i32, i32, torch.int64, i32, i32, torch.bool))
    l2_shape = (G, geom.n_cores, geom.l2.n_sets, geom.l2.n_ways)
    llc_shape = (G, geom.n_domains, geom.llc.n_slices, geom.llc.n_sets,
                 geom.llc.n_ways)
    if tuple(l2t.shape) != l2_shape or tuple(l2a.shape) != l2_shape \
            or tuple(llt.shape) != llc_shape \
            or tuple(lla.shape) != llc_shape \
            or tuple(states["clock"].shape) != (G,) \
            or tuple(states["rng"].shape) != (G,):
        raise ValueError(f"cachesim_engine: state shapes do not match "
                         f"{geom} for {G} guest(s)")
    lat = torch.empty((G, B, T), dtype=i32, device=blocks.device)
    if G * B == 0:
        return lat
    if not commit:
        if salts is None or tuple(salts.shape) != (G,):
            raise ValueError("cachesim_engine: measure mode needs (G,) salts")
        _build.check_cuda("cachesim_engine", salts, dtypes=(torch.int64,))
    plan = _engine_plan(geom, T, commit, smem_budget)
    pools, table = (None,) * 4, None
    if plan.design == "touch" and not commit:   # per lane: tags, ages
        L, dev = G * B, blocks.device
        l2 = (L, plan.l2_pool_rows, geom.l2.n_ways)
        llc = (L, plan.llc_pool_rows, geom.llc.n_ways)
        pools = tuple(torch.empty(shape, dtype=i32, device=dev)
                      for shape in (l2, l2, llc, llc))
        if not plan.table_shared:
            rows = (geom.n_cores * geom.l2.n_sets + geom.n_domains
                    * geom.llc.n_slices * geom.llc.n_sets)
            table = torch.empty((L, rows), dtype=i32, device=dev)
    if rows_copied is not None:
        _build.check_cuda("cachesim_engine", rows_copied, dtypes=(i32,))
        if tuple(rows_copied.shape) != (G * B, 2):
            raise ValueError(f"cachesim_engine: rows_copied must be "
                             f"({G * B}, 2)")
    p = _build.ptr
    _build.call(
        "cachesim_engine", "cachesim_engine_launch",
        p(l2t), p(l2a), p(llt), p(lla), p(states["clock"]), p(states["rng"]),
        *(p(x) for x in pools), p(table), p(rows_copied), p(blocks),
        p(cores), p(cotenant), p(None if commit else salts), p(lat),
        G, B, T, geom.n_cores, geom.cores_per_domain, geom.n_domains,
        geom.l2.n_sets, geom.l2.n_ways, geom.llc.n_sets, geom.llc.n_ways,
        geom.llc.n_slices, geom.slice_seed & _M32,
        int(geom.replacement == "random"),
        int(geom.inclusion == "inclusive"), int(commit),
        int(plan.design == "shared"), int(plan.table_shared),
        plan.l2_pool_rows, plan.llc_pool_rows, plan.shared_bytes,
        _build.stream(blocks.device))
    _build.LAUNCHES["cachesim_engine"] += 1
    return lat


def engine_ref(states: Dict, geom: MachineGeometry, blocks, cores,
               cotenant, salts, commit: bool) -> torch.Tensor:
    """The plain PyTorch version of :func:`engine` (any device): a loop
    over steps, vectorized over the L = G * B lanes, each lane on its own
    rows of a flat row table."""
    _build.PLAIN_CALLS["cachesim_engine"] += 1
    blocks, cores, cotenant, salts = _normalize(states, blocks, cores,
                                                cotenant, salts, commit)
    G, B, T = blocks.shape
    L = G * B
    dev = blocks.device
    i64 = torch.int64
    n_cores, cpd = geom.n_cores, geom.cores_per_domain
    s2, s3, n_sl = geom.l2.n_sets, geom.llc.n_sets, geom.llc.n_slices
    l2t, l2a = states["l2"]
    llt, lla = states["llc"]
    if not commit and salts is None:
        raise ValueError("engine: measure mode needs (G,) salts")
    if commit:
        # views of the guests' own state: writes land in place
        tables = [x.view(-1, x.shape[-1]) for x in (l2t, l2a, llt, lla)]
        rng = states["rng"].to(i64)
        clock = states["clock"].to(i64)
    else:
        tables = [x.repeat_interleave(B, dim=0).reshape(-1, x.shape[-1])
                  for x in (l2t, l2a, llt, lla)]
        lane_idx = torch.arange(B, device=dev, dtype=i64).repeat(G)
        rng = (states["rng"].to(i64).repeat_interleave(B)
               + _mul32(salts.repeat_interleave(B) & _M32, RNG_SALT_STRIDE)
               + _mul32(lane_idx, RNG_LANE_STRIDE)) & _M32
        clock = states["clock"].to(i64).repeat_interleave(B)
        lane_core = cores.reshape(L).to(i64)
        lane_ct = cotenant.reshape(L)
    t2, a2, t3, a3 = tables
    rand = geom.replacement == "random"
    inclusive = geom.inclusion == "inclusive"
    lanes = torch.arange(L, device=dev, dtype=i64)
    core_ids = torch.arange(n_cores, device=dev, dtype=i64)
    core_domain = core_ids // cpd
    blk_all = blocks.reshape(L, T).to(i64)
    lat = torch.zeros((L, T), dtype=torch.int32, device=dev)
    for t in range(T):
        clock = clock + 1
        rand_bits = None
        if rand:
            rng, rand_bits = _next_rand(rng)
        blk = blk_all[:, t]
        valid = blk >= 0
        if not bool(valid.any()):
            continue
        sb = torch.where(valid, blk, 0)
        core = cores[:, t].to(i64) if commit else lane_core
        ct = cotenant[:, t] if commit else lane_ct
        prober = valid & ~ct
        domain = core // cpd

        # private L2 (prober accesses only)
        r2 = (lanes * n_cores + core) * s2 + torch.remainder(sb, s2)
        o2t, o2a = t2[r2], a2[r2]
        n2t, n2a, l2_hit, _ = lru_touch_victim(o2t, o2a, sb, clock, rand_bits)
        t2[r2] = torch.where(prober[:, None], n2t, o2t)
        a2[r2] = torch.where(prober[:, None], n2a, o2a)
        l2_hit = l2_hit & prober

        # shared LLC/directory (every valid access)
        sl = slice_hash(sb, n_sl, geom.slice_seed).to(i64)
        r3 = ((lanes * geom.n_domains + domain) * n_sl + sl) * s3 \
            + torch.remainder(sb, s3)
        o3t, o3a = t3[r3], a3[r3]
        n3t, n3a, llc_hit, victim = lru_touch_victim(o3t, o3a, sb, clock,
                                                     rand_bits)
        t3[r3] = torch.where(valid[:, None], n3t, o3t)
        a3[r3] = torch.where(valid[:, None], n3a, o3a)

        # back-invalidation of the directory victim from the domain's L2s
        if inclusive:
            victim = torch.where(valid, victim.to(i64), -1)
            has_v = victim >= 0
            if bool(has_v.any()):
                sv = torch.where(has_v, victim, 0)
                vr = (lanes[:, None] * n_cores + core_ids[None, :]) * s2 \
                    + torch.remainder(sv, s2)[:, None]          # (L, cores)
                rows = t2[vr]                                   # (L, cores, W)
                inval = ((has_v[:, None]
                          & (core_domain[None, :] == domain[:, None]))[..., None]
                         & (rows == sv[:, None, None]))
                t2[vr] = torch.where(inval, -1, rows)

        lat[:, t] = torch.where(
            ~valid, 0, torch.where(l2_hit, LAT_L2,
                                   torch.where(llc_hit, LAT_LLC, LAT_DRAM))
        ).to(torch.int32)
    if commit:
        states["clock"].copy_(clock.to(torch.int32))
        states["rng"].copy_(rng)
    return lat.view(G, B, T)


# ---------------------------------------------------------------------------
# entry points (the JAX module's four, same arguments and results)
# ---------------------------------------------------------------------------

def access_stream(state: Dict, geom: MachineGeometry, blocks, cores,
                  cotenant):
    """Run (and commit) a 1-D stream of accesses.  Returns (state,
    latencies (T,) int32); ``state`` is updated in place."""
    lats = engine(_single(state), geom, torch.as_tensor(blocks)[None, None],
                  torch.as_tensor(cores)[None], torch.as_tensor(cotenant)[None],
                  None, commit=True)
    return state, lats[0, 0]


def access_streams_committed(states: Dict, geom: MachineGeometry, blocks,
                             cores, cotenant):
    """G independent machines each run (and COMMIT) their own access stream
    in one dispatch.  ``states`` has a leading guest axis
    (:func:`stack_states`); ``blocks``/``cores``/``cotenant`` are (G, T).
    Returns (states, latencies (G, T)); each guest's lane is bit-identical
    to running its stream alone through :func:`access_stream`."""
    lats = engine(states, geom, torch.as_tensor(blocks)[:, None], cores,
                  cotenant, None, commit=True)
    return states, lats[:, 0]


def stack_states(states: List[Dict]) -> Dict:
    """Stack per-guest machine states into one state with a leading guest
    axis (host-side helper for the multi-guest dispatch paths)."""
    return {"l2": tuple(torch.stack(xs) for xs in
                        zip(*(s["l2"] for s in states))),
            "llc": tuple(torch.stack(xs) for xs in
                         zip(*(s["llc"] for s in states))),
            "clock": torch.stack([s["clock"] for s in states]),
            "rng": torch.stack([s["rng"] for s in states])}


def unstack_states(states: Dict, n: int) -> List[Dict]:
    """Split a stacked machine state back into per-guest states (views)."""
    return [{"l2": tuple(x[i] for x in states["l2"]),
             "llc": tuple(x[i] for x in states["llc"]),
             "clock": states["clock"][i], "rng": states["rng"][i]}
            for i in range(n)]


def access_streams_batched(state: Dict, geom: MachineGeometry, blocks, cores,
                           cotenant, salt: int = 0):
    """Batched multi-set Prime+Probe engine: B independent access streams,
    each run against a snapshot of ``state``, in ONE dispatch.

    ``blocks``: (B, T) int32, -1 padded; ``cores``: (B,) int32;
    ``cotenant``: (B,) bool.  Returns latencies (B, T).  Lane state
    mutations are NOT committed.  Each lane forks the machine rng by
    ``RNG_LANE_STRIDE * lane + RNG_SALT_STRIDE * salt`` (lane 0 with
    ``salt=0`` keeps the machine rng, so a one-lane batched call is
    bit-exact vs. :func:`access_stream`).
    """
    dev = state["clock"].device
    salts = torch.tensor([int(salt) & _M32], dtype=torch.int64, device=dev)
    lats = engine(_single(state), geom, torch.as_tensor(blocks)[None],
                  torch.as_tensor(cores)[None],
                  torch.as_tensor(cotenant)[None], salts, commit=False)
    return lats[0]


def access_streams_batched_multi(states: Dict, geom: MachineGeometry, blocks,
                                 cores, cotenant, salts):
    """The batched engine over guests: G machines x B measurement lanes x T
    accesses in ONE dispatch.  ``states`` has a leading guest axis;
    ``blocks``: (G, B, T); ``cores``/``cotenant``: (G, B); ``salts``: (G,)
    (uint32 values).  Returns latencies (G, B, T); every guest's lanes are
    bit-identical to a standalone :func:`access_streams_batched` call."""
    if not isinstance(salts, torch.Tensor):
        salts = np.asarray(salts, dtype=np.int64)      # uint32 values
    return engine(states, geom, blocks, cores, cotenant, salts, commit=False)


# ---------------------------------------------------------------------------
# Host-side oracle helpers (ground truth NOT visible to the simulated VM;
# the analogue of the paper's custom GPA->HPA hypercall used for validation).
# ---------------------------------------------------------------------------

def resident_level(state: Dict, block: int, core: int,
                   geom: MachineGeometry) -> int:
    """2/3 if block is in this core's L2 / its domain's LLC, else 0."""
    domain = core // geom.cores_per_domain
    if bool((state["l2"][0][core] == block).any()):
        return 2
    if bool((state["llc"][0][domain] == block).any()):
        return 3
    return 0


def llc_occupancy(state: Dict, domain: int = 0) -> np.ndarray:
    """(n_slices, n_sets) count of valid lines per LLC set."""
    return (state["llc"][0][domain] >= 0).sum(dim=-1).cpu().numpy()
