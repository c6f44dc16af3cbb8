"""Parity of the port's LRU kernels (plain PyTorch versions, on the CPU)
with the JAX package: `lru_touch`, `lru_sets`, `prime_probe` against the
JAX oracles (`ref.py`) and the Pallas kernels in interpret mode, plus the
eviction law and the agreement of both kernels with the batched engine on
a single-level geometry.  All comparisons are exact: integer arithmetic.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cachesim as jsim
from repro.kernels import _lru as j_lru
from repro.kernels.cache_probe import ops as j_probe_ops
from repro.kernels.cache_probe import ref as j_probe_ref
from repro.kernels.cachesim_step import ops as j_sim_ops
from repro.kernels.cachesim_step import ref as j_sim_ref
from repro_torch import _build
from repro_torch.core import cachesim as tsim
from repro_torch.kernels import _lru as t_lru
from repro_torch.kernels.cache_probe import kernel as t_probe_kernel
from repro_torch.kernels.cache_probe import ops as t_probe_ops
from repro_torch.kernels.cache_probe import ref as t_probe_ref
from repro_torch.kernels.cachesim_step import kernel as t_sim_kernel
from repro_torch.kernels.cachesim_step import ops as t_sim_ops
from repro_torch.kernels.cachesim_step import ref as t_sim_ref


def T(a):
    return torch.as_tensor(np.array(a))


def N(x):
    return np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)


def _rows(rng, R, W, lo=0, hi=16, fill=0.6):
    tags = rng.integers(lo, hi, (R, W)).astype(np.int32)
    tags[rng.random((R, W)) > fill] = -1
    age = rng.integers(0, 50, (R, W)).astype(np.int32)
    return tags, age


# -- lru_touch ----------------------------------------------------------------

@pytest.mark.parametrize("R,W,seed", [(8, 4, 0), (16, 8, 1), (32, 16, 2),
                                      (5, 11, 3)])
def test_lru_touch_matches_jax(R, W, seed):
    """Hit / first-empty / LRU-victim selection, ties on the first way
    (duplicate tags and equal ages included), no-ops for -1 blocks."""
    rng = np.random.default_rng(seed)
    tags, age = _rows(rng, R, W)
    age[:, : W // 2] = 7                       # equal ages: first way wins
    for step in range(6):
        blk = rng.integers(-1, 16, R).astype(np.int32)
        jt, ja, jh = j_lru.lru_touch(jnp.asarray(tags), jnp.asarray(age),
                                     jnp.asarray(blk), 100 + step)
        tt, ta, th = t_lru.lru_touch(T(tags), T(age), T(blk), 100 + step)
        np.testing.assert_array_equal(N(tt), np.asarray(jt))
        np.testing.assert_array_equal(N(ta), np.asarray(ja))
        np.testing.assert_array_equal(N(th), np.asarray(jh))
        tags, age = np.asarray(jt), np.asarray(ja)


@pytest.mark.parametrize("W,seed", [(8, 0), (11, 1), (16, 2)])
def test_lru_touch_victim_matches_engine_touch(W, seed):
    """The rand_bits/victim form the engine uses equals the JAX engine's
    `_touch` row update under LRU (-1) and random replacement."""
    rng = np.random.default_rng(seed)
    R = 24
    tags, age = _rows(rng, R, W, hi=2 * W, fill=0.9)
    tags[: R // 2] = rng.permutation(4 * W)[:W]     # full rows: victims
    blk = rng.integers(0, 2 * W, R).astype(np.int32)
    for rand in (False, True):
        bits = (rng.integers(0, 2 ** 31 - 1, R).astype(np.int32) if rand
                else np.full(R, -1, np.int32))
        jt, ja, jh, jv = jax.vmap(jsim._touch, in_axes=(0, 0, None, 0, 0))(
            jnp.asarray(tags), jnp.asarray(age), jnp.int32(99),
            jnp.asarray(blk), jnp.asarray(bits))
        tt, ta, th, tv = t_lru.lru_touch_victim(
            T(tags), T(age), T(blk), 99,
            T(bits).long() if rand else None)
        for got, want in ((tt, jt), (ta, ja), (th, jh), (tv, jv)):
            np.testing.assert_array_equal(N(got), np.asarray(want))


def _tied_or_gapped_rows(rng, R, W, case):
    """Rows for the first-index rules.  "tied": full rows whose ages take
    two values, so the LRU way is a tie.  "gaps": empty ways between full
    ones (the first empty way is not way 0), ages tied as well."""
    tags = np.stack([rng.permutation(4 * W)[:W] for _ in range(R)])
    tags = tags.astype(np.int32)
    age = rng.integers(5, 7, (R, W)).astype(np.int32)
    if case == "gaps":
        holes = rng.random((R, W)) < 0.4
        holes[:, 0] = False                  # a full way before any hole
        holes[np.arange(R), rng.integers(1, W, R)] = True
        tags[holes] = -1
    return tags, age


@pytest.mark.parametrize("case", ["tied", "gaps"])
@pytest.mark.parametrize("W", [4, 11, 16, 33, 40])
def test_lru_touch_victim_first_index_rules_match_jax(W, case):
    """The plain version the kernels' warp form is held to, at widths
    below, at and past a warp, against JAX's `_lru.lru_touch` (LRU) and
    the engine's `_touch` (LRU and random replacement, with the victim):
    hits on a duplicate tag, the first empty way, the first of tied
    oldest ways, no-ops for -1."""
    rng = np.random.default_rng(W + 100 * (case == "gaps"))
    R = 48
    tags, age = _tied_or_gapped_rows(rng, R, W, case)
    if case == "tied":
        tags[:4, 1] = tags[:4, 2]            # duplicate tags: first wins
    blk = np.where(rng.random(R) < 0.3, tags[:, 0],
                   rng.integers(4 * W, 6 * W, R)).astype(np.int32)
    blk[:4] = tags[:4, 2]
    blk[-3:] = -1
    for step in range(3):
        jt, ja, jh = j_lru.lru_touch(jnp.asarray(tags), jnp.asarray(age),
                                     jnp.asarray(blk), 40 + step)
        tt, ta, th, tv = t_lru.lru_touch_victim(T(tags), T(age), T(blk),
                                                40 + step)
        for got, want in ((tt, jt), (ta, ja), (th, jh)):
            np.testing.assert_array_equal(N(got), np.asarray(want))
        for rand in (False, True):
            bits = (rng.integers(0, 2 ** 31 - 1, R).astype(np.int32)
                    if rand else np.full(R, -1, np.int32))
            et, ea, eh, ev = jax.vmap(jsim._touch,
                                      in_axes=(0, 0, None, 0, 0))(
                jnp.asarray(tags), jnp.asarray(age), jnp.int32(40 + step),
                jnp.asarray(blk), jnp.asarray(bits))
            rt, ra, rh, rv = t_lru.lru_touch_victim(
                T(tags), T(age), T(blk), 40 + step,
                T(bits).long() if rand else None)
            valid = blk >= 0                  # `_touch` has no no-op rule
            for got, want in ((rt, et), (ra, ea)):
                np.testing.assert_array_equal(N(got)[valid],
                                              np.asarray(want)[valid])
            np.testing.assert_array_equal(N(rh)[valid],
                                          np.asarray(eh)[valid])
            np.testing.assert_array_equal(N(rv)[valid],
                                          np.asarray(ev)[valid])
        tags, age = np.asarray(jt), np.asarray(ja)


# -- lru_sets -------------------------------------------------------------------

LRU_CASES = [(4, 4, 1, 0), (8, 8, 33, 1), (16, 4, 48, 2), (32, 8, 17, 3),
             (16, 8, 64, 4)]


@pytest.mark.parametrize("rows,ways,T_,seed", LRU_CASES)
def test_lru_sets_matches_jax_ref_and_pallas(rows, ways, T_, seed):
    """Plain `lru_sets` vs `lru_sets_ref` and the Pallas kernel (interpret
    mode), with pre-populated rows (the test_kernels.py sweep)."""
    rng = np.random.default_rng(seed)
    tags = np.full((rows, ways), -1, np.int32)
    tags[: rows // 2, : ways // 2] = rng.integers(0, 64, (rows // 2,
                                                          ways // 2))
    age = np.zeros((rows, ways), np.int32)
    streams = rng.integers(-1, 64, size=(rows, T_)).astype(np.int32)
    args = [jnp.asarray(x) for x in (tags, age, streams)]
    want_ref = j_sim_ref.lru_sets_ref(*args)
    want_pallas = j_sim_ops.simulate_rows(*args)
    got = t_sim_ops.simulate_rows(T(tags), T(age), T(streams))
    for g, r, p in zip(got, want_ref, want_pallas):
        np.testing.assert_array_equal(N(g), np.asarray(r))
        np.testing.assert_array_equal(N(g), np.asarray(p))


@pytest.mark.parametrize("seed", range(6))
def test_lru_sets_property_space_matches_jax(seed):
    """The property test's space (rows 4/8/16, ways 4/8, T 1..48, blocks
    -1..31, cold rows) with a clock0 other than 1."""
    rng = np.random.default_rng(100 + seed)
    rows = int(rng.choice([4, 8, 16]))
    ways = int(rng.choice([4, 8]))
    T_ = int(rng.integers(1, 49))
    tags = np.full((rows, ways), -1, np.int32)
    age = np.zeros((rows, ways), np.int32)
    streams = rng.integers(-1, 32, size=(rows, T_)).astype(np.int32)
    want = j_sim_ref.lru_sets_ref(jnp.asarray(tags), jnp.asarray(age),
                                  jnp.asarray(streams), clock0=5)
    got = t_sim_ref.lru_sets_ref(T(tags), T(age), T(streams), clock0=5)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(N(g), np.asarray(w))


def test_lru_sets_matches_core_simulator():
    """The kernel's plain version agrees with the port's engine on a
    single-level workload (test_kernels.py's check): per-set contents."""
    geom = tsim.MachineGeometry(
        n_domains=1, cores_per_domain=1,
        llc=tsim.CacheGeometry(n_sets=16, n_ways=4, n_slices=1))
    state = tsim.init_machine(geom, "cpu")
    rng = np.random.default_rng(7)
    blocks = (rng.integers(0, 64, size=128) * 16 +
              rng.integers(0, 16, size=128)).astype(np.int32)
    tsim.access_stream(state, geom, T(blocks), torch.zeros(128, dtype=torch.int32),
                       torch.ones(128, dtype=torch.bool))
    per_set = [[b for b in blocks if b % 16 == s] for s in range(16)]
    streams = np.full((16, max(map(len, per_set))), -1, np.int32)
    for s, items in enumerate(per_set):
        streams[s, :len(items)] = items
    t_k, _, _ = t_sim_ops.simulate_rows(torch.full((16, 4), -1, dtype=torch.int32),
                                        torch.zeros((16, 4), dtype=torch.int32),
                                        T(streams))
    core_tags = N(state["llc"][0][0, 0])
    for s in range(16):
        assert ({int(x) for x in N(t_k[s]) if x >= 0}
                == {int(x) for x in core_tags[s] if x >= 0})


def _single_level(R, W, T_, seed):
    """One core, one slice, R pre-populated LLC sets (ages below the
    clock), one stream per set; as JAX-layout numpy state."""
    rng = np.random.default_rng(seed)
    geom = dict(n_domains=1, cores_per_domain=1)
    tags = np.full((R, W), -1, np.int32)
    for r in range(R):
        k = int(rng.integers(0, W + 1))
        tags[r, :k] = rng.permutation(4 * W)[:k] * R + r
    age = np.where(tags >= 0, rng.integers(1, 500, (R, W)), 0).astype(
        np.int32)
    state = {"l2": (np.full((1, 16, 4), -1, np.int32),
                    np.zeros((1, 16, 4), np.int32)),
             "llc": (tags[None, None], age[None, None]),
             "clock": np.int32(500), "rng": np.uint32(0x12345678)}
    lanes = (rng.integers(0, 3 * W, (R, T_)) * R
             + np.arange(R)[:, None]).astype(np.int32)
    lanes[rng.random((R, T_)) < 0.1] = -1
    return geom, state, lanes, 501


def _engine_lanes(geom_kw, state_np, R, W, lanes):
    """The port's and the JAX package's batched engines on co-tenant lanes
    (LLC only); both must agree before they serve as the reference."""
    l2 = tsim.CacheGeometry(n_sets=16, n_ways=4)
    llc = tsim.CacheGeometry(n_sets=R, n_ways=W, n_slices=1)
    tgeom = tsim.MachineGeometry(l2=l2, llc=llc, **geom_kw)
    jgeom = jsim.MachineGeometry(l2=jsim.CacheGeometry(16, 4),
                                 llc=jsim.CacheGeometry(R, W, 1), **geom_kw)
    state = tsim.state_from_numpy(state_np, "cpu")
    got = tsim.access_streams_batched(state, tgeom, T(lanes),
                                      torch.zeros(R, dtype=torch.int32),
                                      torch.ones(R, dtype=torch.bool), 0)
    jstate = {"l2": tuple(jnp.asarray(x) for x in state_np["l2"]),
              "llc": tuple(jnp.asarray(x) for x in state_np["llc"]),
              "clock": jnp.int32(state_np["clock"]),
              "rng": jnp.uint32(state_np["rng"])}
    want = jsim.access_streams_batched(jstate, jgeom, jnp.asarray(lanes),
                                       jnp.zeros(R, jnp.int32),
                                       jnp.ones(R, bool), jnp.uint32(0))
    np.testing.assert_array_equal(N(got), np.asarray(want))
    return N(got)


def test_lru_sets_matches_batched_engine_single_level():
    R, W, T_ = 32, 8, 40
    geom_kw, state_np, lanes, clock0 = _single_level(R, W, T_, seed=5)
    lats = _engine_lanes(geom_kw, state_np, R, W, lanes)
    _, _, hits = t_sim_ops.simulate_rows(T(state_np["llc"][0][0, 0]),
                                         T(state_np["llc"][1][0, 0]),
                                         T(lanes), clock0=clock0)
    np.testing.assert_array_equal(N(hits), lats == tsim.LAT_LLC)


# -- prime_probe ------------------------------------------------------------------

PROBE_CASES = [(8, 4, 24, 0), (16, 8, 40, 1), (64, 8, 40, 2), (32, 16, 12, 3)]


@pytest.mark.parametrize("lanes,ways,T_,seed", PROBE_CASES)
def test_prime_probe_matches_jax_ref_and_pallas(lanes, ways, T_, seed):
    rng = np.random.default_rng(seed)
    tags = np.full((lanes, ways), -1, np.int32)
    tags[::2, : ways // 2] = rng.integers(100, 164, (lanes // 2, ways // 2))
    age = np.zeros((lanes, ways), np.int32)
    streams = rng.integers(-1, 64, (lanes, T_)).astype(np.int32)
    targets = rng.integers(0, 64, lanes).astype(np.int32)
    args = [jnp.asarray(x) for x in (tags, age, streams, targets)]
    got = N(t_probe_ops.probe_verdicts(T(tags), T(age), T(streams),
                                       T(targets)))
    np.testing.assert_array_equal(got, np.asarray(j_probe_ref
                                                  .prime_probe_ref(*args)))
    np.testing.assert_array_equal(got, np.asarray(j_probe_ops
                                                  .probe_verdicts(*args)))


def test_prime_probe_lru_eviction_law():
    """Evicted iff >= ways distinct other blocks follow the target's
    install, whatever the lane held before (test_kernels.py's law)."""
    rng = np.random.default_rng(7)
    lanes, ways, T_ = 32, 8, 48
    tags = np.full((lanes, ways), -1, np.int32)
    tags[::2, :4] = rng.integers(1000, 1064, (lanes // 2, 4))
    age = np.zeros((lanes, ways), np.int32)
    targets = rng.integers(0, 64, lanes).astype(np.int32)
    streams = rng.integers(-1, 64, (lanes, T_)).astype(np.int32)
    streams[streams == targets[:, None]] = -1
    v = N(t_probe_ops.probe_verdicts(T(tags), T(age), T(streams),
                                     T(targets)))
    for b in range(lanes):
        distinct = len(set(int(x) for x in streams[b] if x >= 0))
        assert bool(v[b]) == (distinct >= ways), (b, distinct)


def test_prime_probe_matches_batched_engine_single_level():
    """Lane b = [target, prime stream..., target] in set b: the engine's
    last latency is a miss iff `prime_probe` says evicted."""
    R, W, T_ = 32, 8, 38
    geom_kw, state_np, stream, clock0 = _single_level(R, W, T_, seed=9)
    rng = np.random.default_rng(9)
    targets = (rng.integers(0, 3 * W, R) * R + np.arange(R)).astype(np.int32)
    lanes = np.concatenate([targets[:, None], stream, targets[:, None]], 1)
    lats = _engine_lanes(geom_kw, state_np, R, W, lanes)
    v = t_probe_ops.probe_verdicts(T(state_np["llc"][0][0, 0]),
                                   T(state_np["llc"][1][0, 0]), T(stream),
                                   T(targets), clock0=clock0)
    np.testing.assert_array_equal(N(v), lats[:, -1] == tsim.LAT_DRAM)


# -- wrappers ---------------------------------------------------------------------

def test_wrappers_on_cpu_run_the_plain_version_and_count_nothing():
    _build.reset_counters()
    rng = np.random.default_rng(1)
    tags, age = _rows(rng, 8, 4)
    streams = rng.integers(-1, 16, (8, 10)).astype(np.int32)
    targets = rng.integers(0, 16, 8).astype(np.int32)
    got = t_sim_kernel.lru_sets(T(tags), T(age), T(streams), clock0=3)
    want = t_sim_ref.lru_sets_ref(T(tags), T(age), T(streams), clock0=3)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert torch.equal(
        t_probe_kernel.prime_probe(T(tags), T(age), T(streams), T(targets)),
        t_probe_ref.prime_probe_ref(T(tags), T(age), T(streams), T(targets)))
    assert not _build.LAUNCHES


def test_wrappers_check_shapes():
    tags = torch.full((4, 8), -1, dtype=torch.int32)
    with pytest.raises(ValueError):
        t_sim_kernel.lru_sets(tags, torch.zeros((4, 7), dtype=torch.int32),
                              torch.zeros((4, 3), dtype=torch.int32))
    with pytest.raises(ValueError):
        t_probe_kernel.prime_probe(tags, torch.zeros_like(tags),
                                   torch.zeros((4, 3), dtype=torch.int32),
                                   torch.zeros(5, dtype=torch.int32))
