"""Parity of the port's engine (`repro_torch.core.cachesim` on the CPU)
with the JAX simulator: the four entry points under lru and random
replacement and both inclusion variants, every platform geometry and the
paper's Table 1 geometry, the uint32 hash/rng edge values, and a JAX state
taken mid-run and continued in the port; each of these on both of the
CPU's engines (`cpu_engines`): `engine_py`, which a CPU state runs, and
`engine_ref`, the plain PyTorch version the CUDA kernel is held to.  And
the two engines against each other.  All exact.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cachesim as jsim
from repro.core import platforms as jplat
from repro_torch import _build
from repro_torch.core import cachesim as tsim
from repro_torch.core import platforms as tplat

SEEDS = (0x9E3779B9, 0x51C37)
EDGE_BLOCKS = np.array([0, 1, 2, 63, 64, 0x7FFF, 2 ** 30, 2 ** 31 - 2,
                        2 ** 31 - 1, -1, -2, -(2 ** 31), 0x12345678,
                        0x7FFFFFC0], dtype=np.int64).astype(np.int32)


def T(a):
    return torch.as_tensor(np.array(a))


def jgeom_of(tgeom):
    """The JAX MachineGeometry with the same fields."""
    f = {k: getattr(tgeom, k) for k in ("n_domains", "cores_per_domain",
                                          "replacement", "slice_seed",
                                          "inclusion")}
    return jsim.MachineGeometry(
        l2=jsim.CacheGeometry(**dataclasses.asdict(tgeom.l2)),
        llc=jsim.CacheGeometry(**dataclasses.asdict(tgeom.llc)), **f)


def jax_np(state):
    """A JAX machine state (single or stacked) as numpy arrays."""
    return {"l2": tuple(np.array(x) for x in state["l2"]),
            "llc": tuple(np.array(x) for x in state["llc"]),
            "clock": np.array(state["clock"]), "rng": np.array(state["rng"])}


def jax_state(np_state):
    return {"l2": tuple(jnp.asarray(x) for x in np_state["l2"]),
            "llc": tuple(jnp.asarray(x) for x in np_state["llc"]),
            "clock": jnp.asarray(np_state["clock"], jnp.int32),
            "rng": jnp.asarray(np_state["rng"], jnp.uint32)}


def assert_state_equal(tstate, np_state):
    got = tsim.state_to_numpy(tstate)
    for key in ("l2", "llc"):
        for g, w in zip(got[key], np_state[key]):
            np.testing.assert_array_equal(g, w)
    assert int(got["clock"].reshape(-1)[0]) == int(
        np.asarray(np_state["clock"]).reshape(-1)[0]) or np.array_equal(
            got["clock"], np_state["clock"])
    np.testing.assert_array_equal(got["clock"], np_state["clock"])
    np.testing.assert_array_equal(got["rng"], np_state["rng"])
    assert got["rng"].dtype == np.uint32


def stream(rng, geom, n, lines):
    blocks = rng.integers(0, lines, n).astype(np.int32)
    blocks[rng.random(n) < 0.1] = -1
    cores = rng.integers(0, geom.n_cores, n).astype(np.int32)
    cot = rng.random(n) < 0.2
    return blocks, cores, cot


def warmed(tgeom, rng, n=256):
    """A warm machine state (numpy, JAX layout) from the JAX engine."""
    jg = jgeom_of(tgeom)
    b, c, t = stream(rng, tgeom, n, 3 * tgeom.llc.n_lines)
    st, _ = jsim.access_stream(jsim.init_machine(jg), jg, jnp.asarray(b),
                               jnp.asarray(c), jnp.asarray(t))
    return jax_np(st)


@pytest.fixture
def cpu_engines(monkeypatch):
    """Iterate to run a test's port half once per CPU engine: each step
    installs `engine_py`, then `engine_ref`, as `cachesim.engine` (which
    every entry point calls) and yields its name."""
    def each():
        for run in (tsim.engine_py, tsim.engine_ref):
            monkeypatch.setattr(tsim, "engine", run)
            yield run.__name__
    return each


# -- uint32 arithmetic --------------------------------------------------------

@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("n_slices", [1, 2, 3, 20])
def test_slice_hash_edge_values(seed, n_slices):
    rng = np.random.default_rng(n_slices)
    blocks = np.concatenate([EDGE_BLOCKS, rng.integers(
        0, 2 ** 31 - 1, 256).astype(np.int32)])
    want = np.asarray(jsim.slice_hash(jnp.asarray(blocks), n_slices, seed))
    got = tsim.slice_hash(T(blocks), n_slices, seed).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int32


@pytest.mark.parametrize("start", [0x12345678, 1, 0x80000000, 0xFFFFFFFF,
                                   0x9E3779B9])
def test_next_rand_sequence(start):
    jr = jnp.uint32(start)
    tr = torch.tensor([start], dtype=torch.int64)
    for _ in range(64):
        jr, jbits = jsim._next_rand(jr)
        tr, tbits = tsim._next_rand(tr)
        assert int(tr[0]) == int(jr)
        assert int(tbits[0]) == int(jbits)


def test_mul32_is_the_low_32_bits_of_the_product():
    xs = [0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF, 0x9E3779B9]
    for c in (0x85EBCA6B, 0x9E3779B9, 0x51C37, 0xFFFFFFFF, 0x7F4A7C15):
        got = tsim._mul32(torch.tensor(xs, dtype=torch.int64), c).tolist()
        assert got == [(x * c) & 0xFFFFFFFF for x in xs]


# -- the four entry points ------------------------------------------------------

def run_all_entry_points(tgeom, rng, B=8, Tb=48, Tc=192):
    """Every entry point, JAX vs port, from one warmed state."""
    jg = jgeom_of(tgeom)
    lines = 3 * tgeom.llc.n_lines
    base = warmed(tgeom, rng)

    # access_stream (committed, padded -1 steps advance clock and rng)
    b, c, t = stream(rng, tgeom, Tc, lines)
    b[-20:] = -1
    js, jl = jsim.access_stream(jax_state(base), jg, jnp.asarray(b),
                                jnp.asarray(c), jnp.asarray(t))
    ts = tsim.state_from_numpy(base, "cpu")
    ts2, tl = tsim.access_stream(ts, tgeom, T(b), T(c), T(t))
    assert ts2 is ts
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    assert_state_equal(ts, jax_np(js))
    after = jax_np(js)

    # access_streams_committed: 2 guests from different states
    states_np = [base, after]
    streams = [stream(rng, tgeom, Tc, lines) for _ in states_np]
    blocks = np.stack([s[0] for s in streams])
    cores = np.stack([s[1] for s in streams])
    cot = np.stack([s[2] for s in streams])
    jst = jsim.stack_states([jax_state(s) for s in states_np])
    jst, jl = jsim.access_streams_committed(jst, jg, jnp.asarray(blocks),
                                            jnp.asarray(cores),
                                            jnp.asarray(cot))
    tst = tsim.stack_states([tsim.state_from_numpy(s, "cpu")
                             for s in states_np])
    tst, tl = tsim.access_streams_committed(tst, tgeom, T(blocks), T(cores),
                                            T(cot))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    assert_state_equal(tst, jax_np(jst))
    for i, s in enumerate(tsim.unstack_states(tst, 2)):
        assert_state_equal(s, jax_np(jsim.unstack_states(jst, 2)[i]))

    # access_streams_batched: lanes on a snapshot, salted rng forks
    lanes = rng.integers(0, lines, (B, Tb)).astype(np.int32)
    lanes[rng.random((B, Tb)) < 0.1] = -1
    lcores = rng.integers(0, tgeom.n_cores, B).astype(np.int32)
    lcot = rng.random(B) < 0.25
    for salt in (0, 5, 0xFFFFFFFF):
        jl = jsim.access_streams_batched(jax_state(after), jg,
                                         jnp.asarray(lanes),
                                         jnp.asarray(lcores),
                                         jnp.asarray(lcot), jnp.uint32(salt))
        tstate = tsim.state_from_numpy(after, "cpu")
        tl = tsim.access_streams_batched(tstate, tgeom, T(lanes), T(lcores),
                                         T(lcot), salt)
        np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
        assert_state_equal(tstate, after)       # nothing committed

    # access_streams_batched_multi: 2 guests, per-guest salts
    mb = rng.integers(0, lines, (2, B, Tb)).astype(np.int32)
    mb[rng.random((2, B, Tb)) < 0.1] = -1
    mc = rng.integers(0, tgeom.n_cores, (2, B)).astype(np.int32)
    mt = rng.random((2, B)) < 0.25
    salts = np.array([3, 0xFFFFFFF0], np.uint32)
    jl = jsim.access_streams_batched_multi(
        jsim.stack_states([jax_state(s) for s in states_np]), jg,
        jnp.asarray(mb), jnp.asarray(mc), jnp.asarray(mt),
        jnp.asarray(salts))
    tl = tsim.access_streams_batched_multi(
        tsim.stack_states([tsim.state_from_numpy(s, "cpu")
                           for s in states_np]), tgeom, T(mb), T(mc), T(mt),
        salts)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))


@pytest.mark.parametrize("replacement", ["lru", "random"])
@pytest.mark.parametrize("inclusion", ["inclusive", "non_inclusive"])
def test_entry_points_match_jax(replacement, inclusion, cpu_engines):
    geom = dataclasses.replace(tplat.get_platform("skylake_sp").machine(),
                               replacement=replacement, inclusion=inclusion)
    for _ in cpu_engines():
        run_all_entry_points(geom, np.random.default_rng(len(replacement)
                                                         + len(inclusion)))


@pytest.mark.parametrize("name", ["skylake_sp", "icelake_sp", "milan_ccx",
                                  "skylake_cat", "skylake_slicepart",
                                  "skylake_shared"])
def test_platform_geometries_match_jax(name, cpu_engines):
    tgeom = tplat.get_platform(name).machine()
    assert jgeom_of(tgeom) == jplat.get_platform(name).machine()
    for _ in cpu_engines():
        platform_geometry_matches_jax(tgeom, name)


def platform_geometry_matches_jax(tgeom, name):
    rng = np.random.default_rng(sum(map(ord, name)))
    jg = jgeom_of(tgeom)
    base = warmed(tgeom, rng, n=512)
    lines = 3 * tgeom.llc.n_lines
    b, c, t = stream(rng, tgeom, 128, lines)
    js, jl = jsim.access_stream(jax_state(base), jg, jnp.asarray(b),
                                jnp.asarray(c), jnp.asarray(t))
    ts, tl = tsim.access_stream(tsim.state_from_numpy(base, "cpu"), tgeom,
                                T(b), T(c), T(t))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    assert_state_equal(ts, jax_np(js))
    lanes = rng.integers(0, lines, (8, 32)).astype(np.int32)
    lc = rng.integers(0, tgeom.n_cores, 8).astype(np.int32)
    jl = jsim.access_streams_batched(js, jg, jnp.asarray(lanes),
                                     jnp.asarray(lc), jnp.zeros(8, bool),
                                     jnp.uint32(1))
    tl = tsim.access_streams_batched(ts, tgeom, T(lanes), T(lc),
                                     torch.zeros(8, dtype=torch.bool), 1)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))


@pytest.mark.parametrize("replacement,inclusion",
                         [("lru", "inclusive"), ("random", "non_inclusive")])
def test_table1_geometry_matches_jax(replacement, inclusion, cpu_engines):
    """The paper's Table 1 machine: 1024 x 16 L2s, 20 slices x 2048 x 11."""
    tgeom = tsim.MachineGeometry(l2=tsim.SKYLAKE_L2, llc=tsim.skylake_llc(20),
                                 replacement=replacement, inclusion=inclusion)
    assert tgeom.llc.n_lines == 450560
    for _ in cpu_engines():
        run_all_entry_points(tgeom, np.random.default_rng(1), B=4, Tb=24,
                             Tc=64)


def test_lane0_salt0_replays_access_stream(cpu_engines):
    geom = dataclasses.replace(tplat.get_platform("skylake_sp").machine(),
                               replacement="random")
    for _ in cpu_engines():
        lane0_salt0_replays_access_stream(geom)


def lane0_salt0_replays_access_stream(geom):
    rng = np.random.default_rng(3)
    st = tsim.state_from_numpy(warmed(geom, rng), "cpu")
    lane = rng.integers(0, 3 * geom.llc.n_lines, 64).astype(np.int32)
    one = tsim.access_streams_batched(st, geom, T(lane[None]),
                                      T(np.array([1], np.int32)),
                                      torch.zeros(1, dtype=torch.bool), 0)
    _, seq = tsim.access_stream(st, geom, T(lane), T(np.ones(64, np.int32)),
                                torch.zeros(64, dtype=torch.bool))
    assert torch.equal(one[0], seq)


def test_jax_state_mid_run_continues_in_the_port(cpu_engines):
    """A JAX machine taken mid-run, converted with `state_from_numpy`,
    continues bit-identically; `state_to_numpy` round-trips it."""
    geom = dataclasses.replace(tplat.get_platform("skylake_shared").machine(),
                               replacement="random")
    for _ in cpu_engines():
        jax_state_mid_run_continues_in_the_port(geom)


def jax_state_mid_run_continues_in_the_port(geom):
    jg = jgeom_of(geom)
    rng = np.random.default_rng(4)
    mid = warmed(geom, rng, n=700)
    back = tsim.state_to_numpy(tsim.state_from_numpy(mid, "cpu"))
    for key in ("l2", "llc"):
        for g, w in zip(back[key], mid[key]):
            assert g.dtype == w.dtype and np.array_equal(g, w)
    assert back["rng"].dtype == np.uint32 and back["rng"] == mid["rng"]
    b, c, t = stream(rng, geom, 300, 3 * geom.llc.n_lines)
    js, jl = jsim.access_stream(jax_state(mid), jg, jnp.asarray(b),
                                jnp.asarray(c), jnp.asarray(t))
    ts, tl = tsim.access_stream(tsim.state_from_numpy(mid, "cpu"), geom,
                                T(b), T(c), T(t))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    assert_state_equal(ts, jax_np(js))


def test_oracle_helpers_match_jax():
    geom = tplat.get_platform("milan_ccx").machine()
    jg = jgeom_of(geom)
    rng = np.random.default_rng(5)
    st_np = warmed(geom, rng, n=600)
    ts = tsim.state_from_numpy(st_np, "cpu")
    js = jax_state(st_np)
    resident = st_np["llc"][0][1].reshape(-1)
    probes = np.concatenate([resident[resident >= 0][:20],
                             st_np["l2"][0].reshape(-1)[:20],
                             rng.integers(0, 3 * geom.llc.n_lines, 20)])
    for blk in probes:
        if blk < 0:
            continue
        for core in range(geom.n_cores):
            assert tsim.resident_level(ts, int(blk), core, geom) == \
                jsim.resident_level(js, int(blk), core, jg)
    for d in range(geom.n_domains):
        np.testing.assert_array_equal(tsim.llc_occupancy(ts, d),
                                      jsim.llc_occupancy(js, d))


def test_cpu_state_runs_the_plain_engine_only():
    geom = tplat.get_platform("skylake_sp").machine()
    _build.reset_counters()
    st = tsim.init_machine(geom, "cpu")
    tsim.access_stream(st, geom, T(np.arange(10, dtype=np.int32)),
                       T(np.zeros(10, np.int32)),
                       torch.zeros(10, dtype=torch.bool))
    tsim.access_streams_batched(st, geom, T(np.zeros((2, 4), np.int32)),
                                T(np.zeros(2, np.int32)),
                                torch.zeros(2, dtype=torch.bool))
    assert _build.PLAIN_CALLS["cachesim_engine"] == 2
    assert not _build.LAUNCHES


def _clone(st):
    return {k: (tuple(x.clone() for x in v) if isinstance(v, tuple)
                else v.clone()) for k, v in st.items()}


@pytest.mark.parametrize("name", ["skylake_sp", "milan_ccx", "skylake_cat",
                                  "icelake_sp"])
@pytest.mark.parametrize("replacement,inclusion",
                         [("lru", "inclusive"), ("random", "non_inclusive"),
                          ("random", "inclusive")])
def test_python_engine_equals_the_plain_engine(name, replacement, inclusion):
    """`engine_py` (what a CPU state runs) against `engine_ref` (the plain PyTorch engine the CUDA kernel
    is held to): committed streams on three guests, then measurement
    lanes with salts on a copy of each, on congruent addresses so rows
    fill, evict and back-invalidate: the same latencies, states, clocks
    and rngs."""
    geom = dataclasses.replace(tplat.get_platform(name).machine(),
                               replacement=replacement, inclusion=inclusion)
    rng = np.random.default_rng(len(name) + len(replacement))
    G = 3

    def congruent(shape):
        return (rng.integers(0, 96, shape) * 4096
                + rng.integers(0, 3, shape) * 64
                + rng.integers(0, 2, shape)).astype(np.int32)

    ref = tsim.stack_states([tsim.init_machine(geom, "cpu")
                             for _ in range(G)])
    py = _clone(ref)
    wb = congruent((G, 1, 500))
    wb[:, :, ::17] = -1
    wc = rng.integers(0, geom.n_cores, (G, 500)).astype(np.int32)
    wt = rng.random((G, 500)) < 0.3
    lr = tsim.engine_ref(ref, geom, T(wb), wc, wt, None, True)
    lp = tsim.engine_py(py, geom, T(wb), wc, wt, None, True)
    assert torch.equal(lp, lr)
    for B in (5, 50):
        mb = congruent((G, B, 40))
        mb[rng.random(mb.shape) < 0.05] = -1
        mc = rng.integers(0, geom.n_cores, (G, B)).astype(np.int32)
        mt = rng.random((G, B)) < 0.3
        salts = rng.integers(0, 2 ** 32, G).astype(np.int64)
        lr = tsim.engine_ref(ref, geom, T(mb), mc, mt, salts, False)
        lp = tsim.engine_py(py, geom, T(mb), mc, mt, salts, False)
        assert torch.equal(lp, lr), B
    for k in ("l2", "llc"):
        for a, b in zip(py[k], ref[k]):
            assert torch.equal(a, b)
    assert torch.equal(py["clock"], ref["clock"])
    assert torch.equal(py["rng"], ref["rng"])
