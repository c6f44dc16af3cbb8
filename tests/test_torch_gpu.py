"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Each test decides inside itself whether a card is present and
skips without one; run them on a card with

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py
"""

import dataclasses
import functools
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import _build
from repro_torch.core import cachesim, platforms, runner
from repro_torch.kernels.cache_probe import kernel as probe_kernel
from repro_torch.kernels.cache_probe import ops as probe_ops
from repro_torch.kernels.cache_probe import ref as probe_ref
from repro_torch.kernels.cachesim_step import ops as sim_ops
from repro_torch.kernels.cachesim_step import ref as sim_ref
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan import ref as ssd_ref

pytestmark = pytest.mark.gpu
GOLDEN = Path(__file__).parent / "data" / \
    "torch_golden_run_cachex_skylake_sp.json"


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _on(dev, a):
    return torch.as_tensor(np.array(a), device=dev)


@functools.lru_cache(maxsize=None)
def _chip_smoke():
    """chip_smoke.py as a module: its input generators are shared with
    these tests."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("rows,ways,T,seed", [(4, 4, 1, 0), (64, 8, 33, 1),
                                              (1024, 8, 128, 2),
                                              (100, 16, 40, 3)])
def test_lru_sets_kernel_matches_plain(rows, ways, T, seed):
    dev = _card()
    rng = np.random.default_rng(seed)
    tags = rng.integers(0, 64, (rows, ways)).astype(np.int32)
    tags[rng.random((rows, ways)) < 0.4] = -1
    age = rng.integers(0, 100, (rows, ways)).astype(np.int32)
    streams = rng.integers(-1, 64, (rows, T)).astype(np.int32)
    args = [_on(dev, x) for x in (tags, age, streams)]
    n0 = _build.LAUNCHES["lru_sets"]
    got = sim_ops.simulate_rows(*args, clock0=200)
    assert _build.LAUNCHES["lru_sets"] == n0 + 1
    for g, w in zip(got, sim_ref.lru_sets_ref(*args, clock0=200)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("T", [1, 31, 32, 33, 128])
@pytest.mark.parametrize("W", [1, 4, 8, 11, 16, 32, 33, 40, 100, 200, 300])
def test_lru_sets_warp_kernel_widths_and_edges(W, T):
    """The warp design at every row holder (one to eight registers a lane,
    the row in memory past 256 ways) and across stream chunks of 32: 37
    rows (not a multiple of the block's four), tied ages, rows full and
    half empty, -1 runs mid-stream, hits and misses, at clock0 1 and
    1000; bit for bit against `lru_sets_ref`, one launch a call."""
    dev = _card()
    tags, age, streams = _chip_smoke().Smoke.lru_edge_rows(37, W, T)
    args = [_on(dev, x) for x in (tags, age, streams)]
    for clock0 in (1, 1000):
        n0 = _build.LAUNCHES["lru_sets"]
        got = sim_ops.simulate_rows(*args, clock0=clock0)
        assert _build.LAUNCHES["lru_sets"] == n0 + 1
        for g, w in zip(got, sim_ref.lru_sets_ref(*args, clock0=clock0)):
            assert torch.equal(g, w)


@pytest.mark.parametrize("B,W,T,seed", [(8, 4, 24, 0), (128, 8, 128, 1),
                                        (256, 8, 128, 2), (33, 16, 12, 3)])
def test_prime_probe_kernel_matches_plain(B, W, T, seed):
    dev = _card()
    rng = np.random.default_rng(seed)
    tags = rng.integers(100, 164, (B, W)).astype(np.int32)
    tags[rng.random((B, W)) < 0.5] = -1
    age = np.zeros((B, W), np.int32)
    streams = rng.integers(-1, 64, (B, T)).astype(np.int32)
    targets = rng.integers(0, 64, B).astype(np.int32)
    args = [_on(dev, x) for x in (tags, age, streams, targets)]
    assert torch.equal(probe_ops.probe_verdicts(*args),
                       probe_ref.prime_probe_ref(*args))


@pytest.mark.parametrize("replacement", ["lru", "random"])
@pytest.mark.parametrize("inclusion", ["inclusive", "non_inclusive"])
def test_engine_kernel_matches_plain(replacement, inclusion):
    dev = _card()
    geom = dataclasses.replace(platforms.get_platform("skylake_sp").machine(),
                               replacement=replacement, inclusion=inclusion)
    rng = np.random.default_rng(1)
    lines = 3 * geom.llc.n_lines
    state = cachesim.init_machine(geom, dev)
    plain = {k: (tuple(x.clone() for x in v) if isinstance(v, tuple)
                 else v.clone()) for k, v in state.items()}
    blocks = rng.integers(-1, lines, 1024).astype(np.int32)
    cores = rng.integers(0, geom.n_cores, 1024).astype(np.int32)
    cot = rng.random(1024) < 0.2
    _, lk = cachesim.access_stream(state, geom, _on(dev, blocks),
                                   _on(dev, cores), _on(dev, cot))
    lp = cachesim.engine_ref(cachesim._single(plain), geom,
                             _on(dev, blocks)[None, None],
                             _on(dev, cores)[None], _on(dev, cot)[None],
                             None, commit=True)[0, 0]
    assert torch.equal(lk, lp)
    for key in ("l2", "llc"):
        for a, b in zip(state[key], plain[key]):
            assert torch.equal(a, b)
    assert torch.equal(state["rng"], plain["rng"])
    lanes = rng.integers(-1, lines, (16, 128)).astype(np.int32)
    lc = rng.integers(0, geom.n_cores, 16).astype(np.int32)
    lt = rng.random(16) < 0.25
    lk = cachesim.access_streams_batched(state, geom, _on(dev, lanes),
                                         _on(dev, lc), _on(dev, lt), 9)
    lp = cachesim.engine_ref(cachesim._single(state), geom,
                             _on(dev, lanes)[None], _on(dev, lc)[None],
                             _on(dev, lt)[None], _on(dev, [9]),
                             commit=False)[0]
    assert torch.equal(lk, lp)


# -- the engine's two designs and the warp form of lru_touch (fifth slice) ------------

def _geometry(name):
    """The six registered platforms, the paper's Table 1 geometry and a
    geometry whose rows are wider than a warp (40 and 36 ways, two
    domains), which runs `lru_touch_warp` on rows in memory."""
    if name == "table1":
        return cachesim.MachineGeometry(l2=cachesim.SKYLAKE_L2,
                                        llc=cachesim.skylake_llc(20))
    if name == "wide":
        return cachesim.MachineGeometry(
            n_domains=2, cores_per_domain=2,
            l2=cachesim.CacheGeometry(n_sets=32, n_ways=40),
            llc=cachesim.CacheGeometry(n_sets=64, n_ways=36, n_slices=2))
    return platforms.get_platform(name).machine()


def _conflict_blocks(rng, geom, shape):
    """-1-padded blocks, 60% of them on four sets of both levels (every
    set count is a power of two), enough lines there to overflow the
    domain's LLC rows of those sets, so victims and back-invalidations
    happen; the rest spread over three times the LLC."""
    period = max(geom.l2.n_sets, geom.llc.n_sets)
    many = 2 * max(geom.l2.n_ways, geom.llc.n_ways * geom.llc.n_slices)
    hot = rng.integers(0, 4, shape) + period * rng.integers(0, many, shape)
    spread = rng.integers(0, 3 * geom.llc.n_lines, shape)
    blocks = np.where(rng.random(shape) < 0.6, hot, spread)
    blocks[rng.random(shape) < 0.1] = -1
    return blocks.astype(np.int32)


def _clone(state):
    return {k: (tuple(x.clone() for x in v) if isinstance(v, tuple)
                else v.clone()) for k, v in state.items()}


def _assert_states_equal(a, b):
    for key in ("l2", "llc"):
        for x, y in zip(a[key], b[key]):
            assert torch.equal(x, y), key
    assert torch.equal(a["clock"], b["clock"])
    assert torch.equal(a["rng"], b["rng"])


def _lane_rows(geom, blocks, cores, cot):
    """Per lane, the distinct L2 rows its prober accesses touch and the
    distinct LLC rows its valid accesses touch: (G * B, 2)."""
    G, B, T = blocks.shape
    blk = blocks.reshape(G * B, T).astype(np.int64)
    core = np.broadcast_to(cores.reshape(G * B, 1), blk.shape)
    prober = (blk >= 0) & ~np.broadcast_to(cot.reshape(G * B, 1), blk.shape)
    sb = np.where(blk >= 0, blk, 0)
    sl = cachesim.slice_hash(torch.as_tensor(sb), geom.llc.n_slices,
                             geom.slice_seed).numpy().astype(np.int64)
    l2 = core * geom.l2.n_sets + sb % geom.l2.n_sets
    llc = ((core // geom.cores_per_domain * geom.llc.n_slices + sl)
           * geom.llc.n_sets + sb % geom.llc.n_sets)
    return np.array([[len(np.unique(l2[i][prober[i]])),
                      len(np.unique(llc[i][blk[i] >= 0]))]
                     for i in range(G * B)])


def _engine_matches_plain(name, replacement, inclusion, budget):
    """Commit mode twice (cold, then warm) on 3 guests, then measure mode
    on 3 guests x 8 lanes, through `_engine_cuda` under ``budget``, each
    against `engine_ref` on a copy: latencies, states, clocks and rngs."""
    dev = _card()
    geom = dataclasses.replace(_geometry(name), replacement=replacement,
                               inclusion=inclusion)
    G, B, T = 3, 8, 128
    plan = cachesim._engine_plan(geom, T, False, budget)
    assert plan.design == ("touch" if budget == 0 or name == "table1"
                           else "shared")
    rng = np.random.default_rng(len(name) + 3 * len(replacement)
                                + len(inclusion))
    kern = cachesim.stack_states([cachesim.init_machine(geom, dev)
                                  for _ in range(G)])
    plain = _clone(kern)
    n0 = _build.LAUNCHES["cachesim_engine"]
    for steps in (300, 200):
        blocks = _on(dev, _conflict_blocks(rng, geom, (G, 1, steps)))
        cores = _on(dev, rng.integers(0, geom.n_cores, (G, steps))
                    .astype(np.int32))
        cot = _on(dev, rng.random((G, steps)) < 0.2)
        lk = cachesim._engine_cuda(kern, geom, blocks, cores, cot, None,
                                   True, smem_budget=budget)
        lp = cachesim.engine_ref(plain, geom, blocks, cores, cot, None, True)
        assert torch.equal(lk, lp)
        _assert_states_equal(kern, plain)
    lanes = _conflict_blocks(rng, geom, (G, B, T))
    lc = rng.integers(0, geom.n_cores, (G, B)).astype(np.int32)
    lt = rng.random((G, B)) < 0.25
    salts = _on(dev, np.array([0, 7, 0xFFFFFFFF], np.int64))
    copied = torch.full((G * B, 2), -1, dtype=torch.int32, device=dev)
    lk = cachesim._engine_cuda(kern, geom, _on(dev, lanes), _on(dev, lc),
                               _on(dev, lt), salts, False,
                               smem_budget=budget, rows_copied=copied)
    lp = cachesim.engine_ref(kern, geom, _on(dev, lanes), _on(dev, lc),
                             _on(dev, lt), salts, False)
    assert torch.equal(lk, lp)
    _assert_states_equal(kern, plain)          # measure mode wrote nothing
    assert _build.LAUNCHES["cachesim_engine"] == n0 + 3
    if plan.design == "touch":   # a lane copies the rows it touches
        need = _lane_rows(geom, lanes, lc, lt)
        got = copied.cpu().numpy()
        assert (got[:, 1] == need[:, 1]).all()
        if inclusion == "inclusive":   # and the rows its victims change
            assert (got[:, 0] >= need[:, 0]).all()
            assert (got[:, 0] <= need[:, 0]
                    + geom.cores_per_domain * T).all()
        else:
            assert (got[:, 0] == need[:, 0]).all()
    else:
        assert (copied.cpu() == -1).all()


ENGINE_GEOMETRIES = ["skylake_sp", "icelake_sp", "milan_ccx", "skylake_cat",
                     "skylake_slicepart", "skylake_shared", "table1", "wide"]


@pytest.mark.parametrize("inclusion", ["inclusive", "non_inclusive"])
@pytest.mark.parametrize("replacement", ["lru", "random"])
@pytest.mark.parametrize("name", ENGINE_GEOMETRIES)
def test_engine_kernel_geometries_match_plain(name, replacement, inclusion):
    """The design each geometry takes: shared memory for the six
    platforms and the wide rows, copy on first touch for Table 1."""
    _engine_matches_plain(name, replacement, inclusion,
                          cachesim.SMEM_BUDGET)


@pytest.mark.parametrize("inclusion", ["inclusive", "non_inclusive"])
@pytest.mark.parametrize("replacement", ["lru", "random"])
@pytest.mark.parametrize("name", ["skylake_sp", "table1", "wide"])
def test_engine_kernel_touch_design_matches_plain(name, replacement,
                                                  inclusion):
    """A budget of 0 forces the copy-on-touch design, with the row table
    in device memory."""
    _engine_matches_plain(name, replacement, inclusion, 0)


@pytest.mark.parametrize("W", [4, 8, 11, 16, 33, 40])
def test_prime_probe_kernel_widths_with_tied_ages(W):
    """Rows of W ways (one register a lane up to 32, shared memory past
    it), most of them full with ages drawn from three values, empty ways
    between full ones in the rest: the LRU choice falls on ties."""
    dev = _card()
    rng = np.random.default_rng(W)
    B, T = 96, 100
    tags = np.stack([rng.permutation(4 * W)[:W] for _ in range(B)])
    tags = (tags + 1000).astype(np.int32)
    gaps = rng.random((B, W)) < 0.3
    gaps[: B // 2] = False
    tags[gaps] = -1
    age = rng.integers(0, 3, (B, W)).astype(np.int32)
    targets = np.where(rng.random(B) < 0.5, tags[:, 0],
                       rng.integers(1000, 1000 + 4 * W, B)).astype(np.int32)
    targets[targets < 0] = 1000
    streams = rng.integers(1000, 1000 + 3 * W, (B, T)).astype(np.int32)
    streams[rng.random((B, T)) < 0.1] = -1
    args = [_on(dev, x) for x in (tags, age, streams, targets)]
    n0 = _build.LAUNCHES["prime_probe"]
    got = probe_ops.probe_verdicts(*args, clock0=2)
    assert _build.LAUNCHES["prime_probe"] == n0 + 1
    want = probe_ref.prime_probe_ref(*args, clock0=2)
    assert torch.equal(got, want)
    assert 0 < int(want.sum()) < B      # both verdicts occur


def test_run_cachex_on_the_card_matches_golden():
    _card()
    _build.reset_counters()
    report = runner.run_cachex("skylake_sp")
    got = dataclasses.asdict(report)
    got.pop("wall_s")
    assert json.loads(json.dumps(got, sort_keys=True)) == \
        json.loads(GOLDEN.read_text())
    assert _build.LAUNCHES["cachesim_engine"] == 361
    assert _build.PLAIN_CALLS["cachesim_engine"] == 0


@pytest.mark.parametrize("policy", ["eevdf", "cas"])
def test_default_fleet_on_the_card_matches_golden(policy):
    """`run_fleet("skylake_sp", policy)` at its default loop on the card
    equals the JAX package's golden (rel 1e-5 on the four fields through
    `fleet_interval_progress`, every other field exactly); the engine
    kernel launched once a physical dispatch and never the plain
    engine."""
    import types
    from repro_torch.core import fleet
    _card()
    cs = _chip_smoke()
    want = next(w for w in json.loads(
        (GOLDEN.parent / "torch_golden_fleet_matrix.json").read_text())
        if (w["platform"], w["policy"], w["cap"])
        == ("skylake_sp", policy, "on"))
    smoke = types.SimpleNamespace(sync=torch.cuda.synchronize)
    report, acct = cs.counted(smoke, lambda: fleet.run_fleet(
        "skylake_sp", policy=policy))
    goldens = cs.goldens()
    assert goldens.fleet_mismatches(goldens.report_fields(report),
                                    want) == []
    cs.require_engine(f"run_fleet({policy})", acct)


# -- the LM kernels: f32 within 2e-5 and bf16 within 2e-2 of the plain
# versions (tests/test_kernels.py:15); both sides compute in full f32
# (no TF32) and differ in the order of their sums.
FA_TOL = {torch.float32: dict(rtol=2e-5, atol=2e-5),
          torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}


def _randn(dev, shape, seed, dtype=torch.float32, scale=1.0):
    a = np.random.default_rng(seed).standard_normal(shape) * scale
    return torch.tensor(a.astype(np.float32), device=dev).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,D,causal", [
    (1, 128, 128, 2, 2, 64, True), (2, 256, 256, 4, 2, 64, True),
    (1, 256, 256, 4, 1, 128, True), (2, 128, 128, 2, 2, 128, False),
    (1, 384, 384, 6, 2, 64, True), (1, 200, 200, 4, 2, 80, True),
    (2, 200, 200, 2, 2, 80, False), (1, 64, 130, 2, 2, 32, True),
    # head dims padded in shared memory (40 -> 48; 96 and 72 -> 80)
    (1, 256, 256, 4, 2, 40, True), (2, 192, 192, 2, 2, 96, False),
    (1, 130, 130, 2, 1, 72, True), (1, 70, 70, 2, 2, 5, True),
    # Sq != Sk both ways, causal and not; a GQA group of 8
    (1, 128, 384, 4, 2, 64, True), (1, 128, 384, 4, 2, 64, False),
    (1, 384, 128, 2, 2, 80, True), (2, 256, 256, 16, 2, 64, True),
    # pixtral-12b's head dim and the one below it, GQA 4, ragged S
    (1, 200, 200, 8, 2, 160, True), (2, 130, 130, 8, 2, 160, False),
    (1, 200, 200, 8, 2, 144, False), (2, 130, 130, 8, 2, 144, True),
    # the wide kernels past 160: GQA, ragged S, Sq != Sk, D 200 no
    # multiple of 16, Q resident (to 320 in f32, 512 in bf16) or streamed
    (1, 200, 200, 8, 2, 176, True), (2, 130, 200, 4, 2, 192, False),
    (1, 200, 130, 4, 2, 200, True), (2, 130, 130, 4, 1, 256, True),
    (1, 70, 200, 2, 2, 288, False), (1, 200, 200, 4, 2, 512, True),
    (1, 130, 130, 2, 2, 640, False),
    # the narrowest head, and a batch past gridDim.y's 65,535
    (1, 64, 64, 2, 2, 1, True), (65537, 8, 8, 1, 1, 16, True)])
def test_flash_attention_kernel_matches_plain(B, Sq, Sk, Hq, Hkv, D, causal,
                                              dtype):
    dev = _card()
    q = _randn(dev, (B, Hq, Sq, D), 1, dtype)
    k = _randn(dev, (B, Hkv, Sk, D), 2, dtype)
    v = _randn(dev, (B, Hkv, Sk, D), 3, dtype)
    n0 = _build.LAUNCHES["flash_attention"]
    got = fa_kernel.flash_attention_bhsd(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["flash_attention"] == \
        n0 + fa_kernel.grid_launches(B, Sq)
    assert got.dtype == dtype
    want = fa_ref.attention_ref(q, k, v, causal)
    torch.testing.assert_close(got.float(), want.float(), **FA_TOL[dtype])
    # the model layout: strided (B, S, H, D) views, no transposed copies
    bshd = fa_ops.flash_attention(q.transpose(1, 2).contiguous(),
                                  k.transpose(1, 2).contiguous(),
                                  v.transpose(1, 2).contiguous(), causal)
    torch.testing.assert_close(bshd.transpose(1, 2).float(), got.float(),
                               rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D,causal", [(64, True), (80, False),
                                      (256, True)])
def test_flash_attention_kernel_reads_views_off_the_16_byte_grid(D, causal,
                                                                dtype):
    """(B, S, H, D) views of wider rows: sequence and head strides that
    are not multiples of 8 (bf16) or 4 (f32) elements, so the kernel's
    loader copies element by element instead of 16 bytes at a time."""
    dev = _card()
    B, S, H = 2, 160, 3
    qkv = [_randn(dev, (B, S, H, D + 1), 30 + i, dtype)[..., :D]
           for i in range(3)]
    assert qkv[0].stride(1) % 8 != 0 and qkv[0].stride(2) % 8 != 0
    got = fa_ops.flash_attention(*qkv, causal)
    want = fa_ref.attention_ref(*(t.transpose(1, 2) for t in qkv), causal)
    torch.testing.assert_close(got.transpose(1, 2).float(), want.float(),
                               **FA_TOL[dtype])


def test_flash_attention_kernel_refuses_what_it_cannot_take():
    """Half precision, and query heads that the kv heads do not divide
    (the Pallas kernel's one refusal); any head dim runs."""
    dev = _card()
    q = torch.zeros(1, 3, 16, 176, device=dev)
    with pytest.raises(ValueError, match="shapes"):
        fa_kernel.flash_attention_bhsd(q, q[:, :2], q[:, :2])
    h = q[..., :64].half()
    with pytest.raises(TypeError):
        fa_kernel.flash_attention_bhsd(h, h, h)


@pytest.mark.parametrize("b,S,h,p,n,chunk", [
    (1, 128, 4, 32, 16, 32), (2, 256, 8, 64, 32, 64),
    (1, 256, 8, 64, 128, 128), (2, 64, 2, 32, 16, 64),
    (2, 512, 80, 64, 64, 128),
    (2, 128, 4, 64, 64, 128),     # one chunk
    (1, 384, 8, 64, 64, 96),      # chunks of 96
    (2, 512, 8, 32, 128, 128),    # p = 32 with n = 128
    (1, 99, 3, 7, 5, 33),         # nothing a multiple of 4
    (1, 512, 2, 64, 128, 256),    # Mamba2's chunk of 256
    (1, 256, 2, 128, 64, 128),    # p = 128
    (1, 256, 2, 64, 256, 128),    # n = 256
    (1, 1024, 2, 32, 32, 512),    # chunks of 512
    (1, 600, 3, 97, 161, 200),    # past every tile, no multiple of 4
    (4100, 32, 1, 4, 4, 2)])      # B nc = 65,600 past gridDim.y's limit
def test_ssd_scan_kernel_matches_plain(b, S, h, p, n, chunk):
    dev = _card()
    x = _randn(dev, (b, S, h, p), 4)
    dt = _randn(dev, (b, S, h), 5, scale=0.5)
    A = -torch.exp(_randn(dev, (h,), 6, scale=0.3))
    Bm = _randn(dev, (b, S, n), 7, scale=0.3)
    Cm = _randn(dev, (b, S, n), 8, scale=0.3)
    D = _randn(dev, (h,), 9)
    n0 = _build.LAUNCHES["ssd_scan"]
    y, st = ssd_ops.ssd_scan(x, dt, A, Bm, Cm, D, chunk=chunk)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["ssd_scan"] == n0 + ssd_kernel.LAUNCHES_PER_CALL
    from repro_torch.models import mamba2
    y_r, st_r = mamba2.ssd_chunked_ref(x, dt, A, Bm, Cm, D, chunk)
    torch.testing.assert_close(y, y_r, rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(st, st_r, rtol=2e-5, atol=2e-5)


def test_ssd_scan_grid_kernel_matches_its_plain_version():
    dev = _card()
    Bz, H, nc, L, p, n = 2, 6, 3, 128, 64, 128
    x = _randn(dev, (Bz, H, nc, L, p), 10)
    dt = torch.nn.functional.softplus(_randn(dev, (Bz, H, nc, L), 11))
    dA = dt * -torch.exp(_randn(dev, (1, H, 1, 1), 12, scale=0.3))
    Bm = _randn(dev, (Bz, nc, L, n), 13, scale=0.3)
    Cm = _randn(dev, (Bz, nc, L, n), 14, scale=0.3)
    y, st = ssd_kernel.ssd_scan_grid(x, dt, dA, Bm, Cm)
    y_r, st_r = ssd_ref.ssd_scan_grid_ref(x, dt, dA, Bm, Cm)
    torch.testing.assert_close(y, y_r, rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(st, st_r, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("Bz,H,nc,L,p,n", [
    (1, 3, 2, 256, 64, 128), (2, 2, 3, 200, 97, 161),
    (1, 2, 2, 128, 130, 257)])
def test_ssd_scan_grid_kernel_walks_its_tiles(Bz, H, nc, L, p, n):
    """The kernel's own function past one tile of rows (128), of p (64)
    and of n (128), against its plain version.  Past 128 rows or 128
    state columns a y or state element sums more than 128 products, the
    kernel's in one chain and the plain version's matmuls in another
    order: as at the full prefill shapes, 1e-4.  (On an H100 at 2e-5, 22
    of 98,304 values of the first case were up to 6.2e-5 apart, and 4 of
    66,560 of the third up to 5.7e-5.)"""
    tol = 1e-4 if L > 128 or n > 128 else 2e-5
    dev = _card()
    x = _randn(dev, (Bz, H, nc, L, p), 15)
    dt = torch.nn.functional.softplus(_randn(dev, (Bz, H, nc, L), 16))
    dA = dt * -torch.exp(_randn(dev, (1, H, 1, 1), 17, scale=0.3))
    Bm = _randn(dev, (Bz, nc, L, n), 18, scale=0.3)
    Cm = _randn(dev, (Bz, nc, L, n), 19, scale=0.3)
    y, st = ssd_kernel.ssd_scan_grid(x, dt, dA, Bm, Cm)
    y_r, st_r = ssd_ref.ssd_scan_grid_ref(x, dt, dA, Bm, Cm)
    torch.testing.assert_close(y, y_r, rtol=tol, atol=tol)
    torch.testing.assert_close(st, st_r, rtol=tol, atol=tol)


@pytest.mark.parametrize("arch", ["zamba2_2p7b", "qwen1p5_0p5b",
                                  "mamba2_2p7b"])
def test_reduced_prefill_on_the_card_runs_the_kernels(arch):
    from repro_torch.configs.base import get_config, reduced_config
    from repro_torch.models import lm
    dev = _card()
    cfg = reduced_config(get_config(arch))
    params = lm.init_params(cfg, 0)
    tokens = torch.randint(0, cfg.vocab, (2, 64), device=dev)
    _build.reset_counters()
    got = lm.prefill(cfg, params, {"tokens": tokens}, torch.float32,
                     "kernel")
    assert _build.PLAIN_CALLS == {}
    assert _build.LAUNCHES["ssd_scan"] == (
        0 if cfg.family == "dense"
        else cfg.n_layers * ssd_kernel.LAUNCHES_PER_CALL)
    want = lm.prefill(cfg, params, {"tokens": tokens}, torch.float32,
                      "ref")
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)


@pytest.mark.parametrize("arch", ["qwen2_moe_a2p7b", "llama4_scout_17b_a16e",
                                  "hubert_xlarge", "pixtral_12b"])
def test_reduced_family_prefill_on_the_card_runs_the_kernels(arch):
    """moe, encoder (frames, bidirectional) and vlm (patches + tokens):
    one flash-attention launch a layer, no plain call, equal to
    `impl="ref"` within 1e-4 (tests/test_torch_lm.py's tolerance)."""
    from repro_torch.configs.base import get_config, reduced_config
    from repro_torch.models import lm
    dev = _card()
    cfg = reduced_config(get_config(arch))
    params = lm.init_params(cfg, 0)
    gen = torch.Generator(device=dev).manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab, (2, 48), device=dev,
                                     generator=gen)}
    if cfg.family == "encoder":
        batch = {"frames": torch.randn((2, 64, cfg.d_input_stub),
                                       device=dev, generator=gen)}
    if cfg.family == "vlm":
        batch["patch_embeds"] = torch.randn(
            (2, cfg.stub_seq, cfg.d_input_stub), device=dev, generator=gen)
    _build.reset_counters()
    got = lm.prefill(cfg, params, batch, torch.float32, "kernel")
    assert _build.PLAIN_CALLS == {}
    assert _build.LAUNCHES["flash_attention"] == cfg.n_layers
    want = lm.prefill(cfg, params, batch, torch.float32, "ref")
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)


# -- the triad and the training path (third slice) ------------------------------------

@pytest.mark.parametrize("rows", [512, 1024, 64, 43688])
def test_triad_kernel_matches_plain_bit_for_bit(rows):
    """tests/test_kernels.py:236's shapes and the monitor's 64 MiB probe
    (43,688 rows, not a multiple of the Pallas block)."""
    dev = _card()
    a = _randn(dev, (rows, 128), 20)
    b = _randn(dev, (rows, 128), 21)
    s = torch.tensor([1.0 / 3.0], device=dev)
    n0 = _build.LAUNCHES["triad"]
    got = probe_ops.probe_triad(a, b, s)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["triad"] == n0 + 1
    assert torch.equal(got, probe_ref.triad_ref(a, b, s))


def test_triad_kernel_ragged_and_misaligned():
    """Element counts that are not a multiple of 4, and pointers off the
    16-byte grid, take the scalar path: still equal bit for bit."""
    dev = _card()
    flat = _randn(dev, (3 * 4100,), 22)
    s = torch.tensor([-2.5], device=dev)
    for lo in (0, 1):              # 16-byte aligned, then off that grid
        a, b = flat[lo:lo + 4099], flat[4100 + lo:8199 + lo]
        assert torch.equal(probe_ops.probe_triad(a, b, s),
                           probe_ref.triad_ref(a, b, s))


@pytest.mark.parametrize("kib", [1, 48, 49, 227])
def test_staged_triad_tiles_match_plain(kib):
    """The staged triad's tile of ``kib`` KiB over a prime row count (its
    last tile partial): equal bit for bit, one launch."""
    dev = _card()
    a = _randn(dev, (10007, 128), 23)
    b = _randn(dev, (10007, 128), 24)
    s = torch.tensor([1.0 / 3.0], device=dev)
    n0 = _build.LAUNCHES["triad_staged"]
    got = probe_kernel.triad(a, b, s, block=2 * kib)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["triad_staged"] == n0 + 1
    assert torch.equal(got, probe_ref.triad_ref(a, b, s))


def test_staged_triad_refuses_a_tile_over_the_limit_and_recovers():
    dev = _card()
    a = _randn(dev, (1000, 128), 25)
    s = torch.tensor([2.0], device=dev)
    limit = torch.cuda.get_device_properties(0).shared_memory_per_block_optin
    n0 = _build.LAUNCHES["triad_staged"]
    with pytest.raises(_build.CudaError) as err:
        probe_kernel.triad(a, a, s, block=limit // 512 + 2)
    assert err.value.code == _build.CUDA_ERROR_INVALID_VALUE
    assert _build.LAUNCHES["triad_staged"] == n0
    got = probe_kernel.triad(a, a, s, block=limit // 512)
    torch.cuda.synchronize()
    assert torch.equal(got, probe_ref.triad_ref(a, a, s))


def test_probe_effective_vmem_finds_the_cards_optin_limit():
    from repro_torch.tpuprobe import vmem_probe
    _card()
    _build.reset_counters()
    eff = vmem_probe.probe_effective_vmem(lo=1024,
                                          hi=vmem_probe.NOMINAL_SMEM,
                                          align=1024)
    assert eff == \
        torch.cuda.get_device_properties(0).shared_memory_per_block_optin
    assert _build.LAUNCHES["triad_staged"] > 0 and not _build.PLAIN_CALLS


def _calibration_launches(mon):
    """The triads of one calibration: five at each size the shrink can
    reach."""
    from repro_torch.tpuprobe import monitor
    return monitor._CALIBRATION_PROBES * len(
        monitor._probe_sizes(mon.default_probe_bytes))


def test_measure_bandwidth_and_monitor_launch_the_triad():
    from repro_torch.tpuprobe.monitor import PodMonitor
    _card()
    _build.reset_counters()
    bw, dt = probe_ops.measure_hbm_bandwidth(64 * (1 << 20), reps=3)
    assert 0 < dt < 1e-4          # device time: no host enqueue inside
    # a timed reading the host did not enqueue in time is taken again:
    # its launches count in REPEATED_LAUNCHES as well
    repeats = _build.REPEATED_LAUNCHES
    assert _build.LAUNCHES["triad"] == 3 + repeats["triad"]
    assert not _build.PLAIN_CALLS
    mon = PodMonitor(2)
    _build.reset_counters()
    samples = mon.probe_once()
    # the first probe calibrates the nominal with its own triads, at each
    # size the shrink can reach, and no later probe does
    calib = _calibration_launches(mon)
    assert calib <= mon._calibration_launches <= calib + repeats["triad"]
    assert _build.LAUNCHES["triad"] == calib + 2 + repeats["triad"]
    assert not _build.PLAIN_CALLS
    assert all(s.effective_bw > 0 and s.slowdown >= 1.0 for s in samples)
    n_cal = mon._calibration_launches
    mon.probe_once()
    assert _build.LAUNCHES["triad"] == calib + 4 + repeats["triad"]
    assert mon._calibration_launches == n_cal


def test_reduced_training_on_the_card(tmp_path):
    """Trainer.run of reduced qwen1.5-0.5b on the card with the real
    monitor: finite losses, one triad launch per step besides the
    monitor's calibration, the plan recorded, and the LM kernels refuse
    gradients there too."""
    from repro_torch.configs.base import ShapeSpec, get_config, reduced_config
    from repro_torch.models import attention, lm
    from repro_torch.tpuprobe.monitor import PodMonitor
    from repro_torch.train import train_step as ts
    from repro_torch.train.trainer import Trainer, TrainerConfig
    dev = _card()
    cfg = reduced_config(get_config("qwen1p5_0p5b"))
    tr = Trainer(cfg, ShapeSpec("s", 64, 8, "train"),
                 ts.TrainHyper(microbatches=2),
                 TrainerConfig(ckpt_dir=str(tmp_path)), monitor=PodMonitor(1))
    _build.reset_counters()
    log = tr.run(4)
    calib, repeats = (_calibration_launches(tr.monitor),
                      _build.REPEATED_LAUNCHES["triad"])
    assert calib <= tr.monitor._calibration_launches <= calib + repeats
    assert _build.LAUNCHES["triad"] == 4 + calib + repeats
    assert not _build.PLAIN_CALLS
    assert all(np.isfinite(r["loss"]) and r["mb_plan"] == [2] for r in log)
    acfg = lm.attn_config(cfg)
    params = attention.init_attention(torch.Generator(device=dev), acfg)
    x = torch.randn((1, 16, cfg.d_model), device=dev, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        attention.attention_train(params, acfg, x, torch.arange(
            16, device=dev)[None], torch.float32, impl="kernel")
