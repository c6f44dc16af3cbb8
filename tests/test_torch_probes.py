"""The card's own probes against the JAX package on the CPU:
`tpuprobe.vmem_probe` (the quantised search, the pickers, the oracle's
narrowed error handling, the staged `triad` that is its oracle on the
card) and `tpuprobe.ici_probe` with `launch.mesh.make_host_mesh` (on an
in-process gloo group of world size 1, and on four gloo processes as a 2
x 2 mesh), as tests/test_runtime.py holds the JAX modules.

The search, the pickers and the synthesized link times are the JAX
arithmetic and are held exactly (the times after scaling by the ratio of
the two packages' ``ICI_BW_PER_LINK``).  The staged triad runs its plain
version here, bit for bit against the Pallas kernel in interpret mode.
"""

import multiprocessing
import queue

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.kernels.cache_probe import kernel as jkernel
from repro.launch import mesh as jmesh
from repro.tpuprobe import ici_probe as jici
from repro.tpuprobe import vmem_probe as jvmem
from repro_torch import _build
from repro_torch.kernels.cache_probe import kernel, ref
from repro_torch.launch import mesh as tmesh
from repro_torch.tpuprobe import ici_probe as tici
from repro_torch.tpuprobe import vmem_probe as tvmem

MiB = 1 << 20


# -- vmem_probe: the search ----------------------------------------------------


@pytest.mark.parametrize("reserved", [0, 2 * MiB, 3 * MiB + 1, 3 * MiB + 12345,
                                      6 * MiB, 6 * MiB + (1 << 18) - 1,
                                      15 * MiB, 16 * MiB, 17 * MiB])
def test_probe_effective_vmem_equals_jax(reserved):
    got = tvmem.probe_effective_vmem(reserved_model=reserved)
    assert got == jvmem.probe_effective_vmem(reserved_model=reserved)
    true_budget = tvmem.NOMINAL_VMEM - reserved
    if got:
        assert got % (1 << 18) == 0 and got <= true_budget
        assert got + (1 << 18) > true_budget


@pytest.mark.parametrize("lo,hi,align", [(1024, 233472, 1024),
                                         (1 << 16, 1 << 22, 1 << 12),
                                         (4 * MiB, 2 * MiB, 1 << 18),
                                         (1, 16 * MiB, 3000)])
def test_probe_search_bounds_equal_jax(lo, hi, align):
    for reserved in (1 * MiB, 13 * MiB + 5, 16 * MiB - 4096):
        assert tvmem.probe_effective_vmem(reserved, lo, hi, align) == \
            jvmem.probe_effective_vmem(reserved, lo, hi, align)


def test_nominal_sizes():
    assert tvmem.NOMINAL_VMEM == jvmem.NOMINAL_VMEM
    # 228 KiB an SM; one block may take _build.SMEM_PER_BLOCK (227 KiB)
    assert tvmem.NOMINAL_SMEM == 228 * 1024
    assert tvmem.NOMINAL_SMEM - _build.SMEM_PER_BLOCK == 1024


# -- vmem_probe: the pickers --------------------------------------------------


@pytest.mark.parametrize("head_dim", [40, 64, 80, 128, 160, 256])
def test_pick_attention_blocks_equal_jax(head_dim):
    for budget in (0, 64 << 10, 227 << 10, 1 * MiB, 4 * MiB, 12 * MiB,
                   14 * MiB, 16 * MiB):
        for dtype_bytes in (2, 4):
            assert tvmem.pick_attention_blocks(budget, head_dim,
                                               dtype_bytes) == \
                jvmem.pick_attention_blocks(budget, head_dim, dtype_bytes)


@pytest.mark.parametrize("head_dim,d_state,chunk", [(64, 128, 128),
                                                   (64, 64, 128),
                                                   (32, 128, 96),
                                                   (128, 256, 256)])
def test_pick_ssd_block_equal_jax(head_dim, d_state, chunk):
    for budget in (0, 227 << 10, 1 * MiB, 4 * MiB, 16 * MiB, 64 * MiB):
        assert tvmem.pick_ssd_block(budget, head_dim, d_state, chunk) == \
            jvmem.pick_ssd_block(budget, head_dim, d_state, chunk)


# -- vmem_probe: the card's oracle -------------------------------------------------


def test_tile_fits_narrowed_except(monkeypatch):
    """A real bug propagates; only a refused tile means "no fit"."""
    def raises(exc):
        def launch(rows):
            raise exc
        return launch

    monkeypatch.setattr(tvmem, "_launch_tile",
                        raises(TypeError("a real bug, not a big tile")))
    with pytest.raises(TypeError):
        tvmem._tile_fits_card(1 << 20)
    monkeypatch.setattr(tvmem, "_launch_tile", raises(_build.CudaError(
        _build.CUDA_ERROR_INVALID_VALUE, "invalid argument")))
    assert tvmem._tile_fits_card(1 << 20) is False
    monkeypatch.setattr(tvmem, "_launch_tile",
                        raises(kernel.TileError("tile does not fit")))
    assert tvmem._tile_fits_card(1 << 20) is False
    monkeypatch.setattr(tvmem, "_launch_tile", raises(_build.CudaError(
        700, "an illegal memory access was encountered")))
    with pytest.raises(_build.CudaError):
        tvmem._tile_fits_card(1 << 20)
    monkeypatch.setattr(tvmem, "_launch_tile", raises(ValueError("shape")))
    with pytest.raises(ValueError):
        tvmem._tile_fits_card(1 << 20)


def test_card_search_finds_the_largest_tile_the_launch_takes(monkeypatch):
    """The search on the card's terms (lo 1 KiB, hi 228 KiB, align 1 KiB)
    with the launch refusing above a limit: it returns the limit, asking
    rows = tile // 512 of each launch."""
    asked = []

    def launch(rows):
        asked.append(rows)
        if rows * 512 > _build.SMEM_PER_BLOCK:
            raise _build.CudaError(_build.CUDA_ERROR_INVALID_VALUE,
                                   "invalid argument")

    monkeypatch.setattr(tvmem, "_launch_tile", launch)
    got = tvmem.probe_effective_vmem(lo=1024, hi=tvmem.NOMINAL_SMEM,
                                     align=1024)
    assert got == _build.SMEM_PER_BLOCK
    assert asked[0] == 2 and len(asked) <= 10


def test_card_oracle_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the probe would run on it")
    with pytest.raises(RuntimeError, match="CUDA"):
        tvmem.probe_effective_vmem(lo=1024, hi=tvmem.NOMINAL_SMEM,
                                   align=1024)


# -- the staged triad (its plain version here) ---------------------------------


@pytest.mark.parametrize("rows,block", [(64, 8), (70, 8), (5, 8), (454, 454),
                                        (1000, 454), (1, 1)])
def test_staged_triad_equals_plain_and_counts(rows, block):
    rng = np.random.default_rng(rows)
    a = torch.as_tensor(rng.standard_normal((rows, 128)), dtype=torch.float32)
    b = torch.as_tensor(rng.standard_normal((rows, 128)), dtype=torch.float32)
    s = torch.tensor([1.0 / 3.0])
    _build.reset_counters()
    got = kernel.triad(a, b, s, block=block)
    assert torch.equal(got, ref.triad_ref(a, b, s))
    assert dict(_build.PLAIN_CALLS) == {"triad_staged": 1}
    assert not _build.LAUNCHES


@pytest.mark.parametrize("rows,block", [(64, 16), (512, 128)])
def test_staged_triad_equals_the_pallas_kernel(rows, block):
    """Where the Pallas kernel takes the tile (N a multiple of block), on
    tests/test_kernels.py:236's exact inputs (XLA may fuse the
    multiply-add, so random inputs would test its rounding, not the
    tile); random inputs against numpy's two roundings."""
    a = np.arange(rows * 128, dtype=np.float32).reshape(rows, 128)
    b = np.full((rows, 128), 2.0, np.float32)
    s = np.array([3.0], np.float32)
    want = np.asarray(jkernel.triad(jnp.asarray(a), jnp.asarray(b),
                                    jnp.asarray(s), block=block,
                                    interpret=True))
    got = kernel.triad(*(torch.from_numpy(x) for x in (a, b, s)),
                       block=block)
    np.testing.assert_array_equal(got.numpy(), want)
    rng = np.random.default_rng(rows)
    a, b = (rng.standard_normal((rows + 3, 128)).astype(np.float32)
            for _ in range(2))
    s = np.array([1.0 / 3.0], np.float32)
    got = kernel.triad(*(torch.from_numpy(x) for x in (a, b, s)),
                       block=block)
    np.testing.assert_array_equal(got.numpy(), (a * s[0]) + b)


def test_staged_triad_refuses_bad_tiles():
    a = torch.zeros((4, 128))
    s = torch.ones(1)
    with pytest.raises(ValueError):
        kernel.triad(a, a, s, block=0)
    with pytest.raises(ValueError):
        kernel.triad(torch.zeros(4, 64), torch.zeros(4, 64), s, block=2)
    with pytest.raises(kernel.TileError):
        kernel.triad(a, a, s, block=(kernel.MAX_TILE_BYTES // 512) + 1)
    assert issubclass(kernel.TileError, ValueError)


# -- ici_probe on gloo ----------------------------------------------------------


@pytest.fixture
def gloo_world_of_one(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    yield
    dist.destroy_process_group()


LINK_MODELS = {"none": None,
               "data2": lambda ax, h: 2.0 if ax == "data" else 1.0,
               "model_hop0": lambda ax, h: 1.7 if (ax, h) == ("model", 0)
               else 1.0}


@pytest.mark.parametrize("model", sorted(LINK_MODELS))
def test_probe_axes_world_of_one_equals_jax(gloo_world_of_one, model):
    link = LINK_MODELS[model]
    mesh = tmesh.make_host_mesh()
    assert mesh.mesh_dim_names == ("data", "model")
    assert tuple(mesh.shape) == (1, 1) and mesh.device_type == "cpu"
    got = tici.probe_axes(mesh, link_model=link, n_floats=64)
    want = jici.probe_axes(jmesh.make_host_mesh(), link_model=link,
                           n_floats=64)
    assert set(got) == set(want) == {"data", "model"}
    ratio = tmesh.ICI_BW_PER_LINK / jmesh.ICI_BW_PER_LINK
    for axis in got:
        assert got[axis]["size"] == want[axis]["size"] == 1
        if link is None:
            assert got[axis]["psum_s"] > 0 and got[axis]["ring_s"] > 0
            continue
        assert got[axis]["slowdown"] == want[axis]["slowdown"]
        for k in ("psum_s", "ring_s"):
            assert got[axis][k] * ratio == pytest.approx(want[axis][k],
                                                         rel=1e-12)
    if link is not None:
        assert tici.rank_axes_by_health(got) == \
            jici.rank_axes_by_health(want)
        for axis in got:
            assert tici.degraded_hops(mesh, axis, link) == \
                jici.degraded_hops(jmesh.make_host_mesh(), axis, link)


def test_probes_on_a_world_of_one_return_their_input(gloo_world_of_one):
    mesh = tmesh.make_host_mesh()
    x = torch.arange(8, dtype=torch.float32)
    for axis in ("data", "model"):
        psum, _ = tici._axis_psum_probe(mesh, axis, 8)
        ring, _ = tici._ring_permute_probe(mesh, axis, 8)
        assert torch.equal(psum(x), x) and torch.equal(ring(x), x)


def test_make_host_mesh_needs_a_process_group():
    if dist.is_initialized():
        pytest.skip("a process group is running in this worker")
    with pytest.raises(RuntimeError, match="process group"):
        tmesh.make_host_mesh()


def test_rank_axes_by_health_equals_jax():
    stats = {"a": {"slowdown": 1.4}, "b": {"slowdown": 1.0},
             "c": {"slowdown": 3.0}, "d": {"slowdown": 1.4}}
    assert tici.rank_axes_by_health(stats) == \
        jici.rank_axes_by_health(stats) == ["b", "a", "d", "c"]


def _mesh_worker(rank, world, store, out):
    """One rank of a 2 x 2 gloo mesh: the psum and ring of rank-valued
    data on each axis, and probe_axes with a degraded ``data`` axis."""
    try:
        dist.init_process_group("gloo", init_method=f"file://{store}",
                                world_size=world, rank=rank)
        mesh = tmesh.make_host_mesh(model=2)
        res = {"shape": tuple(mesh.shape)}
        for axis in ("data", "model"):
            psum, _ = tici._axis_psum_probe(mesh, axis, 4)
            ring, _ = tici._ring_permute_probe(mesh, axis, 4)
            x = torch.full((4,), float(rank))
            res[axis] = (psum(x).tolist(), ring(x).tolist())
        stats = tici.probe_axes(
            mesh, link_model=lambda ax, h: 2.5 if ax == "data" else 1.0,
            n_floats=16)
        res["ranked"] = tici.rank_axes_by_health(stats)
        res["sizes"] = {a: s["size"] for a, s in stats.items()}
        res["timed"] = sorted(tici.probe_axes(mesh, n_floats=16))
        dist.destroy_process_group()
        out.put((rank, res))
    except Exception as e:  # report to the parent, which fails the test
        out.put((rank, repr(e)))


def test_probe_axes_on_four_gloo_processes(tmp_path):
    """Ranks 0..3 as (data, model) = (r // 2, r % 2): the psum's mean over
    each axis and the ring's value from the previous rank of the axis."""
    ctx = multiprocessing.get_context("spawn")
    out = ctx.Queue()
    procs = [ctx.Process(target=_mesh_worker,
                         args=(r, 4, str(tmp_path / "store"), out))
             for r in range(4)]
    for p in procs:
        p.start()
    got = {}
    try:
        for _ in range(4):
            rank, res = out.get(timeout=60)
            got[rank] = res
    except queue.Empty:
        pass
    finally:
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join()
    assert sorted(got) == [0, 1, 2, 3], got
    for rank, res in got.items():
        assert isinstance(res, dict), res
        d, m = divmod(rank, 2)
        data_peer = 2 * (1 - d) + m        # the other rank of the data axis
        model_peer = 2 * d + (1 - m)
        assert res["shape"] == (2, 2)
        assert res["data"] == ([(rank + data_peer) / 2] * 4,
                               [float(data_peer)] * 4)
        assert res["model"] == ([(rank + model_peer) / 2] * 4,
                                [float(model_peer)] * 4)
        assert res["ranked"] == ["model", "data"]
        assert res["sizes"] == {"data": 2, "model": 2}
        assert res["timed"] == ["data", "model"]
