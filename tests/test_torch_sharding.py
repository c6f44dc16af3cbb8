"""The sharding rules as DTensor placements, against the JAX package on the
CPU: `distributed.sharding` (`resolve`, `logical_axes_for`, `param_spec`,
`param_sharding`), the rule functions of `train.train_step`
(`arch_rules`, `batch_specs`, `state_shardings`, `cache_shardings`) on
the two production meshes, `distributed.elastic` (`replan_batch`, and
`restore_on_mesh` on four gloo processes as a 2 x 2 mesh) and
`launch.mesh.make_production_mesh`'s refusal of a world it does not fit.

JAX's meshes are ``jax.sharding.AbstractMesh``es (no devices); the port's
rules take anything with ``mesh_dim_names`` and ``shape``.  A spec is
compared by its contents (``tuple(PartitionSpec)``); a sharding by its
placements against the placements a JAX spec names, worked here
independently of the port's conversion.
"""

import functools
import itertools
import math
import multiprocessing
import queue
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh, NamedSharding, PartitionSpec
from torch.distributed.tensor import DTensor, Replicate, Shard, \
    distribute_tensor

from repro.configs import base as jbase
from repro.distributed import elastic as jelastic
from repro.distributed import sharding as jshd
from repro.models import lm as jlm
from repro.train import train_step as jts
from repro_torch._tree import tree_flatten_with_path
from repro_torch.checkpoint import ckpt
from repro_torch.configs import base as tbase
from repro_torch.distributed import elastic as telastic
from repro_torch.distributed import sharding as tshd
from repro_torch.launch import mesh as tmesh
from repro_torch.models import lm as tlm
from repro_torch.train import train_step as tts
from tests import _torch_gloo

ARCHS = jbase.ARCH_IDS
MESHES = {"pod1": ((16, 16), ("data", "model")),
          "pod2": ((2, 16, 16), ("pod", "data", "model"))}


def _meshes(name):
    shape, names = MESHES[name]
    return (AbstractMesh(shape, names),
            types.SimpleNamespace(mesh_dim_names=names, shape=shape))


def _oracle(spec, names):
    """The placements a spec names: Shard(d) on each mesh dim that tensor
    dim d is split over, Replicate() elsewhere."""
    out = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        for name in (entry if isinstance(entry, tuple)
                     else () if entry is None else (entry,)):
            out[names.index(name)] = Shard(d)
    return out


def _jax_leaves(tree):
    """{path: leaf} of a JAX tree of specs or shardings."""
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, PartitionSpec))
    return {jshd.path_str(p): x for p, x in flat}


def _port_leaves(tree):
    return {tshd.path_str(p): x for p, x in tree_flatten_with_path(tree)}


def _spec(x):
    return tuple(x.spec if isinstance(x, NamedSharding) else x)


@functools.lru_cache(maxsize=None)
def _abstract_params(arch):
    return (jlm.abstract_params(jbase.get_config(arch)),
            tlm.abstract_params(tbase.get_config(arch)))


# -- resolve and the spec -> placements conversion ------------------------------

LOGICAL = tuple(jshd.DEFAULT_RULES) + ("unknown",)


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_resolve_equals_jax(mesh):
    jm, tm = _meshes(mesh)
    variants = [jshd.DEFAULT_RULES,
                jts.arch_rules(jbase.get_config("qwen1p5_0p5b")),
                jts.arch_rules(jbase.get_config("yi_6b")),
                {**jshd.DEFAULT_RULES, "batch": ("data",), "seq": "model",
                 "embed": ("pod", "model")}]
    n = 0
    for rules in variants:
        for k in (1, 2, 3):
            for logical in itertools.combinations(LOGICAL, k):
                got = tshd.resolve(dict(rules), tm, *logical)
                assert got == tuple(jshd.resolve(rules, jm, *logical)), \
                    logical
                n += 1
    assert n == 4 * sum(math.comb(len(LOGICAL), k) for k in (1, 2, 3))


def test_placements_refuse_a_mesh_dim_named_twice():
    jm, tm = _meshes("pod2")
    with pytest.raises(Exception, match="duplicate entries"):
        NamedSharding(jm, PartitionSpec("data", "data"))
    with pytest.raises(ValueError, match="'data'"):
        tshd.placements(("data", "data"), tm)
    with pytest.raises(ValueError, match="'model'"):
        tshd.placements((("pod", "model"), None, "model"), tm)
    # a tensor dim split over mesh dims in an order a DTensor cannot take
    with pytest.raises(ValueError, match="order"):
        tshd.placements((("data", "pod"),), tm)
    assert tshd.placements((("pod", "data"), None, "model"), tm) == \
        [Shard(0), Shard(0), Shard(2)]
    assert tshd.placements((), tm) == [Replicate()] * 3


# -- parameters -----------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_and_shardings_equal_jax(arch):
    """Every leaf of the abstract parameters, by path, on both meshes, with
    the default rules and the arch's."""
    jparams, tparams = _abstract_params(arch)
    jcfg, tcfg = jbase.get_config(arch), tbase.get_config(arch)
    shapes = {p: tuple(x.shape) for p, x in _port_leaves(tparams).items()}
    assert shapes == {p: tuple(x.shape)
                      for p, x in _jax_leaves(jparams).items()}
    for path, shape in shapes.items():
        assert tshd.logical_axes_for(path, len(shape)) == \
            jshd.logical_axes_for(path, len(shape)), path
    for mesh in MESHES:
        jm, tm = _meshes(mesh)
        names = MESHES[mesh][1]
        for jrules, trules in ((None, None), (jts.arch_rules(jcfg),
                                              tts.arch_rules(tcfg))):
            want = _jax_leaves(jshd.param_spec(jparams, jm, jrules))
            got = _port_leaves(tshd.param_spec(tparams, tm, trules))
            assert got == {p: tuple(s) for p, s in want.items()}
            placed = _port_leaves(tshd.param_sharding(tparams, tm, trules))
            assert placed == {p: _oracle(s, names) for p, s in want.items()}
            if jrules is not None:
                jplaced = _jax_leaves(jshd.param_sharding(jparams, jm,
                                                          jrules))
                assert {p: _spec(s) for p, s in jplaced.items()} == got


@pytest.mark.parametrize("compress", [False, True])
def test_state_shardings_equal_jax(compress):
    jcfg = jbase.get_config("qwen1p5_0p5b")
    tcfg = tbase.get_config("qwen1p5_0p5b")
    jstate = jts.abstract_train_state(
        jcfg, jts.TrainHyper(compress_cross_pod=compress))
    tstate = tts.abstract_train_state(
        tcfg, tts.TrainHyper(compress_cross_pod=compress))
    for mesh in MESHES:
        jm, tm = _meshes(mesh)
        want = _jax_leaves(jts.state_shardings(jcfg, jm, jstate))
        got = _port_leaves(tts.state_shardings(tcfg, tm, tstate))
        names = MESHES[mesh][1]
        assert got == {p: _oracle(_spec(s), names) for p, s in want.items()}
        assert any(p.startswith(".ef/") for p in got) == compress
        assert got[".opt/.step"] == [Replicate()] * len(names)


# -- batches and caches -----------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_arch_rules_and_batch_specs_equal_jax(arch):
    jcfg, tcfg = jbase.get_config(arch), tbase.get_config(arch)
    assert tts.arch_rules(tcfg) == jts.arch_rules(jcfg)
    for mesh in MESHES:
        jm, tm = _meshes(mesh)
        for shape in jbase.SHAPES:
            tshape = tbase.SHAPE_BY_NAME[shape.name]
            assert tts.arch_rules(tcfg, tshape, tm) == \
                jts.arch_rules(jcfg, shape, jm), (mesh, shape.name)
            for kind in ("train", "prefill", "decode"):
                for s_j, s_t in ((None, None), (shape, tshape)):
                    want = jts.batch_specs(jcfg, jm, kind, s_j)
                    got = tts.batch_specs(tcfg, tm, kind, s_t)
                    assert got == {k: tuple(v) for k, v in want.items()}


DECODERS = [a for a in ARCHS if jbase.get_config(a).supports_decode]


@pytest.mark.parametrize("arch", DECODERS)
def test_cache_shardings_equal_jax(arch):
    """`init_caches` at the two decode shapes (long_500k's one row moves
    the cache's sequence onto "data"), with the arch's rules and with the
    shape's."""
    jcfg, tcfg = jbase.get_config(arch), tbase.get_config(arch)
    for shape in (s for s in jbase.SHAPES if s.kind == "decode"):
        B, S = shape.global_batch, shape.seq_len
        jc = jax.eval_shape(lambda: jlm.init_caches(jcfg, B, S, jnp.bfloat16))
        tc = tlm.init_caches(tcfg, B, S, device="meta")
        assert {p: tuple(x.shape) for p, x in _port_leaves(tc).items()} == \
            {p: tuple(x.shape) for p, x in _jax_leaves(jc).items()}
        for mesh in MESHES:
            jm, tm = _meshes(mesh)
            names = MESHES[mesh][1]
            tshape = tbase.SHAPE_BY_NAME[shape.name]
            for jr, tr in ((None, None),
                           (jts.arch_rules(jcfg, shape, jm),
                            tts.arch_rules(tcfg, tshape, tm))):
                want = _jax_leaves(jts.cache_shardings(jcfg, jm, jc, jr))
                got = _port_leaves(tts.cache_shardings(tcfg, tm, tc, tr))
                assert got == {p: _oracle(_spec(s), names)
                               for p, s in want.items()}, (shape.name, mesh)


# -- shard_hint -------------------------------------------------------------------


@pytest.fixture
def gloo_world_of_one(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    yield
    dist.destroy_process_group()


def test_shard_hint_without_a_dtensor_is_a_no_op():
    _, tm = _meshes("pod1")
    x = torch.ones(4, 8)
    assert tshd.shard_hint(x, "batch", "embed") is x
    with tshd.use_mesh_rules(tm):
        assert tshd.shard_hint(x, "batch", "embed") is x
    assert jshd.shard_hint(jnp.ones((4, 8)), "batch", "embed").shape == (4, 8)


def test_shard_hint_redistributes_a_dtensor(gloo_world_of_one):
    mesh = tmesh.make_host_mesh()
    x = torch.arange(32.0).reshape(4, 8)
    d = distribute_tensor(x, mesh, [Replicate(), Replicate()])
    assert tshd.shard_hint(d, "null", "vocab") is d   # no context
    with tshd.use_mesh_rules(mesh):
        h = tshd.shard_hint(d, "null", "vocab")
    assert isinstance(h, DTensor)
    assert list(h.placements) == [Replicate(), Shard(1)]
    assert torch.equal(h.full_tensor(), x)


# -- meshes -----------------------------------------------------------------------


@pytest.mark.parametrize("multi_pod", [False, True])
def test_make_production_mesh_refuses_a_world_of_one(gloo_world_of_one,
                                                      multi_pod):
    need = 512 if multi_pod else 256
    with pytest.raises(RuntimeError, match=f"{need} ranks.*world size 1"):
        tmesh.make_production_mesh(multi_pod=multi_pod)


def test_make_production_mesh_needs_a_process_group():
    if dist.is_initialized():
        pytest.skip("a process group is running in this worker")
    with pytest.raises(RuntimeError, match="process group"):
        tmesh.make_production_mesh()


# -- elastic ----------------------------------------------------------------------


def _outcome(fn, *args):
    try:
        return fn(*args)
    except (AssertionError, ValueError) as e:
        return type(e)


@pytest.mark.parametrize("global_batch", [1, 6, 8, 12, 64, 96, 256])
def test_replan_batch_equals_jax(global_batch):
    errors = set()
    for old_dp, new_dp, old_mb in itertools.product(
            (1, 2, 4, 8), (1, 2, 3, 4, 8, 16), (1, 2, 4)):
        args = (global_batch, old_dp, new_dp, old_mb)
        got = _outcome(telastic.replan_batch, *args)
        assert got == _outcome(jelastic.replan_batch, *args), args
        if isinstance(got, type):
            errors.add(got)
        else:
            per = global_batch // old_dp // old_mb
            assert new_dp * got * per == global_batch
    # no row a microbatch (the assert) only where the batch is small
    assert errors == ({ValueError} if global_batch >= 64 else
                      {AssertionError, ValueError})


ELASTIC = {"qwen1p5_0p5b": False, "qwen2_moe_a2p7b": True}  # compress


def _local_slice(spec, shape, sizes, coords):
    """The block of a ``shape`` array that ``spec`` gives the device at
    ``coords``: each sharded dim cut into ceil(n / k) rows a shard, its
    mesh dims major to minor."""
    out = []
    for d, n in enumerate(shape):
        entry = spec[d] if d < len(spec) else None
        names = entry if isinstance(entry, tuple) else \
            (() if entry is None else (entry,))
        idx, k = 0, 1
        for name in names:
            idx, k = idx * sizes[name] + coords[name], k * sizes[name]
        c = -(-n // k)
        out.append(slice(idx * c, min((idx + 1) * c, n)))
    return tuple(out)


def test_restore_on_mesh_on_four_gloo_processes(tmp_path):
    """Reduced qwen1.5-0.5b and qwen2-moe-a2.7b (with error buffers)
    states, saved whole, restored on ranks 0..3 as (data, model) = (r // 2,
    r % 2): each rank holds, as DTensors on the CPU, exactly the block the
    JAX package's state sharding names for its coordinates."""
    full, want = {}, {}
    am = AbstractMesh((2, 2), ("data", "model"))
    for arch, compress in ELASTIC.items():
        cfg = tbase.reduced_config(tbase.get_config(arch))
        state = tts.make_train_state(
            cfg, tts.TrainHyper(compress_cross_pod=compress), 7,
            device="cpu")
        ckpt.save(str(tmp_path / arch), 3, state)
        full[arch] = {p: x.numpy() for p, x in _port_leaves(state).items()}
        jcfg = jbase.reduced_config(jbase.get_config(arch))
        want[arch] = {p: _spec(s) for p, s in _jax_leaves(jts.state_shardings(
            jcfg, am, jts.abstract_train_state(
                jcfg, jts.TrainHyper(compress_cross_pod=compress)))).items()}
        assert set(want[arch]) == set(full[arch])
    ctx = multiprocessing.get_context("spawn")
    out = ctx.Queue()
    procs = [ctx.Process(target=_torch_gloo.restore_worker,
                         args=(r, 4, str(tmp_path / "store"),
                               str(tmp_path), 3, list(ELASTIC.items()), out))
             for r in range(4)]
    for p in procs:
        p.start()
    got = {}
    try:
        for _ in range(4):
            rank, res = out.get(timeout=90)
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
    sizes = {"data": 2, "model": 2}
    sharded = 0
    for rank, res in got.items():
        assert isinstance(res, dict), res
        coords = dict(zip(("data", "model"), divmod(rank, 2)))
        assert res["coords"] == [coords["data"], coords["model"]]
        for arch in ELASTIC:
            assert set(res[arch]) == set(full[arch])
            for p, (kind, dev, placed, local) in res[arch].items():
                spec = want[arch][p]
                assert (kind, dev) == ("DTensor", "cpu"), p
                assert placed == _oracle(spec, ("data", "model")), p
                block = full[arch][p][_local_slice(
                    spec, full[arch][p].shape, sizes, coords)]
                np.testing.assert_array_equal(local, block, err_msg=p)
                sharded += local.size < full[arch][p].size
    assert sharded > 0
