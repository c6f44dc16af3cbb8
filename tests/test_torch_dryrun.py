"""The port's dry run and hillclimb driver (`repro_torch.launch.dryrun`,
`repro_torch.launch.hillclimb`) on the CPU, against the ``dryrun`` golden
that the JAX dry run wrote (`tests/torch_goldens.py`: its own
``compile_cell`` on 256 and 512 host devices with ``Auto`` axes).

Each reduced cell of `DRYRUN_CELLS` runs once, as rank 0 of a fake 256-
or 512-rank process group started and destroyed for it.  Held exactly:
the argument bytes against XLA's ``argument_size_in_bytes`` (this rank's
blocks against XLA's per-device shards), the new state's (or caches')
bytes against its ``alias_size_in_bytes`` (what JAX donates), a decode
cell's alias (the caches its step writes in place) against it too, the
analytic costs (``==``), and the compute and memory terms under each
package's peaks.  Collective bytes are printed beside JAX's, never
compared: XLA and DTensor choose different collectives.  The
JAX modules are never imported here (importing them sets ``XLA_FLAGS``
for the whole process).
"""

import json

import pytest
import torch
import torch.distributed as dist

from repro.launch import mesh as jmesh
from repro_torch.configs.base import (ARCH_IDS, SHAPES, ShapeSpec,
                                      get_config, reduced_config)
from repro_torch.launch import dryrun, hillclimb, roofline
from repro_torch.launch import mesh as tmesh
from repro_torch.models import lm
from repro_torch.train import train_step as ts
from tests.torch_goldens import (DATA, DRYRUN_CELLS, DRYRUN_D_MODEL,
                                 DRYRUN_PREFILL, DRYRUN_SKIPS, HYPER_FIELDS,
                                 dryrun_cell_name, path_of)

# the group sizes a collective may have on each mesh: a product of some of
# its dims
GROUP_SIZES = {False: {16, 256}, True: {2, 16, 32, 256, 512}}
# counted FLOPs of this rank over the analytic per-device FLOPs: measured
# 1.0 to 3.8 on the reduced cells (the reduced configs replicate their few
# kv heads and SSD heads over "model", so each rank repeats that work); a
# count of the global ops would be 256 or 512 times the analytic figure
FLOPS_RATIO = (0.5, 8.0)


@pytest.fixture(scope="module")
def golden():
    return json.loads(path_of("dryrun", DATA).read_text())


def _key(arch, shape, mp):
    return f"{arch}/{shape.name}/{'multi' if mp else 'single'}"


def test_skip_reason_and_microbatches_equal_jax(golden):
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        for shape in SHAPES:
            assert dryrun.skip_reason(cfg, shape) == \
                golden["skip_reason"][f"{arch}/{shape.name}"]
            for mp in (False, True):
                assert dryrun.default_microbatches(cfg, shape, mp) == \
                    golden["default_microbatches"][_key(arch, shape, mp)]


def test_hyper_for_equals_jax_for_every_variant(golden):
    n = 0
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        for shape in SHAPES:
            for mp in (False, True):
                for variant in hillclimb.VARIANTS:
                    h = hillclimb.hyper_for(variant, cfg, shape, mp)
                    assert {f: getattr(h, f) for f in HYPER_FIELDS} == \
                        golden["hyper_for"][f"{_key(arch, shape, mp)}/"
                                            f"{variant}"]
                    n += 1
    assert n == len(golden["hyper_for"])


@pytest.fixture(scope="module")
def cells():
    """Every reduced cell's record, each on a fake group of its own, on
    one thread: the blocks are tiny, and the time is DTensor's sharding
    propagation in Python."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    out = {}
    try:
        for arch, spec, mp, nm, impl in DRYRUN_CELLS:
            shape = ShapeSpec(*spec)
            hyper = (ts.TrainHyper(microbatches=nm, compress_cross_pod=mp,
                                   moe_impl=impl)
                     if shape.kind == "train" else None)
            out[dryrun_cell_name(arch, shape.name, mp, moe_impl=impl)] = \
                dryrun.compile_cell(reduced_config(
                    get_config(arch), d_model=DRYRUN_D_MODEL.get(arch, 128)),
                    shape, mp, hyper, device="cpu")
    finally:
        torch.set_num_threads(threads)
    assert not dist.is_initialized()
    return out


@pytest.mark.parametrize("arch,spec,mp,nm,impl", DRYRUN_CELLS,
                         ids=[dryrun_cell_name(a, s[0], mp, moe_impl=i)
                              for a, s, mp, _, i in DRYRUN_CELLS])
def test_reduced_cell_equals_jax(cells, golden, arch, spec, mp, nm, impl):
    name = dryrun_cell_name(arch, spec[0], mp, moe_impl=impl)
    got, want = cells[name], golden["cells"][name]
    beside = (f"{name}: collectives by kind, port {got['collectives']} "
              f"beside JAX {want['collectives']}")
    assert got["status"] == want["status"] == "ok", beside
    for k, v in want.items():
        assert k in got, k
        if isinstance(v, dict):
            assert set(v) <= set(got[k]), (k, set(v) - set(got[k]))
    ma, jma = got["memory_analysis"], want["memory_analysis"]
    assert ma["argument_bytes"] == jma["argument_bytes"], beside
    assert ma["state_bytes"] == jma["alias_bytes"], beside
    # a decode step consumes its caches, as JAX's donated step does; the
    # train state is not donated
    decode = spec[3] == "decode"
    assert ma["alias_bytes"] == (jma["alias_bytes"] if decode else 0)
    assert ma["temp_bytes"] == -1
    assert ma["per_device_bytes"] == ma["argument_bytes"] + \
        ma["output_bytes"] - ma["alias_bytes"]
    assert got["analytic"] == want["analytic"], beside
    flops = want["analytic"]["flops_per_device"]
    hbm = want["analytic"]["hbm_bytes_per_device"]
    assert got["roofline"]["compute_s"] == flops / tmesh.PEAK_FLOPS_BF16
    assert want["roofline"]["compute_s"] == flops / jmesh.PEAK_FLOPS_BF16
    assert got["roofline"]["memory_s"] == hbm / tmesh.HBM_BW
    assert want["roofline"]["memory_s"] == hbm / jmesh.HBM_BW
    assert got["n_chips"] == (512 if mp else 256)
    assert got["collectives"]["ops"] > 0, beside
    assert {int(g) for g in got["collectives"]["by_group_size"]} <= \
        GROUP_SIZES[mp], beside
    ratio = got["cost_analysis_raw"]["flops"] / flops
    assert FLOPS_RATIO[0] <= ratio <= FLOPS_RATIO[1], (ratio, beside)


def _sited(cfg, shape, multi_pod=False, hyper=None):
    """`roofline.CollectiveStats` of one call of a reduced cell's step with
    the site of each collective, on a fake group of the mesh's size, on
    one thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with dryrun._fake_group(512 if multi_pod else 256):
            mesh = tmesh.make_production_mesh(multi_pod=multi_pod,
                                              device="cpu")
            step, args = dryrun._cell_step(cfg, shape, mesh, hyper, "cpu")
            _, stats, _, _, _ = dryrun._run_measured(step, args, "cpu")
    finally:
        torch.set_num_threads(threads)
    return stats


@pytest.mark.parametrize("cache_update", ["dus", "blend"])
def test_decode_collectives_do_not_grow_with_the_cache(capsys, cache_update):
    """Reduced qwen1.5-0.5b's decode on 16 x 16: its 4 kv heads are fewer
    than the 16 "model" ranks, so its kv cache is split along its
    sequence over "model" (JAX's ``cache_seq``), and each rank attends
    over its own positions, the ranks' partial softmaxes combined
    (`attention._decode_on_blocks`).  The collective bytes by kind are
    the same at cache lengths 64 and 256, for both cache writes (the
    cache was gathered each layer: 2,048 B more a cached position)."""
    cfg = reduced_config(get_config("qwen1p5_0p5b"))
    variant = "blend" if cache_update == "blend" else "baseline"
    got = {seq: hillclimb._run(cfg, ShapeSpec("dry_decode", seq, 32,
                                              "decode"),
                               variant, False, show_top=False,
                               device="cpu")["by_kind"]
           for seq in (64, 256)}
    assert got[64] == got[256]
    assert got[64]["all-reduce"] > 0
    assert not dist.is_initialized()


@pytest.mark.parametrize("cache_update", ["dus", "blend"])
def test_placed_decode_step_consumes_its_caches(cache_update):
    """`jit_decode_step`'s step on reduced qwen1.5-0.5b's dry decode cell
    (rank 0 of the fake 256-rank group, the cache split along its
    sequence over "model") returns its given caches, each rank's block
    written in place (``to_local().data_ptr()`` kept), as JAX's step
    donates them; the logits are a new tensor, and the dry run reports
    the caches' bytes as its alias."""
    cfg = reduced_config(get_config("qwen1p5_0p5b"))
    shape = ShapeSpec("dry_decode", 64, 32, "decode")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with dryrun._fake_group(256):
            mesh = tmesh.make_production_mesh(device="cpu")
            step, args = dryrun._cell_step(cfg, shape, mesh, None, "cpu",
                                           cache_update)
            given = lm._map(lambda c: c.to_local().data_ptr(), args[1])
            logits, caches = step(*args)
            assert lm._map(lambda c: c.to_local().data_ptr(),
                           caches) == given
            assert dryrun._alias_bytes(args, (logits, caches)) == \
                dryrun._local_bytes(caches) > 0
            assert logits.to_local().data_ptr() not in {
                x.data_ptr() for x in dryrun._local_blocks(args)}
    finally:
        torch.set_num_threads(threads)
    assert not dist.is_initialized()


def test_reduced_ssd_block_moves_no_activation_of_its_width():
    """Reduced zamba2's prefill on 16 x 16: the Mamba2 in-projection, its
    five-way split and the causal conv move only the weights between
    ranks (`mamba2._proj_and_conv`: the packed columns' shards end at no
    group's boundary, so each rank takes its groups' columns of the
    gathered weight), once a layer each: ``in_proj``, ``conv_w`` and
    ``conv_b`` in bf16.  The gated norm all-reduces each row's sum of
    squares (B_l x S x 1 in f32) and gathers nothing.  Before, the product
    was split where DTensor put it (the weight gathered to meet a pending
    sum, the norm's input gathered)."""
    arch = "zamba2_2p7b"
    cfg = reduced_config(get_config(arch), d_model=DRYRUN_D_MODEL[arch])
    stats = _sited(cfg, ShapeSpec(*DRYRUN_PREFILL))
    mc = lm.mamba_config(cfg)
    conv = mc.d_inner + 2 * mc.d_state
    weights = (cfg.d_model * (conv + mc.d_inner + mc.n_heads) * 2,
               mc.d_conv * conv * 2, conv * 2)
    mine = [(kind, nbytes, shape, site) for (kind, _, nbytes, shape, _), site
            in zip(stats.calls, stats.sites) if "models/mamba2.py" in site]
    gathers = sorted(nbytes for kind, nbytes, _, _ in mine
                     if kind == "all-gather")
    assert gathers == sorted(weights * cfg.n_layers), mine
    assert all("gated_rms_norm" not in site for kind, _, _, site in mine
               if kind == "all-gather")
    rest = [(kind, shape) for kind, _, shape, site in mine
            if kind != "all-gather"]
    assert rest and all(kind == "all-reduce" and shape[-1] == 1
                        for kind, shape in rest), rest
    assert len(rest) == cfg.n_layers


def test_multi_pod_gradient_all_reduces_one_data_shard_a_microbatch(cells,
                                                                    golden):
    """The multi-pod train cell all-reduces at most one data shard of the
    f32 parameters (729,088 x 4 B over 16 "data" ranks) a microbatch more
    than the single-pod cell, whose ranks hold the same rows: a gradient
    reaches its FSDP shard by a reduce-scatter over "data" and only that
    shard is all-reduced over "pod" (`sharding.redistribute`'s backward).
    DTensor all-reduced each whole gradient over "pod" first (2,839,628 B
    more)."""
    single = cells["qwen1p5_0p5b_dry_train_single"]
    multi = cells["qwen1p5_0p5b_dry_train_pods_multi"]
    nm = multi["analytic"]["microbatches"]
    assert nm == single["analytic"]["microbatches"] == 2
    shard = golden["cells"]["qwen1p5_0p5b_dry_train_pods_multi"][
        "analytic"]["params_global"] * 4 // 16
    extra = multi["collectives"]["by_kind"]["all-reduce"] - \
        single["collectives"]["by_kind"]["all-reduce"]
    assert 0 < extra <= shard * nm, (extra, shard * nm)


@pytest.mark.parametrize("arch,shape_name,mp", DRYRUN_SKIPS)
def test_skip_records_equal_jax(golden, arch, shape_name, mp):
    assert dryrun.run_cell(arch, shape_name, mp, device="cpu") == \
        golden["skips"][dryrun_cell_name(arch, shape_name, mp)]


def test_main_writes_and_skips_an_existing_record(tmp_path, capsys):
    argv = ["--arch", "hubert-xlarge", "--shape", "decode_32k", "--mesh",
            "single", "--out", str(tmp_path), "--device", "cpu"]
    dryrun.main(argv)
    rec = json.loads((tmp_path / "hubert_xlarge_decode_32k_single.json")
                     .read_text())
    assert rec["status"] == "skipped" and "wall_s" in rec
    dryrun.main(argv)
    out = capsys.readouterr().out.splitlines()
    assert out == ["[skipped] hubert_xlarge_decode_32k_single",
                   "[skip existing] hubert_xlarge_decode_32k_single"]
    assert not dist.is_initialized()


def test_main_refuses_while_another_group_runs(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    try:
        with pytest.raises(RuntimeError, match="gloo process group of 1"):
            dryrun.main(["--arch", "hubert-xlarge", "--shape",
                         "decode_32k", "--mesh", "single", "--out",
                         str(tmp_path / "out"), "--device", "cpu"])
    finally:
        dist.destroy_process_group()


def test_top_collectives_aggregates_and_orders():
    calls = [("all-gather", (0, 1), 100, (2, 5), torch.bfloat16),
             ("all-reduce", (0, 1), 300, (75,), torch.float32),
             ("all-gather", (0, 1), 100, (2, 5), torch.bfloat16),
             ("all-gather", (0, 2), 40, (2, 5), torch.bfloat16),
             ("reduce-scatter", (0, 1), 8, (2,), torch.float32)]
    sites = ["a.py:1 f", "b.py:2 g", "a.py:1 f", "c.py:3 h", "d.py:4 k"]
    stats = roofline.CollectiveStats(
        total_bytes=548, by_kind={}, by_group_size={}, ops=5,
        calls=calls, sites=sites)
    assert hillclimb.top_collectives(stats, k=3) == [
        ("all-reduce", "f32[75]", "b.py:2 g", 300.0),
        ("all-gather", "bf16[2,5]", "a.py:1 f", 200.0),
        ("all-gather", "bf16[2,5]", "c.py:3 h", 40.0)]
    unsited = roofline.CollectiveStats(total_bytes=548, by_kind={},
                                       by_group_size={}, ops=5, calls=calls)
    assert hillclimb.top_collectives(unsited, k=2) == [
        ("all-reduce", "f32[75]", "?", 300.0),
        ("all-gather", "bf16[2,5]", "?", 240.0)]
