"""`chip_smoke.py`'s readouts that need no card: the completeness check of
the SSD stage readout (`stage_readout`, which `ssd_stage_us` applies to
each torch.profiler record), and path (vii)'s arithmetic: the card's
peaks taken from the port (`launch.mesh`), the model-FLOPs share from
`launch.roofline`, and the split of `count_params`' gap to the built
parameters."""

import importlib.util
from pathlib import Path

import pytest

from repro_torch.configs.base import get_config
from repro_torch.launch import mesh, roofline

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_ssd_stages_are_the_kernels_of_the_source(smoke):
    """The four names are the CUDA kernels of csrc/ssd_scan.cu."""
    src = (ROOT / "src/repro_torch/csrc/ssd_scan.cu").read_text()
    assert len(smoke.SSD_STAGES) == 4
    for name in smoke.SSD_STAGES:
        assert f"    {name}(" in src


def test_ssd_stage_readout_with_all_four_is_complete(smoke):
    seen = {"ssd_cb": 6.0, "ssd_states": 132.0, "ssd_carry": 68.0,
            "ssd_out": 330.0, "spin_kernel": 9.0}
    stages, lost = smoke.stage_readout(seen)
    assert lost == []
    assert stages == {k: seen[k] for k in smoke.SSD_STAGES}


@pytest.mark.parametrize("missing", ["ssd_cb", "ssd_states", "ssd_carry",
                                     "ssd_out"])
def test_ssd_stage_readout_names_a_lost_stage(smoke, missing):
    """Three of the four recorded: the fourth is named as lost and reads
    None, so the row never looks whole."""
    seen = {k: 1.0 for k in smoke.SSD_STAGES if k != missing}
    stages, lost = smoke.stage_readout(seen)
    assert lost == [missing]
    assert list(stages) == list(smoke.SSD_STAGES)
    assert stages[missing] is None
    assert all(stages[k] == 1.0 for k in seen)


def test_ssd_stage_readout_of_an_empty_profile_loses_all(smoke):
    stages, lost = smoke.stage_readout({})
    assert lost == list(smoke.SSD_STAGES)
    assert set(stages.values()) == {None}


def test_path_vii_is_in_the_script(smoke):
    """The cost model's path and its pieces are there; the hand count of
    matmul weights and the script's own bf16 peak are gone."""
    for name in ("cost_model_path", "elastic_restore", "model_flops_share",
                 "param_count_gap", "peak_flops", "hbm_bw"):
        assert callable(getattr(smoke, name)), name
    for gone in ("matmul_params", "BF16_FLOPS_PER_S", "HBM_BYTES_PER_S"):
        assert not hasattr(smoke, gone), gone
    src = (ROOT / "chip_smoke.py").read_text()
    assert "cost_model_path(smoke, card, out)" in src
    assert "elastic_restore(smoke, card, ckpt_dir" in src


def test_the_scripts_peaks_are_the_ports(smoke):
    assert smoke.peak_flops("bfloat16") == mesh.PEAK_FLOPS_BF16 == 989e12
    assert smoke.peak_flops("float32") == smoke.ALU_OPS_PER_S == 67e12
    assert smoke.hbm_bw() == mesh.HBM_BW


@pytest.mark.parametrize("dtype,train", [("bfloat16", True),
                                         ("float32", False)])
def test_model_flops_share_is_the_roofline_count(smoke, dtype, train):
    cfg = get_config("qwen1p5_0p5b")
    sh = smoke.model_flops_share(cfg, 16384, 2.5, dtype, train=train)
    flops = roofline.model_flops_per_token(cfg) * 16384 * (3 if train else 1)
    assert sh["model_flops"] == flops
    assert sh["share"] == flops / 2.5 / smoke.peak_flops(dtype)


# the models chip_smoke builds at full width, and the gap each leaves to
# count_params, split (computed from the configs' arithmetic)
GAPS = {"zamba2_2p7b": {"norms": 427_520, "biases": 283_392,
                        "ssm head vectors": 12_960},
        "qwen1p5_0p5b": {"norms": 50_176, "biases": 73_728},
        "qwen2_moe_a2p7b": {"norms": 100_352, "biases": 147_456,
                            "shared-expert gate": 49_152},
        "pixtral_12b": {"norms": 414_720, "patch projection": 5_242_880},
        "hubert_xlarge": {"norms": 124_160, "unused w_gate": 314_572_800}}


@pytest.mark.parametrize("arch", sorted(GAPS))
def test_param_count_gap_is_what_count_params_leaves_out(smoke, arch):
    from repro_torch._tree import tree_leaves
    from repro_torch.models import lm
    cfg = get_config(arch)
    built = sum(t.numel() for t in tree_leaves(lm.abstract_params(cfg)))
    g = smoke.param_count_gap(cfg, built)
    assert g["count_params"] == roofline.count_params(cfg)
    assert g["parts"] == GAPS[arch] and g["rest"] == 0
    assert g["gap"] == sum(GAPS[arch].values())
    if arch == "hubert_xlarge":
        assert g["gap"] == smoke.HUBERT_GAP == 48 * 1280 * 5120 + 124_160
    with pytest.raises(AssertionError, match="built"):
        smoke.param_count_gap(cfg, built + 1)


def test_path_ix_runs_the_moe_encoder_and_vlm_cells(smoke):
    """Path (ix)'s cells: the dense and hybrid four, then qwen2-moe-a2.7b
    under both dispatches and llama4-scout-17b-a16e training (2
    microbatches each), and the hubert-xlarge and pixtral-12b prefills;
    each has its golden record at its microbatches and at the default
    ones."""
    import json
    from tests import torch_goldens as tg
    assert smoke.DRYRUN_RUN == (
        ("qwen2.5-14b", "train_4k", False, 2, "gshard"),
        ("qwen2.5-14b", "train_4k", True, 2, "gshard"),
        ("zamba2-2.7b", "prefill_32k", False, None, "gshard"),
        ("qwen2.5-14b", "decode_32k", False, None, "gshard"),
        ("qwen2-moe-a2.7b", "train_4k", False, 2, "gshard"),
        ("qwen2-moe-a2.7b", "train_4k", False, 2, "sorted"),
        ("llama4-scout-17b-a16e", "train_4k", False, 2, "gshard"),
        ("hubert-xlarge", "prefill_32k", False, None, "gshard"),
        ("pixtral-12b", "prefill_32k", False, None, "gshard"))
    full = json.loads(smoke.DRYRUN_GOLDEN.read_text())["full"]
    for arch, shape, mp, nm, impl in smoke.DRYRUN_RUN:
        rec = full[tg.dryrun_cell_name(arch, shape, mp, nm, impl)]
        default = full[tg.dryrun_cell_name(arch, shape, mp, moe_impl=impl)]
        assert rec["memory_analysis"]["argument_bytes"] == \
            default["memory_analysis"]["argument_bytes"]
        assert rec["analytic"]["microbatches"] == (nm or 1)


@pytest.mark.parametrize("arch,launches", [
    ("zamba2-2.7b", {"flash_attention": 9, "ssd_scan": 216}),
    ("hubert-xlarge", {"flash_attention": 48}),
    ("pixtral-12b", {"flash_attention": 40})])
def test_path_ix_prefill_launches(smoke, arch, launches):
    assert smoke.dryrun_launches(arch) == launches


def test_ssd_weight_bytes_are_what_the_column_groups_gather(smoke):
    """`ssd_weight_bytes` of reduced zamba2 (d_model 256, the dry run's)
    equals the all-gathers its prefill issues in models/mamba2.py on 16 x
    16, as `dryrun.compile_cell` records them by site."""
    import torch
    from repro_torch.configs.base import ShapeSpec, reduced_config
    from repro_torch.launch import dryrun
    from tests.torch_goldens import DRYRUN_D_MODEL, DRYRUN_PREFILL
    cfg = reduced_config(get_config("zamba2_2p7b"),
                         d_model=DRYRUN_D_MODEL["zamba2_2p7b"])
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        rec = dryrun.compile_cell(cfg, ShapeSpec(*DRYRUN_PREFILL), False,
                                  device="cpu")
    finally:
        torch.set_num_threads(threads)
    sites = rec["collectives"]["by_site"]
    assert sum(sites.values()) == rec["collectives"]["total_bytes_per_device"]
    gathered = sum(v for k, v in sites.items() if k.startswith("all-gather")
                   and "models/mamba2.py" in k)
    assert gathered == smoke.ssd_weight_bytes(cfg) > 0


def _placement_records(smoke, decode=0, norm=0, extra=0, pod=0):
    """Path (ix)'s records as `placement_checks` reads them, each check
    met with no room, and moved by the given bytes."""
    cfg = get_config("zamba2-2.7b")
    shard = 1000 * 4 // 16
    train = {"analytic": {"microbatches": 2, "params_global": 1000}}
    sites = {"all-gather models/mamba2.py:1 _proj_and_conv":
             smoke.ssd_weight_bytes(cfg)}
    if norm:
        sites["all-gather models/mamba2.py:2 gated_rms_norm"] = norm
    records = {
        smoke.DRYRUN_DECODE: {"collectives": {
            "total_bytes_per_device": 100 + decode, "by_kind": {}}},
        smoke.DRYRUN_SSD: {"arch": cfg.name,
                           "collectives": {"by_site": sites}},
        smoke.DRYRUN_PODS[0]: {**train, "collectives": {
            "by_kind": {"all-reduce": 10}, "by_group_size": {}}},
        smoke.DRYRUN_PODS[1]: {**train, "collectives": {
            "by_kind": {"all-reduce": 10 + 2 * shard + extra},
            "by_group_size": {"2": 2 * shard + pod}}}}
    golden = {"full": {smoke.DRYRUN_DECODE: {"collectives": {
        "total_bytes_per_device": 100}}}}
    return records, golden


@pytest.mark.parametrize("moved,faults", [
    ({}, 0), ({"decode": 1}, 1), ({"norm": 2}, 1), ({"extra": 1}, 1),
    ({"pod": 1}, 1), ({"decode": 1, "extra": 1}, 2)])
def test_placement_checks_fail_past_xlas_placements(smoke, moved, faults):
    """`placement_checks` passes path (ix)'s records at its bounds and
    names each placement past them."""
    lines, got = smoke.placement_checks(*_placement_records(smoke, **moved))
    assert len(lines) == 3 and len(got) == faults


def _decode_records(smoke, mem=0, alias=0, coll=0):
    """The two decodes' records as `decode_memory_checks` reads them,
    each at XLA's bounds and moved by the given bytes, and the golden
    they are held to."""
    from tests.torch_goldens import hillclimb_row_name
    blend = hillclimb_row_name(*smoke.HILLCLIMB_BLEND)
    golden = {"full": {smoke.DRYRUN_DECODE: {
        "memory_analysis": {"per_device_bytes": 700, "alias_bytes": 300},
        "collectives": {"total_bytes_per_device": 100}}},
        "hillclimb_full": {blend: {"mem_dev": 800,
                                   "collective_bytes": 200}},
        "hillclimb_memory": {blend: {"alias_bytes": 300}}}
    records = {update: {"memory_analysis": {
        "per_device_bytes": bound + mem, "alias_bytes": 300 + alias},
        "collectives": {"total_bytes_per_device": total + coll}}
        for update, bound, total in (("dus", 700, 100),
                                     ("blend", 800, 200))}
    return records, golden


@pytest.mark.parametrize("moved,faults", [
    ({}, 0), ({"mem": 1}, 2), ({"alias": -1}, 2), ({"coll": 1}, 2),
    ({"mem": -1, "alias": 0, "coll": -1}, 0)])
def test_decode_memory_checks_fail_past_xlas(smoke, moved, faults):
    """`decode_memory_checks` passes both decodes at XLA's per-device
    bytes, alias and raw collective bytes, and names each past them."""
    lines, got = smoke.decode_memory_checks(*_decode_records(smoke,
                                                             **moved))
    assert len(lines) == 2 and len(got) == faults
    assert all("[dus]" in ln or "[blend]" in ln for ln in lines)


def test_moegroup_checks_hold_the_reshape_on_a_reduced_cell(smoke):
    """`moegroup_checks` on reduced qwen2-moe at `DRYRUN_TRAIN_GROUP`
    (sequence 1024, groups of 512, 2 microbatches): the `moegroup+mb2`
    cell, its `_regroup` calls counted by `count_calls`, passes against
    the same cell ungrouped (`mb2`), and fails with no reshape counted or
    against itself (the same FLOPs); `count_calls` puts the function
    back."""
    import torch
    from repro_torch.configs.base import ShapeSpec, reduced_config
    from repro_torch.launch import hillclimb
    from repro_torch.models import moe
    from tests.torch_goldens import DRYRUN_TRAIN_GROUP, hillclimb_config
    cfg = hillclimb_config(reduced_config, get_config, "qwen2_moe_a2p7b", ())
    shape = ShapeSpec(*DRYRUN_TRAIN_GROUP)
    fn, threads = moe._regroup, torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        regroups, restore = smoke.count_calls(moe, "_regroup")
        try:
            grouped, _ = hillclimb._measure(cfg, shape, "moegroup+mb2",
                                            False, device="cpu")
        finally:
            restore()
        ungrouped, _ = hillclimb._measure(cfg, shape, "mb2", False,
                                          device="cpu")
    finally:
        torch.set_num_threads(threads)
    assert moe._regroup is fn
    assert regroups[0] >= 2 * cfg.n_layers * 2
    assert smoke.moegroup_checks(grouped, ungrouped, regroups[0], cfg)[1] \
        == []
    assert len(smoke.moegroup_checks(grouped, ungrouped, 0, cfg)[1]) == 1
    assert len(smoke.moegroup_checks(grouped, grouped, regroups[0],
                                     cfg)[1]) == 1
