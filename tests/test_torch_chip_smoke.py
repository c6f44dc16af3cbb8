"""`chip_smoke.py`'s readouts that need no card: the completeness check of
the SSD stage readout (`stage_readout`, which `ssd_stage_us` applies to
each torch.profiler record)."""

import importlib.util
from pathlib import Path

import pytest

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
