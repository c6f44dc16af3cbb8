"""The port's hillclimb driver (`repro_torch.launch.hillclimb`) under
every variant, on the CPU, against the ``dryrun`` golden that the JAX
driver wrote (`tests/torch_goldens.py`: JAX's ``hillclimb.run`` on 256
host devices with ``Auto`` axes, and the memory analysis of the step it
compiled).

Each reduced row of `HILLCLIMB_ROWS` is the cell its variant changes,
run as rank 0 of a fake 256-rank process group: the train variants on
reduced qwen1.5-0.5b or qwen2-moe-a2.7b, "kvrep" on a 16-kv-head decode
(at 4 kv heads the flag changes nothing), "blend" and "replparams" on
the serving cells, measured once (`hillclimb._measure`, the dry run's
record at the variant's config, hyper, cache write and parameter
placement) for both tests of the row.  Held exactly: JAX's record keys,
the compute and memory terms under each package's peaks, XLA's argument
bytes and, for a decode, its alias bytes (the caches the step
consumes).  Collective bytes are printed
beside JAX's, never compared.  Torch computes on one thread: the blocks
are tiny, and the time is DTensor's sharding propagation in Python.  The
JAX modules are never imported here (importing them sets ``XLA_FLAGS``
for the whole process).
"""

import json

import pytest
import torch
import torch.distributed as dist

from repro.launch import mesh as jmesh
from repro_torch.configs.base import ShapeSpec, get_config, reduced_config
from repro_torch.launch import hillclimb
from repro_torch.launch import mesh as tmesh
from tests.torch_goldens import (DATA, HILLCLIMB_FULL, HILLCLIMB_ROWS,
                                 hillclimb_config, hillclimb_row_name,
                                 path_of)

IDS = [hillclimb_row_name(v, a, s[0], r) for v, a, s, r in HILLCLIMB_ROWS]


@pytest.fixture(scope="module")
def golden():
    return json.loads(path_of("dryrun", DATA).read_text())


@pytest.fixture
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    assert not dist.is_initialized()


@pytest.fixture(scope="module")
def measured():
    """Each row's ``(cfg, shape, record, stats)``, its record and stats
    from `hillclimb._measure`, run once for the module:
    ``measured(variant, arch, spec, replaced)``."""
    cache = {}

    def get(*row):
        if row not in cache:
            variant, arch, spec, replaced = row
            cfg = hillclimb_config(reduced_config, get_config, arch,
                                   replaced)
            shape = ShapeSpec(*spec)
            cache[row] = (cfg, shape) + hillclimb._measure(
                cfg, shape, variant, False, device="cpu")
        return cache[row]
    return get


def test_rows_cover_every_variant():
    """Every name of `hillclimb.VARIANTS` and every name `_run` reads
    (``moegroup``, ``cf1``, ``replparams``) runs in a reduced row and in
    a full-width row, "baseline" (path (ix)'s own cells at full width)
    aside."""
    names = set(hillclimb.VARIANTS) | {"moegroup", "cf1", "replparams"}
    for rows in ([r[0] for r in HILLCLIMB_ROWS],
                 [r[0] for r in HILLCLIMB_FULL] + ["baseline"]):
        assert names <= {v.replace("+mb2", "") for v in rows}


@pytest.mark.parametrize("variant,arch,spec,replaced", HILLCLIMB_ROWS,
                         ids=IDS)
def test_hillclimb_on_a_reduced_config_returns_jax_keys(
        golden, capsys, monkeypatch, one_thread, measured, variant, arch,
        spec, replaced):
    """`hillclimb._run` on the reduced row: JAX's keys, JAX's terms under
    each package's peaks, and the top collectives printed with where
    each was issued (a frame of the port, or the autograd node of a
    backward)."""
    cfg, shape, rec, stats = measured(variant, arch, spec, replaced)
    monkeypatch.setattr(hillclimb, "_measure",
                        lambda *a, **k: (rec, stats))
    got = hillclimb._run(cfg, shape, variant, False, device="cpu")
    want = golden["hillclimb"][hillclimb_row_name(variant, arch, shape.name,
                                                  replaced)]
    assert set(got) == set(want)
    assert got["variant"] == want["variant"] == variant
    assert set(got["by_kind"]) == set(want["by_kind"])
    assert got["collective_bytes"] == got["tpu_corrected_bytes"] > 0
    for term, peak, jpeak in (("compute_s", tmesh.PEAK_FLOPS_BF16,
                               jmesh.PEAK_FLOPS_BF16),
                              ("memory_s", tmesh.HBM_BW, jmesh.HBM_BW)):
        assert got["terms"][term] * peak == \
            pytest.approx(want["terms"][term] * jpeak, rel=1e-12)
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith(f"== {cfg.name} x {shape.name} x 16x16 "
                             f"[{variant}]")
    rows = [ln for ln in out if "GiB  " in ln]
    assert rows and all(".py:" in ln or "backward of " in ln
                        for ln in rows), out
    if shape.kind == "train":
        assert any("models/lm.py" in ln or "train/train_step.py" in ln
                   for ln in rows), out


@pytest.mark.parametrize("variant,arch,spec,replaced", HILLCLIMB_ROWS,
                         ids=IDS)
def test_hillclimb_row_argument_bytes_equal_jax(golden, one_thread, measured,
                                                variant, arch, spec,
                                                replaced):
    """The row's cell (the dry run's record at the variant's config,
    `hillclimb.hyper_for`, cache write and parameter placement) holds
    XLA's argument bytes exactly, the reduced dry cells' rule: this
    rank's blocks against XLA's per-device shards.  A decode consumes
    its caches, as JAX's donated step does, so its alias bytes are
    XLA's; a train step's state is not donated (alias 0), and its new
    state's bytes are XLA's alias."""
    _, shape, rec, _ = measured(variant, arch, spec, replaced)
    want = golden["hillclimb_memory"][hillclimb_row_name(
        variant, arch, shape.name, replaced)]
    ma = rec["memory_analysis"]
    assert rec["status"] == "ok"
    assert ma["argument_bytes"] == want["argument_bytes"]
    if shape.kind == "decode":
        assert ma["alias_bytes"] == want["alias_bytes"] == \
            ma["state_bytes"] > 0
    else:
        assert ma["alias_bytes"] == 0
        assert ma["state_bytes"] == want["alias_bytes"]
    assert ma["per_device_bytes"] == ma["argument_bytes"] + \
        ma["output_bytes"] - ma["alias_bytes"]


@pytest.mark.parametrize("variant,arch,shape_name", HILLCLIMB_FULL)
def test_full_width_rows_have_jax_records(golden, variant, arch,
                                          shape_name):
    """Each full-width row `tools/hillclimb_variants.py` runs on the card
    has JAX's record and the memory analysis it was summed from: the
    caches of a decode and the state of a train step aliased, as JAX
    donates them."""
    name = hillclimb_row_name(variant, arch, shape_name)
    rec, ma = golden["hillclimb_full"][name], golden["hillclimb_memory"][name]
    assert rec["variant"] == variant
    assert rec["mem_dev"] == ma["argument_bytes"] + ma["temp_bytes"] + \
        ma["output_bytes"] - ma["alias_bytes"]
    assert (ma["alias_bytes"] > 0) == (not shape_name.startswith("prefill"))
