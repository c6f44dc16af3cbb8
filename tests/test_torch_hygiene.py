"""Boundaries of the port: it imports neither JAX nor the JAX package, its
entry points need a CUDA card unless the CPU is asked for, its public
surface is a subset of the JAX package's, and `chip_smoke.py` gives no
result without a card."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.core as jcore
import repro_torch
import repro_torch.core as tcore
from repro_torch import _build
from repro_torch.core import cachesim, host_model, platforms

ROOT = Path(__file__).resolve().parents[1]


def test_port_imports_neither_jax_nor_repro():
    code = ("import sys, repro_torch.core, repro_torch.kernels\n"
            "import repro_torch.kernels.cache_probe.ops\n"
            "import repro_torch.kernels.cachesim_step.ops\n"
            "import repro_torch.kernels.flash_attention.ops\n"
            "import repro_torch.kernels.ssd_scan.ops\n"
            "import repro_torch.configs.base, repro_torch.configs.zamba2_2p7b\n"
            "import repro_torch.models.lm, repro_torch.serve.engine\n"
            "import repro_torch.launch.serve\n"
            "import repro_torch.launch.mesh, repro_torch.launch.train\n"
            "import repro_torch.tpuprobe.monitor\n"
            "import repro_torch.distributed.rebalance\n"
            "import repro_torch.distributed.sharding\n"
            "import repro_torch.data.pipeline\n"
            "import repro_torch.optim.adamw, repro_torch.optim.grad_compress\n"
            "import repro_torch.checkpoint.ckpt\n"
            "import repro_torch.train.train_step, repro_torch.train.trainer\n"
            "import repro_torch.core.vtop, repro_torch.core.attacker\n"
            "import repro_torch.core.plancost, repro_torch.core.fleetshard\n"
            "import repro_torch.core.fleet\n"
            "from repro_torch.configs.base import ARCH_IDS, get_config\n"
            "[get_config(a) for a in ARCH_IDS]\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or m.startswith('repro.')]\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          env={"PYTHONPATH": str(ROOT / "src"),
                               "PATH": "/usr/bin:/bin"},
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_public_surface_is_a_subset_of_the_jax_package():
    assert set(tcore.__all__) <= set(jcore.__all__)
    for name in tcore.__all__:
        assert hasattr(tcore, name), name


# the port's names beyond the JAX package's: the weight/cache/state
# carriers, the plain versions of the SSD kernel's own function and of its
# four stages, the plain emulation of the bf16 attention path and the
# triad's device timing
EXTRA = {"repro_torch.models.lm": {"params_from_numpy", "caches_from_numpy"},
         "repro_torch.kernels.ssd_scan.ref": {
             "ssd_scan_grid_ref", "ssd_chunk_cb", "ssd_chunk_states",
             "ssd_carry_states", "ssd_chunk_outputs", "ssd_scan_stages_ref"},
         "repro_torch.kernels.flash_attention.ref": {
             "attention_bf16_probs_ref"},
         "repro_torch.kernels.cache_probe.kernel": {"triad_device_seconds"},
         "repro_torch.train.train_step": {"train_state_from_numpy"}}


@pytest.mark.parametrize("name", [
    "configs.base", "models.layers", "models.attention", "models.mamba2",
    "models.lm", "serve.engine", "launch.serve",
    "kernels.flash_attention.ref",
    "kernels.flash_attention.kernel", "kernels.flash_attention.ops",
    "kernels.ssd_scan.ref", "kernels.ssd_scan.kernel",
    "kernels.ssd_scan.ops",
    "kernels.cache_probe.ref", "kernels.cache_probe.kernel",
    "kernels.cache_probe.ops", "launch.mesh", "tpuprobe.monitor",
    "distributed.rebalance", "distributed.sharding", "data.pipeline",
    "optim.adamw", "optim.grad_compress", "checkpoint.ckpt",
    "train.train_step", "train.trainer", "launch.train"])
def test_lm_modules_public_names_are_the_jax_modules(name):
    import importlib
    import inspect
    port = importlib.import_module(f"repro_torch.{name}")
    ref = importlib.import_module(f"repro.{name}")
    extra = EXTRA.get(port.__name__, set())
    assert set(port.__all__) - extra <= set(dir(ref))
    assert extra <= set(port.__all__)
    # every public function or class the port module defines is listed
    own = {n for n, v in vars(port).items()
           if not n.startswith("_") and (inspect.isfunction(v)
                                         or inspect.isclass(v))
           and v.__module__ == port.__name__}
    assert own <= set(port.__all__), own - set(port.__all__)


@pytest.mark.parametrize("name", ["vtop", "attacker", "plancost",
                                  "fleetshard", "fleet"])
def test_closed_loop_modules_public_names_are_the_jax_modules(name):
    """The closed loop's modules define no public function, class or
    constant the JAX module lacks."""
    import importlib
    port = importlib.import_module(f"repro_torch.core.{name}")
    ref = importlib.import_module(f"repro.core.{name}")
    own = {n for n, v in vars(port).items()
           if not n.startswith("_") and not isinstance(v, type(importlib))
           and getattr(v, "__module__", port.__name__) == port.__name__}
    assert own <= set(dir(ref)), own - set(dir(ref))


def test_closed_loop_entry_points_default_to_the_card():
    """The fleet, the sharded fleet, the matrix and the measured tuner
    run on the card unless asked for the CPU; without one they raise."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the entry points would run")
    from repro_torch.core import fleet, fleetshard, plancost
    plat = platforms.get_platform("skylake_sp")
    loop = dict(n_intervals=0)
    with pytest.raises(RuntimeError, match="CUDA"):
        fleet.run_fleet("skylake_sp", **loop)
    with pytest.raises(RuntimeError, match="CUDA"):
        fleet.FleetSim("skylake_sp", **loop)
    with pytest.raises(RuntimeError, match="CUDA"):
        fleet.ShardedFleet("skylake_sp", 2, **loop)
    with pytest.raises(RuntimeError, match="CUDA"):
        fleet.run_fleet_matrix(["skylake_sp"], **loop)
    with pytest.raises(RuntimeError, match="CUDA"):
        plancost.tune_lowering(plat, None, force=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        fleetshard.device_groups(4, 2)
    # asked for the CPU, a fleet boots; a model-only tune needs no device
    assert fleet.FleetSim("skylake_sp", device="cpu",
                          **loop).host.device.type == "cpu"
    plancost.tune_lowering(plat, None, measure=False, force=True)
    assert fleetshard.device_groups(4, 2, device="cpu") == \
        [(0, slice(0, 4))]


def test_serving_entry_points_default_to_the_card():
    from repro_torch.configs.base import get_config, reduced_config
    from repro_torch.models import lm
    from repro_torch.serve.engine import ServeEngine
    cfg = reduced_config(get_config("zamba2_2p7b"))
    if torch.cuda.is_available():
        return
    params = lm.init_params(cfg, 0, device="cpu")
    tokens = np.zeros((1, 32), np.int32)
    with pytest.raises(RuntimeError, match="CUDA"):
        lm.init_params(cfg, 0)
    with pytest.raises(RuntimeError, match="CUDA"):
        lm.prefill(cfg, params, {"tokens": tokens})
    with pytest.raises(RuntimeError, match="CUDA"):
        lm.init_caches(cfg, 1, 32)
    with pytest.raises(RuntimeError, match="CUDA"):
        ServeEngine(cfg, params)
    with pytest.raises(RuntimeError, match="CUDA"):
        lm.params_from_numpy({"w": np.zeros(2, np.float32)}, None)
    # asked for the CPU, both run
    assert lm.prefill(cfg, params, {"tokens": tokens},
                      device="cpu").shape == (1, 1, cfg.vocab_padded)
    ServeEngine(cfg, params, device="cpu")


def test_training_entry_points_default_to_the_card(tmp_path):
    """Trainer, PodMonitor(clock=None), measure_hbm_bandwidth, the train
    state, restore and the train CLI run on the card unless asked for the
    CPU; without one they raise."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the entry points would run")
    from repro_torch.checkpoint import ckpt
    from repro_torch.configs.base import (ShapeSpec, get_config,
                                          reduced_config)
    from repro_torch.kernels.cache_probe import ops
    from repro_torch.launch import train
    from repro_torch.tpuprobe.monitor import PodMonitor, SimClock
    from repro_torch.train import train_step as ts
    from repro_torch.train.trainer import Trainer, TrainerConfig
    cfg = reduced_config(get_config("qwen1p5_0p5b"))
    shape = ShapeSpec("s", 32, 4, "train")
    tcfg = TrainerConfig(ckpt_dir=str(tmp_path))
    hyper = ts.TrainHyper()
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(cfg, shape, hyper, tcfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        PodMonitor(1)
    with pytest.raises(RuntimeError, match="CUDA"):
        ops.measure_hbm_bandwidth(3 * (1 << 18), reps=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        ts.make_train_state(cfg, hyper, 0)
    with pytest.raises(RuntimeError, match="CUDA"):
        ckpt.restore(str(tmp_path), 0, {})
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["--reduced", "--steps", "1", "--ckpt", str(tmp_path)])
    # a SimClock monitor probes no device; asked for the CPU, all run
    PodMonitor(1, clock=SimClock(lambda d, t: 1.0)).probe_once()
    PodMonitor(1, device="cpu", probe_bytes=1 << 20).probe_once()
    ops.measure_hbm_bandwidth(3 * (1 << 18), reps=1, device="cpu")
    log = Trainer(cfg, shape, hyper, tcfg, device="cpu").run(1)
    assert log[0]["step"] == 1 and np.isfinite(log[0]["loss"])


def test_serve_cli_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the CLI would serve on it")
    from repro_torch.launch import serve
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--arch", "zamba2-2.7b", "--reduced"])


def test_entry_points_default_to_the_card():
    geom = platforms.get_platform("skylake_sp").machine()
    if torch.cuda.is_available():
        assert repro_torch.resolve_device(None).type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        host_model.SimHost()
    with pytest.raises(RuntimeError, match="CUDA"):
        platforms.get_platform("skylake_sp").make_host_vm(seed=0)
    with pytest.raises(RuntimeError, match="CUDA"):
        cachesim.init_machine(geom)
    host = host_model.SimHost(geom, device="cpu")
    assert host.state["llc"][0].device.type == "cpu"


def test_multi_guest_dispatch_refuses_mixed_devices():
    geom = platforms.get_platform("skylake_sp").machine()
    vms = [host_model.GuestVM(host_model.SimHost(geom, device="cpu"),
                              n_guest_pages=64) for _ in range(2)]
    vms[1].host.device = torch.device("meta")
    with pytest.raises(ValueError, match="device"):
        host_model.commit_segments_multi(vms, [[(np.arange(4), 0)]] * 2)


def test_engine_rejects_bad_shapes():
    geom = platforms.get_platform("skylake_sp").machine()
    st = cachesim.init_machine(geom, "cpu")
    with pytest.raises(ValueError):
        cachesim.access_streams_batched(st, geom, np.zeros((4, 8), np.int32),
                                        np.zeros(3, np.int32),
                                        np.zeros(4, bool))


def test_kernel_library_names_follow_the_sources():
    """A build is keyed by the sources' digest: every .cu has a signature
    table entry, and the library names differ per source."""
    cu = sorted(p.stem for p in _build.CSRC.glob("*.cu"))
    assert cu == sorted(_build.SOURCES)
    names = {_build._target(n).name for n in _build.SOURCES}
    assert len(names) == len(_build.SOURCES)
    assert all(n.endswith(".so") for n in names)


def test_chip_smoke_gives_no_result_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: chip_smoke.py would run")
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout and '"kernels"' not in proc.stdout
