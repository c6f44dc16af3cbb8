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
            "import repro_torch.tpuprobe.vmem_probe\n"
            "import repro_torch.tpuprobe.ici_probe\n"
            "import repro_torch.tpuprobe.pod_backend\n"
            "import repro_torch.distributed.rebalance\n"
            "import repro_torch.distributed.sharding\n"
            "import repro_torch.distributed.elastic\n"
            "import repro_torch.launch.roofline\n"
            "import repro_torch.data.pipeline\n"
            "import repro_torch.optim.adamw, repro_torch.optim.grad_compress\n"
            "import repro_torch.checkpoint.ckpt\n"
            "import repro_torch.train.train_step, repro_torch.train.trainer\n"
            "import repro_torch.launch.dryrun, repro_torch.launch.hillclimb\n"
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
# triad's device timing and its refused tile, the card's shared memory
# beside the TPU's VMEM, a spec's DTensor placements (JAX's
# NamedSharding), the DTensor helpers GSPMD needs none of (placing and
# gathering a tree, running a function on each rank's blocks, reducing a
# pending sum, a hint's placements, a weight's column groups, a
# redistribution whose backward moves least), the collective count that
# stands for the HLO parser, the LM kernel wrappers' argument checks on
# shapes and dtypes alone and the attention kernel's launches a call
EXTRA = {"repro_torch.models.lm": {"params_from_numpy", "caches_from_numpy"},
         "repro_torch.kernels.flash_attention.kernel": {"check_args",
                                                        "grid_launches"},
         "repro_torch.kernels.ssd_scan.kernel": {"check_args"},
         "repro_torch.kernels.ssd_scan.ref": {
             "ssd_scan_grid_ref", "ssd_chunk_cb", "ssd_chunk_states",
             "ssd_carry_states", "ssd_chunk_outputs", "ssd_scan_stages_ref"},
         "repro_torch.kernels.flash_attention.ref": {
             "attention_bf16_probs_ref"},
         "repro_torch.kernels.cache_probe.kernel": {"triad_device_seconds",
                                                    "TileError"},
         "repro_torch.tpuprobe.vmem_probe": {"NOMINAL_SMEM"},
         "repro_torch.distributed.sharding": {
             "placements", "distribute_tree", "gather_tree", "block_offset",
             "on_blocks", "reduce_partial", "bind_mesh_rules",
             "hint_placements", "column_groups", "redistribute"},
         "repro_torch.launch.roofline": {"count_collectives"},
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
    "tpuprobe.vmem_probe", "tpuprobe.ici_probe", "tpuprobe.pod_backend",
    "distributed.rebalance", "distributed.sharding", "distributed.elastic",
    "launch.roofline", "data.pipeline",
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


def _top_level_names(path: Path) -> set:
    """The functions, classes and assigned names a module's source defines
    at its top level, read with `ast` (the module is not imported)."""
    import ast
    names = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names |= {t.id for t in node.targets if isinstance(t, ast.Name)}
    return names


@pytest.mark.parametrize("name", ["launch.dryrun", "launch.hillclimb"])
def test_dry_run_modules_public_names_are_the_jax_modules(name):
    """The dry run's modules against the JAX modules' top-level
    definitions, parsed from their source: importing them sets
    ``XLA_FLAGS`` to 512 host devices for the whole process."""
    import importlib
    import inspect
    port = importlib.import_module(f"repro_torch.{name}")
    ref = _top_level_names(ROOT / "src" / "repro" /
                           (name.replace(".", "/") + ".py"))
    extra = EXTRA.get(port.__name__, set())
    assert set(port.__all__) - extra <= ref, set(port.__all__) - ref
    assert extra <= set(port.__all__)
    own = {n for n, v in vars(port).items()
           if not n.startswith("_") and (inspect.isfunction(v)
                                         or inspect.isclass(v))
           and v.__module__ == port.__name__}
    assert own <= set(port.__all__), own - set(port.__all__)


# Names a JAX module defines or imports that its port counterpart need not
# have, each with its reason.  Beyond these, imported modules and names
# imported from JAX itself (`Mesh`, `PartitionSpec`, `shard_map`, Pallas)
# are not compared: the port imports no JAX.
CONVERSE_EXCEPTIONS = {
    # the Pallas-TPU compiler-parameter shim of kernels/_compat.py, the one
    # file without a counterpart: the CUDA kernels take no such parameters
    "CompilerParams",
    # typing names, for annotations only
    "Tuple", "Dict", "Optional", "Callable",
    # launch/roofline.py's parsers of XLA's compiled HLO text, which the
    # port never produces (`count_collectives` reads the torch step)
    "split_computations", "entry_computation", "parse_collectives",
    # core/fleetshard.py imports the plan cost model's constants; the
    # port's reads them from `plancost` where it uses them
    "COMPILE_S", "DISPATCH_OVERHEAD_S", "STEP_COST_S",
    # plain imports, not surface: distributed/rebalance.py's from core.cas,
    # train/trainer.py's from tpuprobe.monitor, launch/hillclimb.py's from
    # configs.base
    "allow_pull", "SimClock", "input_specs",
}
_JAX_FILES = sorted(str(p.relative_to(ROOT / "src" / "repro"))
                    for p in (ROOT / "src" / "repro").rglob("*.py"))


def _is_module(base: str, name: str) -> bool:
    """Whether ``from base import name`` imports a module: by the files of
    the two packages for their own modules (importing a JAX module to ask
    would run it), by `importlib` for the standard library's and others'."""
    import importlib.util
    parts = base.split(".")
    if parts[0] in ("repro", "repro_torch"):
        pkg = ROOT / "src" / Path(*parts) / name
        return pkg.with_suffix(".py").exists() or (pkg / "__init__.py").exists()
    try:
        return importlib.util.find_spec(f"{base}.{name}") is not None
    except (ImportError, AttributeError, ValueError):
        return False


def _module_names(path: Path) -> dict:
    """A module's top-level names, read with `ast`: each name it defines
    (function, class, assigned name) or imports, mapped to where it came
    from ("def", "module", or the module it is imported from)."""
    import ast
    names = {}
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names[node.name] = "def"
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            for t in targets:
                for e in (t.elts if isinstance(t, ast.Tuple) else [t]):
                    if isinstance(e, ast.Name):
                        names[e.id] = "def"
        elif isinstance(node, ast.Import):
            for a in node.names:
                names[a.asname or a.name.split(".")[0]] = "module"
        elif isinstance(node, ast.ImportFrom):
            assert node.level == 0, (path, node.module)
            for a in node.names:
                names[a.asname or a.name] = (
                    "module" if _is_module(node.module, a.name)
                    else node.module)
    return names


def test_every_jax_file_but_the_pallas_shim_has_a_counterpart():
    missing = [f for f in _JAX_FILES
               if not (ROOT / "src" / "repro_torch" / f).exists()]
    assert missing == ["kernels/_compat.py"]


@pytest.mark.parametrize("rel", [f for f in _JAX_FILES
                                 if f != "kernels/_compat.py"])
def test_port_modules_have_the_jax_modules_names(rel):
    """The converse of the subset checks above: each public name the JAX
    module defines or imports is a top-level name of its port counterpart,
    but for imported modules, names imported from JAX and
    `CONVERSE_EXCEPTIONS`."""
    ref = _module_names(ROOT / "src" / "repro" / rel)
    port = _module_names(ROOT / "src" / "repro_torch" / rel)
    want = {n for n, src in ref.items()
            if not n.startswith("_") and src != "module"
            and not (src.split(".")[0] == "jax")
            and n not in CONVERSE_EXCEPTIONS}
    assert want <= set(port), sorted(want - set(port))


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
