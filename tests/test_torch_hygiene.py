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
