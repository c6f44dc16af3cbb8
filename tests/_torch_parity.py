"""Shared fixtures of the closed-loop parity tests (`tests/test_torch_*`).

Both packages keep process-wide caches that decide what their tuners and
shard choosers pick: the dispatch-shape cache (`plancost.SHAPE_CACHE`),
the tune cache and the shard cache.  Under ``--dist loadfile`` one worker
runs several test files in one process, so JAX probing code run here
must leave the JAX package's caches as it found them
(`jax_caches_restored`, used by every test of these files), and the
port's tests of a choice start from empty port caches
(`port_caches_fresh`).  `jax_costs` puts the JAX package's cost
constants into the port's `plancost`, so the port's model-only choices
can be held against the JAX package's.
"""

import json
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
DATA = ROOT / "tests" / "data"
COST_CONSTANTS = ("COMPILE_S", "DISPATCH_OVERHEAD_S", "STEP_COST_S")


def golden(name: str):
    return json.loads((DATA / f"torch_golden_{name}.json").read_text())


def _snapshot(plancost, fleetshard):
    return (plancost.SHAPE_CACHE.snapshot(), dict(plancost._TUNE_CACHE),
            dict(fleetshard._SHARD_CACHE))


def _restore(plancost, fleetshard, snap):
    plancost.SHAPE_CACHE.restore(snap[0])
    for cache, saved in ((plancost._TUNE_CACHE, snap[1]),
                         (fleetshard._SHARD_CACHE, snap[2])):
        cache.clear()
        cache.update(saved)


@pytest.fixture(autouse=True)
def jax_caches_restored():
    """The JAX package's shape, tune and shard caches after the test are
    what they were before it."""
    from repro.core import fleetshard, plancost
    snap = _snapshot(plancost, fleetshard)
    yield
    _restore(plancost, fleetshard, snap)


@pytest.fixture
def port_caches_fresh():
    """The port's shape, tune and shard caches start empty and are put
    back after the test."""
    from repro_torch.core import fleetshard, plancost
    snap = _snapshot(plancost, fleetshard)
    plancost.SHAPE_CACHE.clear()
    plancost.clear_tune_cache()
    fleetshard.clear_shard_cache()
    yield
    _restore(plancost, fleetshard, snap)


@pytest.fixture
def jax_costs(monkeypatch):
    """The JAX package's cost constants in the port's `plancost`."""
    from repro.core import plancost as jpc
    from repro_torch.core import plancost as tpc
    for name in COST_CONSTANTS:
        monkeypatch.setattr(tpc, name, getattr(jpc, name))
