"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Each test decides inside itself whether a card is present and
skips without one; run them on a card with

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py
"""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import _build
from repro_torch.core import cachesim, platforms, runner
from repro_torch.kernels.cache_probe import ops as probe_ops
from repro_torch.kernels.cache_probe import ref as probe_ref
from repro_torch.kernels.cachesim_step import ops as sim_ops
from repro_torch.kernels.cachesim_step import ref as sim_ref

pytestmark = pytest.mark.gpu
GOLDEN = Path(__file__).parent / "data" / \
    "torch_golden_run_cachex_skylake_sp.json"


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _on(dev, a):
    return torch.as_tensor(np.array(a), device=dev)


@pytest.mark.parametrize("rows,ways,T,seed", [(4, 4, 1, 0), (64, 8, 33, 1),
                                              (1024, 8, 128, 2),
                                              (100, 16, 40, 3)])
def test_lru_sets_kernel_matches_plain(rows, ways, T, seed):
    dev = _card()
    rng = np.random.default_rng(seed)
    tags = rng.integers(0, 64, (rows, ways)).astype(np.int32)
    tags[rng.random((rows, ways)) < 0.4] = -1
    age = rng.integers(0, 100, (rows, ways)).astype(np.int32)
    streams = rng.integers(-1, 64, (rows, T)).astype(np.int32)
    args = [_on(dev, x) for x in (tags, age, streams)]
    n0 = _build.LAUNCHES["lru_sets"]
    got = sim_ops.simulate_rows(*args, clock0=200)
    assert _build.LAUNCHES["lru_sets"] == n0 + 1
    for g, w in zip(got, sim_ref.lru_sets_ref(*args, clock0=200)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("B,W,T,seed", [(8, 4, 24, 0), (128, 8, 128, 1),
                                        (256, 8, 128, 2), (33, 16, 12, 3)])
def test_prime_probe_kernel_matches_plain(B, W, T, seed):
    dev = _card()
    rng = np.random.default_rng(seed)
    tags = rng.integers(100, 164, (B, W)).astype(np.int32)
    tags[rng.random((B, W)) < 0.5] = -1
    age = np.zeros((B, W), np.int32)
    streams = rng.integers(-1, 64, (B, T)).astype(np.int32)
    targets = rng.integers(0, 64, B).astype(np.int32)
    args = [_on(dev, x) for x in (tags, age, streams, targets)]
    assert torch.equal(probe_ops.probe_verdicts(*args),
                       probe_ref.prime_probe_ref(*args))


@pytest.mark.parametrize("replacement", ["lru", "random"])
@pytest.mark.parametrize("inclusion", ["inclusive", "non_inclusive"])
def test_engine_kernel_matches_plain(replacement, inclusion):
    dev = _card()
    geom = dataclasses.replace(platforms.get_platform("skylake_sp").machine(),
                               replacement=replacement, inclusion=inclusion)
    rng = np.random.default_rng(1)
    lines = 3 * geom.llc.n_lines
    state = cachesim.init_machine(geom, dev)
    plain = {k: (tuple(x.clone() for x in v) if isinstance(v, tuple)
                 else v.clone()) for k, v in state.items()}
    blocks = rng.integers(-1, lines, 1024).astype(np.int32)
    cores = rng.integers(0, geom.n_cores, 1024).astype(np.int32)
    cot = rng.random(1024) < 0.2
    _, lk = cachesim.access_stream(state, geom, _on(dev, blocks),
                                   _on(dev, cores), _on(dev, cot))
    lp = cachesim.engine_ref(cachesim._single(plain), geom,
                             _on(dev, blocks)[None, None],
                             _on(dev, cores)[None], _on(dev, cot)[None],
                             None, commit=True)[0, 0]
    assert torch.equal(lk, lp)
    for key in ("l2", "llc"):
        for a, b in zip(state[key], plain[key]):
            assert torch.equal(a, b)
    assert torch.equal(state["rng"], plain["rng"])
    lanes = rng.integers(-1, lines, (16, 128)).astype(np.int32)
    lc = rng.integers(0, geom.n_cores, 16).astype(np.int32)
    lt = rng.random(16) < 0.25
    lk = cachesim.access_streams_batched(state, geom, _on(dev, lanes),
                                         _on(dev, lc), _on(dev, lt), 9)
    lp = cachesim.engine_ref(cachesim._single(state), geom,
                             _on(dev, lanes)[None], _on(dev, lc)[None],
                             _on(dev, lt)[None], _on(dev, [9]),
                             commit=False)[0]
    assert torch.equal(lk, lp)


def test_run_cachex_on_the_card_matches_golden():
    _card()
    _build.reset_counters()
    report = runner.run_cachex("skylake_sp")
    got = dataclasses.asdict(report)
    got.pop("wall_s")
    assert json.loads(json.dumps(got, sort_keys=True)) == \
        json.loads(GOLDEN.read_text())
    assert _build.LAUNCHES["cachesim_engine"] == 361
    assert _build.PLAIN_CALLS["cachesim_engine"] == 0
