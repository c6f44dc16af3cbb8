"""The closed loop in the port (`core/fleet.py`, `core/fleetshard.py`)
against the JAX package: the same inputs and seeds through both, the port
on the CPU, at the reduced loop of `tests/test_fleet_scale.py`.

Every report field is held exactly but the wall-clock ones and the four
that pass through `fleet_interval_progress`'s f32 sums (``throughput``,
``per_workload``, ``serve_p50_ms``, ``serve_p99_ms``), which are held at
tests/test_fleet.py:52's rel 1e-5 (`torch_goldens.fleet_mismatches`,
the comparison the card run makes against the goldens).  Shard choices are
held against `tests/data/torch_golden_tune.json` (these tests never call
the JAX tuner).  `test_goldens_are_current` (slow) rewrites every golden
from the JAX package and compares.
"""

import dataclasses
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fleet as jfleet
from repro.core import fleetshard as jshard
from repro_torch.core import fleet as tfleet
from repro_torch.core import fleetshard as tshard
from repro_torch.core import platforms as tplat
from tests._torch_parity import (DATA, ROOT, golden,  # noqa: F401
                                 jax_caches_restored, jax_costs,
                                 port_caches_fresh)
from tests.torch_goldens import (SHARD_GUESTS, fleet_mismatches, goldens,
                                 path_of, report_fields, shard_fields)

LOOP = dict(n_intervals=6, warmup=2, stream_len=64, ws_pages=4)
# the fewest intervals of the reduced loop in which the JAX package's
# attack fleet detects the attacker and defends (interval 11)
ATTACK_INTERVALS = 12
COMBOS = (("eevdf", "on"), ("cas", "on"), ("cas", "off"))


def _mismatches(port_report, jax_report):
    return fleet_mismatches(report_fields(port_report),
                            report_fields(jax_report))


# ---------------------------------------------------------------------------
# fleet_interval_progress
# ---------------------------------------------------------------------------

def _progress_inputs(seed, B=5, D=3):
    rng = np.random.default_rng(seed)
    period = rng.integers(2, 9, B).astype(np.int32)
    return dict(domain_idx=rng.integers(0, D, B).astype(np.int32),
                rates=rng.uniform(5, 50, B).astype(np.float32),
                duty_period=period,
                duty_on=np.minimum(rng.integers(1, 9, B),
                                   period).astype(np.int32),
                sens=rng.uniform(0, 2, B).astype(np.float32),
                ipc0=rng.uniform(0.5, 1.5, B).astype(np.float32),
                slowdown=rng.uniform(1, 3, B).astype(np.float32),
                noise_dom=rng.uniform(0, 300, D).astype(np.float32))


@pytest.mark.parametrize("seed,B,D,T", [(3, 5, 3, 24), (4, 3, 2, 32),
                                        (5, 9, 4, 17), (6, 1, 1, 8)])
def test_progress_matches_jax_and_the_numpy_loop(seed, B, D, T):
    """Against the jitted JAX function and the per-tick loop of
    tests/test_fleet.py:22-54 on the same f32 inputs."""
    x = _progress_inputs(seed, B, D)
    scale = 0.01
    jprog, jcont = jfleet.fleet_interval_progress(
        *(jnp.asarray(v) for v in x.values()), scale, n_domains=D, ticks=T)
    prog, cont = tfleet.fleet_interval_progress(
        *(torch.as_tensor(v) for v in x.values()), scale, n_domains=D,
        ticks=T)
    assert prog.dtype == cont.dtype == torch.float32
    assert prog.shape == (B,) and cont.shape == (D,)
    np.testing.assert_allclose(prog.numpy(), np.asarray(jprog), rtol=1e-5)
    np.testing.assert_allclose(cont.numpy(), np.asarray(jcont), rtol=1e-5)
    ref_prog, ref_cont = np.zeros(B), np.zeros((D, T))
    for t in range(T):
        traffic = x["noise_dom"].astype(float)
        for w in range(B):
            if t % x["duty_period"][w] < x["duty_on"][w]:
                traffic[x["domain_idx"][w]] += x["rates"][w]
        ref_cont[:, t] = traffic * scale
        for w in range(B):
            c = ref_cont[x["domain_idx"][w], t]
            ref_prog[w] += x["ipc0"][w] / ((1 + x["sens"][w] * c)
                                           * x["slowdown"][w])
    np.testing.assert_allclose(prog.numpy(), ref_prog, rtol=1e-5)
    np.testing.assert_allclose(cont.numpy(), ref_cont.mean(axis=1),
                               rtol=1e-5)
    # the same bits on every call (no atomics in the domain sum)
    again = tfleet.fleet_interval_progress(
        *(torch.as_tensor(v) for v in x.values()), scale, n_domains=D,
        ticks=T)
    assert torch.equal(again[0], prog) and torch.equal(again[1], cont)


# ---------------------------------------------------------------------------
# the closed loop, end to end
# ---------------------------------------------------------------------------

def test_fleet_matrix_matches_jax():
    """eevdf and cas with CAP on, cas with CAP off, each with a serving
    guest, co-executed in lockstep on skylake_sp in both packages."""
    kw = dict(combos=COMBOS, serving=True, **LOOP)
    want = jfleet.run_fleet_matrix(["skylake_sp"], **kw)
    got = tfleet.run_fleet_matrix(["skylake_sp"], device="cpu", **kw)
    assert [(r.policy, r.cap) for r in got] == list(COMBOS)
    for g, w in zip(got, want):
        assert _mismatches(g, w) == [], (w.policy, w.cap)
    by = {(r.policy, r.cap): r for r in got}
    assert by["cas", "on"].quiet_residency > by["eevdf", "on"].quiet_residency
    assert all(r.serve_requests > 0 and r.serve_p99_ms >= r.serve_p50_ms > 0
               for r in got)
    assert len({r.guests_per_sec for r in got}) == 1


def test_attack_fleet_matches_jax():
    kw = dict(attack=True, with_poisoner=False,
              **dict(LOOP, n_intervals=ATTACK_INTERVALS))
    want = jfleet.FleetSim("skylake_sp", **kw).run()
    got = tfleet.FleetSim("skylake_sp", device="cpu", **kw).run()
    assert _mismatches(got, want) == []
    assert got.attack_detected and got.defenses == 1
    assert got.false_drift == 0


def test_sharded_fleet_reports_match_unsharded(port_caches_fresh):
    """tests/test_fleet_scale.py:173 in the port: 8 donor-cloned guests
    under a 4-guest shard equal, guest by guest, the automatic choice
    (unsharded for 8), and every guest carries the fleet rate."""
    loop = dict(n_intervals=4, warmup=1, stream_len=64, ws_pages=4)
    fleets, runs = {}, {}
    for shard in (4, None):
        fleets[shard] = tfleet.ShardedFleet("skylake_sp", 8, seed=0,
                                            shard_size=shard, device="cpu",
                                            **loop)
        runs[shard] = fleets[shard].run()
    res = runs[4]
    assert res.n_guests == len(res.reports) == 8 and res.n_devices == 1
    assert res.shard_size == 4 and res.n_shards == 2
    assert fleets[4].sims[0].lowering.shard_size == 4
    assert fleets[4].sims[0].lowering.lockstep
    assert runs[None].shard_size is None and runs[None].n_shards == 1
    assert fleets[None].sims[0].lowering.lockstep
    assert all(s.host.device.type == "cpu" for s in fleets[4].sims)
    assert all(r.guests_per_sec == res.guests_per_sec for r in res.reports)
    for a, b in zip(runs[4].reports, runs[None].reports):
        assert report_fields(a) == report_fields(b)


# ---------------------------------------------------------------------------
# shard choice, device groups, streaming metrics
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", tplat.list_platforms())
def test_choose_shard_matches_the_jax_golden(name, jax_costs,
                                             port_caches_fresh):
    want = golden("tune")[name]["shard"]
    plat = tplat.get_platform(name)
    for n in SHARD_GUESTS:
        tshard.clear_shard_cache()
        choice = tshard.choose_shard(plat, n_guests=n)
        assert shard_fields(choice) == want[str(n)], n
        assert tshard.choose_shard(plat, n_guests=n).cached


def test_device_groups_match_jax():
    for n, shard in ((256, 16), (8, None), (5, 2), (64, 64), (1, None)):
        assert tshard.device_groups(n, shard, device="cpu") == \
            jshard.device_groups(n, shard)
    assert tshard.local_device_count("cpu") == 1
    with tshard.on_device(0, "cpu") as dev:
        assert dev.type == "cpu"


def _stream(seed, n=600):
    return np.random.default_rng(seed).lognormal(3.0, 0.6, n)


@pytest.mark.parametrize("q", [0.5, 0.9, 0.99])
@pytest.mark.parametrize("n", [3, 5, 6, 600])
def test_p2_quantile_matches_jax(q, n):
    a, b = jshard.P2Quantile(q), tshard.P2Quantile(q)
    for x in _stream(int(q * 100) + n, n):
        a.add(x)
        b.add(x)
        assert b.value() == a.value()


@pytest.mark.parametrize("keep_history,window", [(False, 0), (True, 4),
                                                 (False, 7)])
def test_fleet_metrics_match_jax(keep_history, window):
    a = jshard.FleetMetrics(keep_history=keep_history, window=window)
    b = tshard.FleetMetrics(keep_history=keep_history, window=window)
    for i, x in enumerate(_stream(window + 11, 50)):
        for m in (a, b):
            m.add("lat" if i % 3 else "rate", x)
    for name in ("lat", "rate", "none"):
        for f in ("count", "mean", "ewma", "last", "history",
                  "window_values"):
            assert getattr(b, f)(name) == getattr(a, f)(name), (name, f)
    assert b.retained_samples() == a.retained_samples()
    assert b.names() == a.names()
    for cls in ("StreamingMean", "EWMA", "RingWindow"):
        ja, tb = getattr(jshard, cls)(), getattr(tshard, cls)()
        for x in _stream(5, 40):
            ja.add(x)
            tb.add(x)
        read = "values" if cls == "RingWindow" else "value"
        assert getattr(tb, read)() == getattr(ja, read)()


@pytest.mark.parametrize("defended_at", [None, 6, 9, 15])
@pytest.mark.parametrize("defend", [True, False])
def test_residency_phases_match_jax(defended_at, defend):
    rng = np.random.default_rng(7)
    hist = [(k, float(rng.integers(0, 2))) for k in range(20)]
    out = []
    for mod in (jshard, tshard):
        ph = mod.ResidencyPhases(warmup=2, start=5, stop=12, n_intervals=20,
                                 defend=defend)
        for k, v in hist:
            on = defended_at is not None and k >= defended_at
            ph.add(k, v, defended=on, defended_at=defended_at if on else -1)
        ph.finish(defended_at is not None,
                  defended_at if defended_at is not None else -1)
        out.append(ph.means())
    assert out[1] == out[0]


# ---------------------------------------------------------------------------
# the goldens
# ---------------------------------------------------------------------------

@pytest.mark.slow
def test_goldens_are_current(tmp_path):
    """Rewrites every golden from the JAX package, in a process of its own
    (`tests/torch_goldens.py`, tens of minutes on a CPU), and compares
    them with the files in tests/data."""
    proc = subprocess.run(
        [sys.executable, str(ROOT / "tests" / "torch_goldens.py"), "--out",
         str(tmp_path)], cwd=ROOT, capture_output=True, text=True,
        env={"PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu",
             "PATH": "/usr/bin:/bin"})
    assert proc.returncode == 0, proc.stderr[-2000:]
    for name in goldens():
        assert path_of(name, tmp_path).read_text() == \
            path_of(name, DATA).read_text(), name


def test_fleet_report_fields_are_the_jax_fields():
    assert [f.name for f in dataclasses.fields(tfleet.FleetReport)] == \
        [f.name for f in dataclasses.fields(jfleet.FleetReport)]
    assert tfleet.FleetReport.csv_header() == jfleet.FleetReport.csv_header()
    assert tfleet.DEFAULT_COMBOS == jfleet.DEFAULT_COMBOS
