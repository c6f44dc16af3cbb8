"""The port's monitor path against the JAX package on the CPU: the STREAM
triad and its bandwidth probe (`kernels.cache_probe`), `PodMonitor` under
`SimClock` schedules, and `distributed.rebalance`.  Inputs are numpy (or
plain floats) handed to both packages.

Tolerance: none.  The triad's product and sum round separately on both
sides, and the monitor and rebalance arithmetic is the same numpy code,
so every value must be equal.  The one exception is stated where it
arises: the nominal bandwidth (`launch.mesh.HBM_BW`) is the H100's in the
port and a TPU's in the JAX package, so effective bandwidths differ by
that ratio unless the test gives both the same constant."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from tests._hypothesis_compat import given, settings, st

from repro.distributed import rebalance as jreb
from repro.kernels.cache_probe import kernel as jkernel
from repro.kernels.cache_probe import ops as jops
from repro.launch import mesh as jmesh
from repro.tpuprobe import monitor as jmon
from repro_torch import _build
from repro_torch.distributed import rebalance as treb
from repro_torch.kernels.cache_probe import kernel, ops, ref
from repro_torch.launch import mesh as tmesh
from repro_torch.tpuprobe import monitor as tmon


# -- the triad ---------------------------------------------------------------------

@pytest.mark.parametrize("rows,block", [(512, 512), (1024, 256), (64, 64)])
def test_triad_plain_equals_the_pallas_kernel(rows, block):
    """tests/test_kernels.py:236's inputs, through the Pallas kernel in
    interpret mode and through the port's `triad_ref` and `triad` (which
    runs `triad_ref` on CPU tensors): equal bit for bit."""
    a = np.arange(rows * 128, dtype=np.float32).reshape(rows, 128)
    b = np.full((rows, 128), 2.0, np.float32)
    s = np.array([3.0], np.float32)
    want = np.asarray(jkernel.triad(jnp.asarray(a), jnp.asarray(b),
                                    jnp.asarray(s), block=block,
                                    interpret=True))
    ta, tb, ts = (torch.from_numpy(x) for x in (a, b, s))
    np.testing.assert_array_equal(ref.triad_ref(ta, tb, ts).numpy(), want)
    _build.reset_counters()
    np.testing.assert_array_equal(kernel.triad(ta, tb, ts).numpy(), want)
    assert _build.PLAIN_CALLS["triad"] == 1 and not _build.LAUNCHES


def test_triad_plain_rounds_product_and_sum_separately():
    """Random inputs where a fused multiply-add would round differently:
    the plain version equals numpy's two-rounding ``a * s + b``."""
    rng = np.random.default_rng(0)
    a = rng.standard_normal((300, 128)).astype(np.float32)
    b = rng.standard_normal((300, 128)).astype(np.float32)
    s = np.array([1.0 / 3.0], np.float32)
    got = ref.triad_ref(*(torch.from_numpy(x) for x in (a, b, s))).numpy()
    np.testing.assert_array_equal(got, (a * s[0]).astype(np.float32) + b)


def test_triad_refuses_bad_shapes():
    a = torch.zeros((8, 128))
    with pytest.raises(ValueError):
        kernel.triad(a, torch.zeros((16, 128)), torch.ones(1))
    with pytest.raises(ValueError):
        kernel.triad(a, a, torch.ones(2))


def test_measure_bandwidth_runs_on_the_cpu():
    """At tests/test_kernels.py:246's size: the plain triad, one call per
    rep, no launch."""
    _build.reset_counters()
    bw, dt = ops.measure_hbm_bandwidth(n_bytes=3 * (1 << 18), reps=2,
                                       device="cpu")
    assert bw > 0 and dt > 0
    assert _build.PLAIN_CALLS["triad"] == 2 and not _build.LAUNCHES


def test_measure_bandwidth_takes_the_monitor_default_size():
    """The monitor's 64 MiB probe is 43,688 rows, not a multiple of the
    Pallas kernel's 512-row block: the JAX function asserts there, the
    port runs."""
    n = 64 * (1 << 20)
    rows = max(8, (n // 4 // 3 // 128) // 8 * 8)
    assert rows == 43688 and rows % 512 != 0
    with pytest.raises(AssertionError):
        jops.measure_hbm_bandwidth(n, reps=1)
    _build.reset_counters()
    bw, dt = ops.measure_hbm_bandwidth(n, reps=1, device="cpu")
    assert bw > 0 and dt > 0
    assert _build.PLAIN_CALLS["triad"] == 1 and not _build.LAUNCHES


# -- the monitor under SimClock -------------------------------------------------------

def _contention(d, t):              # tests/test_runtime.py:27
    return 3.0 if (d == 2 and t >= 2.0) else 1.0


def _shrink_then_restore(d, t):     # tests/test_runtime.py:44, over time
    return 4.0 if t < 5.0 else 1.0


def _mixed(d, t):                   # a drifting schedule over all devices
    return 1.0 + 0.6 * ((d * 7 + int(t) * 3) % 5) / 4.0 + (2.5 if
                                                          8 <= t < 14
                                                          else 0.0)


SCHEDULES = {"contention": _contention, "shrink_restore": _shrink_then_restore,
             "mixed": _mixed}


def _drive(mod, schedule, n_devices, intervals=20):
    mon = mod.PodMonitor(n_devices, clock=mod.SimClock(schedule))
    trace = []
    for _ in range(intervals):
        samples = mon.probe_once()
        trace.append(([dataclasses.astuple(s) for s in samples],
                      mon.ewma.copy(), mon.device_tiers(), mon.probe_bytes,
                      mon.slow_devices()))
    return trace


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_monitor_equals_jax_under_simclock(name, monkeypatch):
    """Every ProbeSample, the EWMA, tiers, slow devices and probe size of
    20 intervals are equal once both monitors share the nominal
    bandwidth."""
    monkeypatch.setattr(tmon, "HBM_BW", jmesh.HBM_BW)
    got = _drive(tmon, SCHEDULES[name], 4)
    want = _drive(jmon, SCHEDULES[name], 4)
    for (gs, ge, gt, gb, gsl), (ws, we, wt, wb, wsl) in zip(got, want):
        assert gs == ws
        np.testing.assert_array_equal(ge, we)
        assert (gt, gb, gsl) == (wt, wb, wsl)


def test_monitor_with_the_card_bandwidth():
    """With the port's own HBM_BW (the H100's): tiers, slow devices and
    probe sizes are unchanged; effective bandwidths scale by the ratio of
    the two nominal bandwidths.  Slowdowns and the EWMA agree within
    1e-12 relative, not exactly: ``nominal * factor / nominal`` rounds
    differently for the two nominal times (one ulp)."""
    assert tmesh.HBM_BW == 3.35e12
    ratio = tmesh.HBM_BW / jmesh.HBM_BW
    got = _drive(tmon, _mixed, 3)
    want = _drive(jmon, _mixed, 3)
    for (gs, ge, gt, gb, gsl), (ws, we, wt, wb, wsl) in zip(got, want):
        for g, w in zip(gs, ws):
            assert (g[0], g[3]) == (w[0], w[3])
            assert g[1] == pytest.approx(w[1] * ratio, rel=1e-12)
            assert g[2] == pytest.approx(w[2], rel=1e-12)
        np.testing.assert_allclose(ge, we, rtol=1e-12, atol=0)
        assert (gt, gb, gsl) == (wt, wb, wsl)


def test_monitor_autoshrink_and_restore():
    """tests/test_runtime.py:44 on the port."""
    mon = tmon.PodMonitor(n_devices=2, clock=tmon.SimClock(lambda d, t: 4.0))
    d0 = mon.probe_bytes
    mon.probe_once()
    assert mon.probe_bytes < d0
    mon.clock.schedule = lambda d, t: 1.0
    mon.probe_once()
    assert mon.probe_bytes == d0


def test_monitor_probes_the_plain_triad_on_the_cpu():
    """clock=None times the triad on the monitor's device: on the CPU the
    plain version, once per device index, after the first probe has
    calibrated the nominal at each size the shrink can reach (768 KiB
    and the 1 MiB floor), counting its own triads; the second probe
    calibrates nothing."""
    mon = tmon.PodMonitor(3, device="cpu", probe_bytes=3 * (1 << 18))
    assert tmon._probe_sizes(mon.default_probe_bytes) == [3 << 18, 1 << 20]
    _build.reset_counters()
    samples = mon.probe_once()
    calib = 2 * tmon._CALIBRATION_PROBES
    assert mon._calibration_launches == calib
    assert _build.PLAIN_CALLS["triad"] == calib + 3 and not _build.LAUNCHES
    assert [s.device for s in samples] == [0, 1, 2]
    assert all(s.effective_bw > 0 and s.slowdown >= 1.0 for s in samples)
    assert len(mon.history) == 1
    mon.probe_once()
    assert _build.PLAIN_CALLS["triad"] == calib + 6
    assert mon._calibration_launches == calib


# -- the monitor on a device: the nominal is the idle triad's rate ---------------

MiB = 1 << 20
SIZES = [64 * MiB, 32 * MiB, 16 * MiB, 8 * MiB, 4 * MiB, 2 * MiB, MiB]


def _idle_us(n_bytes):
    """A stand-in idle triad: 25.4 us at 64 MiB, with 2 us of fixed cost,
    so each size has its own rate (2.64 TB/s at 64 MiB, 0.38 at 1 MiB)."""
    return 2.0 + 23.4 * n_bytes / (64 * MiB)


class _Triads:
    """Stands in for `measure_hbm_bandwidth`: call i takes ``factors[i]``
    times the idle triad at the size asked, and the sizes asked are
    kept."""

    def __init__(self, factors):
        self.factors = list(factors)
        self.sizes = []

    def __call__(self, n_bytes, reps=3, device=None):
        assert reps == 1
        dt = self.factors[len(self.sizes)] * _idle_us(n_bytes) * 1e-6
        self.sizes.append(n_bytes)
        return n_bytes / dt, dt


CALIB = [1.02, 1.0, 1.02, 1.01, 1.005]          # each size's best: 1.0x idle


def _device_monitor(monkeypatch, probe_factors):
    triads = _Triads(CALIB * len(SIZES) + list(probe_factors))
    monkeypatch.setattr(ops, "measure_hbm_bandwidth", triads)
    return tmon.PodMonitor(1, device="cpu"), triads


def _probe(mon, n):
    slows, tiers = [], []
    for _ in range(n):
        slows.append(mon.probe_once()[0].slowdown)
        tiers.append(mon.device_tiers()[0])
    return slows, tiers


def test_monitor_idle_triads_stay_in_tier_0(monkeypatch):
    """Idle probes within 4% of the best calibration triad: slowdowns
    are the ratio to it (at most 1.04, none below 1), the EWMA stays
    below tier 1's 1.15 and the tier at 0.  The spec-sheet nominal
    (3.35e12 B/s) would have read 1.2+ from the same times."""
    probe = [1.0, 1.04, 1.02, 0.985, 1.03, 1.01, 1.025, 1.005]
    mon, triads = _device_monitor(monkeypatch, probe)
    slows, tiers = _probe(mon, len(probe))
    np.testing.assert_allclose(slows, [max(1.0, f) for f in probe],
                               rtol=1e-12)
    assert max(slows) < 1.05 and tiers == [0] * len(probe)
    assert float(mon.ewma[0]) < 1.15
    idle_bw = (64 * MiB) / (_idle_us(64 * MiB) * 1e-6)
    assert tmesh.HBM_BW / idle_bw > 1.2
    assert len(triads.sizes) == len(CALIB) * len(SIZES) + len(probe)


def test_monitor_contended_triads_reach_tier_1(monkeypatch):
    """Probes 1.5x the idle triad read a slowdown of 1.5 and, after the
    EWMA crosses 1.15 and three intervals of hysteresis, tier 1; the
    probe size stays (no slowdown above 2)."""
    mon, _ = _device_monitor(monkeypatch, [1.5] * 8)
    slows, tiers = _probe(mon, 8)
    np.testing.assert_allclose(slows, [1.5] * 8, rtol=1e-12)
    assert tiers[0] == 0 and tiers[-1] == 1
    assert mon.slow_devices() == [0]
    assert mon.probe_bytes == mon.default_probe_bytes


def test_monitor_calibrates_each_probe_size_once(monkeypatch):
    """The first probe calibrates every size the shrink can reach, 64 MiB
    down to 1 MiB, five triads each, while the card is idle.  Under 3x
    contention the size halves twice, and the smaller sizes still read
    3, against their own idle times, not 1; a quiet probe restores 64
    MiB; no probe after the first calibrates anything."""
    probe = [3.0, 3.0, 3.0,             # 64, 32, 16 MiB under contention
             1.01,                      # 8 MiB, quiet: restore
             1.0, 1.02]                 # 64 MiB
    mon, triads = _device_monitor(monkeypatch, probe)
    assert tmon._probe_sizes(mon.default_probe_bytes) == SIZES
    sizes, slows = [], []
    for _ in probe:
        sizes.append(mon.probe_bytes)
        slows.append(mon.probe_once()[0].slowdown)
    assert sizes == [64 * MiB, 32 * MiB, 16 * MiB, 8 * MiB, 64 * MiB,
                     64 * MiB]
    np.testing.assert_allclose(slows, [3.0, 3.0, 3.0, 1.01, 1.0, 1.02],
                               rtol=1e-12)
    n_cal = len(CALIB) * len(SIZES)
    assert triads.sizes[:n_cal] == [nb for nb in SIZES
                                    for _ in range(len(CALIB))]
    assert triads.sizes[n_cal:] == sizes           # one triad a probe
    assert sorted(mon._idle_s) == sorted(SIZES)
    for nb in SIZES:
        assert mon._idle_s[nb] == pytest.approx(_idle_us(nb) * 1e-6,
                                                rel=1e-12)
    assert mon._calibration_launches == 0      # the stub launches nothing


def test_monitor_under_simclock_never_calibrates(monkeypatch):
    """A SimClock monitor reads against the spec nominal, as the JAX
    monitor does, and times no triad."""
    triads = _Triads([])
    monkeypatch.setattr(ops, "measure_hbm_bandwidth", triads)
    monkeypatch.setattr(tmon, "HBM_BW", jmesh.HBM_BW)
    got = _drive(tmon, _shrink_then_restore, 2)
    want = _drive(jmon, _shrink_then_restore, 2)
    assert triads.sizes == []
    for (gs, ge, gt, gb, gsl), (ws, we, wt, wb, wsl) in zip(got, want):
        assert gs == ws
        np.testing.assert_array_equal(ge, we)
        assert (gt, gb, gsl) == (wt, wb, wsl)


# -- rebalance -----------------------------------------------------------------------

@settings(max_examples=40, deadline=None)
@given(n=st.integers(2, 16), total=st.integers(16, 64),
       slow=st.floats(1.0, 6.0), seed=st.integers(0, 99))
def test_property_rebalance_equals_jax(n, total, slow, seed):
    """tests/test_runtime.py:58's property space: the port's plan equals
    JAX's, keeps the total and gives each device at least one."""
    rng = np.random.default_rng(seed)
    s = np.ones(n)
    s[rng.integers(n)] = slow
    plan = treb.rebalanced_microbatches(s, total)
    np.testing.assert_array_equal(plan, jreb.rebalanced_microbatches(s, total))
    assert plan.sum() == total and plan.min() >= 1


@pytest.mark.parametrize("slowdown,total", [
    ([1.0, 1.0, 1.0, 4.0], 32), ([1.0, 2.0, 3.0], 7), ([5.0, 5.0], 2),
    ([1.0, 1.3, 1.0, 1.7, 2.2, 1.0, 1.0, 9.0], 64)])
def test_rebalanced_microbatches_equal_jax(slowdown, total):
    s = np.array(slowdown)
    np.testing.assert_array_equal(treb.rebalanced_microbatches(s, total),
                                  jreb.rebalanced_microbatches(s, total))


def test_mitigator_equals_jax():
    """tests/test_runtime.py:82's sequence, then a recovery: plans,
    rebalance counts and modelled step times equal."""
    slow = np.array([1, 1, 1, 4.0])
    seq = [slow] * 4 + [np.ones(4)] * 4 + [np.array([2.0, 1, 1, 1])] * 3
    mt = treb.StragglerMitigator(n_devices=4, total_microbatches=32)
    mj = jreb.StragglerMitigator(n_devices=4, total_microbatches=32)
    assert mt.step_time(slow) == mj.step_time(slow)
    for s in seq:
        np.testing.assert_array_equal(mt.update(s), mj.update(s))
        assert mt.rebalances == mj.rebalances
        assert mt.step_time(s) == mj.step_time(s)


def test_expert_placement_equals_jax():
    """tests/test_runtime.py:95's placement, and an ExpertRebalancer
    driven by published views until its tiers commit."""
    load = np.array([10.0, 1.0, 5.0, 1.0])
    tiers = {0: 2, 1: 0}
    pt = treb.replace_experts(load, tiers, experts_per_device=2)
    pj = jreb.replace_experts(load, tiers, experts_per_device=2)
    np.testing.assert_array_equal(pt.expert_to_device, pj.expert_to_device)
    np.testing.assert_array_equal(pt.permutation(4), pj.permutation(4))

    class View:
        def __init__(self, per_domain):
            self.per_domain = per_domain

    rt = treb.ExpertRebalancer(n_experts=8, n_devices=4)
    rj = jreb.ExpertRebalancer(n_experts=8, n_devices=4)
    rng = np.random.default_rng(3)
    for i in range(12):
        expert_load = rng.integers(0, 100, 8).astype(float)
        rt.update_load(expert_load)
        rj.update_load(expert_load)
        view = View({d: (2.0 if (d == 1 and i >= 2) else 1.0)
                     for d in range(4)})
        np.testing.assert_array_equal(rt.on_contention(view).expert_to_device,
                                      rj.on_contention(view).expert_to_device)
        assert (rt.moves, rt.rebalances) == (rj.moves, rj.rebalances)
    assert rt.rebalances >= 1
