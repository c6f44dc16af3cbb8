"""The port's plan cost model and lowering autotuner against the JAX
package's (`repro.core.plancost`).

With the JAX package's cost constants put into the port's `plancost`
(the port's own were measured for the CUDA engine), `plan_cost` predicts
the same counts, wall estimate and dominant term, and the model-only
`tune_lowering` makes the same choice from the same trials as the JAX
package did in `tests/data/torch_golden_tune.json` (written by
`tests/torch_goldens.py`: these tests never call the JAX tuner, whose
timed choices, and whose caches, other tests depend on).  The measured
tuner is held to its structure only: the trial set, and ``cached`` on
reuse; no timed choice is asserted.  `run_cachex(tune=True)` equals the
JAX package's tuned golden report.
"""

import dataclasses

import numpy as np
import pytest

from repro.core import plancost as jpc
from repro.core import platforms as jplat
from repro_torch.core import abstraction as tabs
from repro_torch.core import host_model as thm
from repro_torch.core import plancost as tpc
from repro_torch.core import platforms as tplat
from repro_torch.core import runner as trun
from tests._torch_parity import (golden, jax_caches_restored,  # noqa: F401
                                 jax_costs, port_caches_fresh)
from tests.torch_goldens import TUNE_GUESTS, report_fields, tune_fields

PLATFORMS = tplat.list_platforms()


def _plans(name, n_lanes, lane_len, seg_lens):
    return (jpc._synthetic_plan(jplat.get_platform(name), n_lanes, lane_len,
                                seg_lens),
            tpc._synthetic_plan(tplat.get_platform(name), n_lanes, lane_len,
                                seg_lens))


LOWERINGS = [None,
             dict(fuse_commits=False),
             dict(lane_bucket=64, batch_bucket=16),
             dict(lane_bucket=1, lockstep=False),
             dict(shard_size=16),
             dict(shard_size=5, lane_bucket=128)]


@pytest.mark.parametrize("name", ["skylake_sp", "milan_ccx", "skylake_cat"])
@pytest.mark.parametrize("cut", [(8, 9, [36, 36]), (40, 17, [512, 9, 3]),
                                 (3, 200, [700])])
def test_plan_cost_matches_jax(name, cut, jax_costs):
    """Every lowering x guest count: the same shapes, dispatches, padded
    steps, hits and misses against a shape cache that already holds some
    of them, and the same wall estimate and dominant term."""
    jplan, tplan = _plans(name, *cut)
    jgeom = jplat.get_platform(name).machine()
    tgeom = tplat.get_platform(name).machine()
    for low in LOWERINGS:
        jlow = dataclasses.replace(jplat.get_platform(name).plan_lowering(),
                                   **(low or {}))
        tlow = dataclasses.replace(tplat.get_platform(name).plan_lowering(),
                                   **(low or {}))
        for n in (1, 2, 7, 64):
            jcache, tcache = jpc.ShapeCache(), tpc.ShapeCache()
            for kind, shape in jpc.plan_shapes(jplan, jlow, n)[::2]:
                jcache.note(kind, jgeom, shape)
                tcache.note(kind, tgeom, shape)
            want = jpc.plan_cost(jplan, jlow, jplat.get_platform(name), n,
                                 shape_cache=jcache)
            got = tpc.plan_cost(tplan, tlow, tplat.get_platform(name), n,
                                shape_cache=tcache)
            assert dataclasses.asdict(got) == dataclasses.asdict(want), \
                (low, n)
            assert got.dominant in ("compile", "dispatch", "steps")


@pytest.mark.parametrize("name", PLATFORMS)
def test_model_only_tune_matches_the_jax_golden(name, jax_costs,
                                                port_caches_fresh):
    """Synthetic plan, 1, 4 and 8 guests, empty caches: the chosen
    lowering and every trial's knob, candidate, cutout, pred_misses and
    score as the JAX package's model-only tuner gave them."""
    want = golden("tune")[name]["tune"]
    plat = tplat.get_platform(name)
    for n in TUNE_GUESTS:
        tpc.clear_tune_cache()
        rep = tpc.tune_lowering(plat, None, n_guests=n, measure=False)
        assert not rep.measured and not rep.cached
        assert tune_fields(rep) == want[str(n)], n
        again = tpc.tune_lowering(plat, None, n_guests=n, measure=False)
        assert again.cached and again.chosen == rep.chosen


def test_measured_tuner_structure(port_caches_fresh):
    """The measured tuner on the CPU: the trials of the model-only scan
    (same knobs and candidates; the same cutouts and predicted new shapes
    for the lane-bucket and fusion knobs, whose cutouts do not depend on
    an earlier timed choice), each with a measured time; a repeat is
    served from the cache; the workload's dispatch counter and shape
    cache are as before.  No timed choice is asserted."""
    plat = tplat.get_platform("milan_ccx")
    model = tpc.tune_lowering(plat, None, n_guests=4, measure=False)
    d0, shapes0 = thm.probe_dispatch_count(), tpc.SHAPE_CACHE.snapshot()
    rep = tpc.tune_lowering(plat, None, n_guests=4, measure=True,
                            device="cpu", reps=2)
    assert rep.measured and not rep.cached
    assert thm.probe_dispatch_count() == d0
    assert tpc.SHAPE_CACHE.snapshot() == shapes0

    def key(t):
        if t.knob == "lockstep":      # its cutout pads to the timed bucket
            return (t.knob, t.candidate)
        return (t.knob, t.candidate, tuple(t.cutout), t.pred_misses)
    assert [key(t) for t in rep.trials] == [key(t) for t in model.trials]
    assert {t.knob for t in rep.trials} == {"lane_bucket", "fuse_commits",
                                            "lockstep"}
    assert all(t.measured_s > 0 for t in rep.trials)
    for knob in ("lane_bucket", "fuse_commits", "lockstep"):
        assert sum(t.chosen for t in rep.trials if t.knob == knob) == 1
    again = tpc.tune_lowering(plat, None, n_guests=4, measure=True,
                              device="cpu")
    assert again.cached and again.chosen == rep.chosen
    # a cached measured result also serves a model-only request
    assert tpc.tune_lowering(plat, None, n_guests=4, measure=False).measured


def test_run_cachex_tuned_equals_the_jax_golden(monkeypatch, jax_costs,
                                                port_caches_fresh):
    """`run_cachex(tune=True)` on the CPU, under the JAX cost constants
    and with the caches empty as the golden's process had them: equal to
    the JAX package's tuned report; the session runs the lowering the
    tuner chose."""
    sessions = []
    attach = tabs.CacheXSession.attach

    def keep(*args, **kwargs):
        sessions.append(attach(*args, **kwargs))
        return sessions[-1]

    monkeypatch.setattr(tabs.CacheXSession, "attach", keep)
    report = trun.run_cachex("skylake_sp", device="cpu", tune=True)
    assert report_fields(report) == golden("run_cachex_skylake_sp_tuned")
    (session,) = sessions
    rep = tpc.tune_lowering(tplat.get_platform("skylake_sp"),
                            session.plan(), n_guests=1, measure=False)
    assert rep.cached and session.config.lowering == rep.chosen


def test_tuned_lowering_installs_the_choice(port_caches_fresh):
    """`CacheXSession.tuned_lowering` tunes the session's monitoring
    plan on the session VM's device and installs the choice in the
    config and the VSCAN stage."""
    plat = tplat.get_platform("milan_ccx")
    _, vm = plat.make_host_vm(seed=3, device="cpu")
    session = tabs.CacheXSession.attach(
        vm, plat, tabs.ProbeConfig.for_platform(plat, seed=3))
    rep = session.tuned_lowering(n_guests=4)
    plan = session.plan()
    assert rep.platform == "milan_ccx" and rep.n_guests == 4
    assert rep.signature == plan.signature() and not rep.measured
    assert session.config.lowering == rep.chosen == session._vs.lowering
    assert plan.hints == rep.chosen
    again = session.tuned_lowering(n_guests=4)
    assert again.cached and again.chosen == rep.chosen
    assert isinstance(rep, tpc.TuneReport) and rep.trials
    assert np.all([t.measured_s == 0.0 for t in rep.trials])
