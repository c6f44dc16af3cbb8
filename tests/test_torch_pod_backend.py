"""The port's pod backend (`repro_torch.tpuprobe.pod_backend`) against the
JAX package's on the CPU, scenario for scenario of
tests/test_pod_backend.py: `SimPod` latencies and dispatch counts, the
probe plans with their signatures and costs, `PodScan`, the `PodSession`
surface and its exports (crossing both packages), the registry, the
consumers' reactions, and the closed pod loop against the JAX package
and the golden it wrote (tests/data/torch_golden_pod_loop.json).

Both packages run the same numpy arithmetic, so everything is held
exactly: every integer, every float, every decision.
"""

import dataclasses
import json

import numpy as np
import pytest

from repro.core import CacheXSession as JSession
from repro.core import plan_cost as jplan_cost
from repro.core.probeplan import execute as jexecute
from repro.core.probeplan import fuse as jfuse
from repro.core.probeplan import split_result as jsplit
from repro.tpuprobe import pod_backend as jp
from repro_torch.core import (CacheXSession, StaleAbstractionError,
                              get_backend, list_backends, plan_cost)
from repro_torch.core.probeplan import execute, fuse, split_result
from repro_torch.tpuprobe import pod_backend as tp
from tests._torch_parity import (golden, jax_caches_restored,  # noqa: F401
                                 jax_costs, port_caches_fresh)
from tests.torch_goldens import report_fields

MESH = {"data": 2, "model": 4}


def pods(**kw):
    """The same pod in both packages (make_pod of tests/test_pod_backend.py)."""
    kw.setdefault("mesh_shape", dict(MESH))
    kw.setdefault("seed", 7)
    kw.setdefault("reserved_vmem", (3 << 20) + 12345)
    return jp.SimPod(**kw), tp.SimPod(**kw)


def as_json(x):
    if dataclasses.is_dataclass(x):
        x = dataclasses.asdict(x)
    return json.loads(json.dumps(x, sort_keys=True, default=_np))


def _np(x):
    if isinstance(x, np.ndarray):
        return x.tolist()
    if isinstance(x, (np.integer, np.floating, np.bool_)):
        return x.item()
    if isinstance(x, set):
        return sorted(x)
    raise TypeError(type(x))


def values(result):
    """A PlanResult's values as lists: None for an op with no result, a
    list a lane for a Measure, the verdicts of a Vote."""
    out = []
    for v in result.values:
        if v is None or isinstance(v, np.ndarray):
            out.append(None if v is None else v.tolist())
        else:
            out.append([np.asarray(l).tolist() for l in v])
    return out


HOT = {"ramp": lambda c, t: 1.0 + 0.2 * c,
       "hot3": lambda c, t: 2.0 if c == 3 else 1.0,
       "timed": lambda c, t: 3.0 if (c == 2 and t >= 20.0) else 1.0}


# -- SimPod / PodSlice ----------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 7, 8])
@pytest.mark.parametrize("schedule", sorted(HOT))
def test_simpod_session_export_equals_jax(seed, schedule):
    """attach(eager) + 5 refreshes: the export, field for field."""
    out = []
    for mod, pod in zip((jp, tp), pods(seed=seed,
                                       hbm_schedule=HOT[schedule])):
        s = mod.PodSession.attach(pod.slice(), eager=True)
        for _ in range(5):
            s.refresh()
        out.append(as_json(s.export()))
    assert out[0] == out[1]


def test_slice_latencies_and_counts_equal_jax():
    """One dispatch of every lane kind at several salts: latencies, the
    slice's and the pod's dispatch and access counts."""
    jpod, tpod = pods(hbm_schedule=HOT["ramp"],
                      link_schedule=lambda a, h, t: 1.7 if h == 1 else 1.0)
    lanes = [np.array([jp.encode_lane(jp.KIND_HBM, c, 0)] * 3, np.int64)
             for c in range(8)]
    lanes += [np.array([jp.encode_lane(jp.KIND_ICI, a, h)] * 2, np.int64)
              for a in range(2) for h in range(2)]
    lanes += [np.array([jp.encode_lane(jp.KIND_VMEM, 0, q)], np.int64)
              for q in (1, 40, 52, 53, 64)]
    got = []
    for pod in (jpod, tpod):
        sl = pod.slice()
        lat = [[l.tolist() for l in sl.timed_access_batch(lanes, salt=s)]
               for s in (0, 1, 5)]
        got.append((lat, sl.stat_dispatches, sl.stat_accesses,
                    pod.stat_dispatches, pod.stat_accesses))
    assert got[0] == got[1]
    with pytest.raises(ValueError):
        tpod.slice().timed_access_batch(
            [np.array([tp.encode_lane(9, 0, 0)], np.int64)])


def test_lane_encoding_and_coords_equal_jax():
    for kind, a, b in ((1, 0, 0), (2, 3, 17), (3, 1023, 64)):
        enc = tp.encode_lane(kind, a, b)
        assert enc == jp.encode_lane(kind, a, b)
        assert tp.decode_lane(enc) == jp.decode_lane(enc) == (kind, a, b)
    jpod, tpod = pods(mesh_shape={"pod": 2, "data": 2, "model": 3})
    assert [tpod.chip_coords(c) for c in range(tpod.n_chips)] == \
        [jpod.chip_coords(c) for c in range(jpod.n_chips)]


# -- the probes as plans --------------------------------------------------------


@pytest.mark.parametrize("reserved", [0, 3 << 20, (5 << 20) + 777,
                                      (16 << 20) - 1])
def test_vmem_plan_equals_jax(reserved):
    res = []
    for mod, pod in zip((jp, tp), pods(reserved_vmem=reserved)):
        plan = mod.vmem_plan(range(pod.n_chips))
        result = (jexecute if mod is jp else execute)(pod.slice(), plan)
        res.append((plan.signature(), plan.n_dispatches, plan.meta,
                    values(result), mod.apply_vmem(plan, result)))
    assert res[0] == res[1]
    assert res[1][0] == ("WarmTimer", "Vote[vmem]") and res[1][1] == 1


@pytest.mark.parametrize("bad", [("model", 2), ("data", 1), ("model", 0)])
def test_ici_plan_and_degraded_hops_equal_jax(bad):
    res = []
    for mod, pod in zip((jp, tp), pods(
            link_schedule=lambda ax, hop, t: 2.0 if (ax, hop) == bad
            else 1.0)):
        plan = mod.ici_plan(pod.mesh_shape)
        stats = mod.apply_ici(plan, (jexecute if mod is jp else execute)(
            pod.slice(), plan))
        res.append((plan.signature(), stats,
                    {a: mod.degraded_hops(stats, a, threshold=1.3)
                     for a in stats}))
    assert res[0] == res[1]
    assert res[1][2][bad[0]] == [bad[1]]


def test_pod_plans_cost_and_fuse_equal_jax(jax_costs, port_caches_fresh):
    """Signatures, `plan_cost` (under the JAX cost constants, both shape
    caches empty) and the fused plan's split results."""
    from repro.core.plancost import SHAPE_CACHE
    SHAPE_CACHE.clear()
    res = []
    for mod, pod in zip((jp, tp), pods()):
        ex, fu, sp, cost = ((jexecute, jfuse, jsplit, jplan_cost)
                            if mod is jp else
                            (execute, fuse, split_result, plan_cost))
        s = mod.PodSession.attach(pod.slice())
        plan = s.plan()
        fused, spans = fu([plan, s.plan()])
        parts = sp(ex(pod.slice(), fused), spans)
        res.append((plan.signature(), plan.n_dispatches,
                    as_json(cost(plan)), fused.signature(),
                    [values(p) for p in parts]))
    assert res[0] == res[1]
    assert res[1][2]["dispatches"] == res[1][1]


# -- the monitor (PodScan) ------------------------------------------------------


@pytest.mark.parametrize("alpha", [1.0, 0.3])
def test_podscan_tiers_equal_jax(alpha):
    """Tiers, EWMA and state_dict after each of 6 windows."""
    seq = []
    for mod, pod in zip((jp, tp), pods(hbm_schedule=HOT["hot3"])):
        scan = mod.PodScan(pod.slice(), ewma_alpha=alpha)
        trace = []
        for _ in range(6):
            snap = scan.monitor_once()
            trace.append((dict(scan.tiers.tier), as_json(snap),
                          as_json(scan.state_dict())))
        seq.append(trace)
    assert seq[0] == seq[1]
    if alpha == 1.0:   # the 3-interval commit of the JAX test
        assert [t[0][3] for t in seq[1][:4]] == [0, 0, 2, 2]


def test_podscan_quarantine_and_confirm_clean_equal_jax():
    res = []
    for mod, pod_of in ((jp, jp.SimPod), (tp, tp.SimPod)):
        state = {"broken": True}
        pod = pod_of(mesh_shape=dict(MESH), seed=7,
                     hbm_schedule=lambda c, t: 8.0
                     if (c == 1 and state["broken"]) else 1.0)
        s = mod.PodSession.attach(pod.slice())
        drifts = []
        s.subscribe_drift(drifts.append)
        for _ in range(3):
            s.refresh()
        scan = s.monitored_sets()
        flagged = sorted(scan.flagged)
        drift = s.check_drift()
        state["broken"] = False
        s.refresh()
        res.append((flagged, [as_json(d) for d in drifts], drift,
                    scan.confirm_clean([1]), sorted(scan.flagged)))
    assert res[0] == res[1]
    assert res[1][0] == [1] and res[1][3] == [1] and res[1][4] == []


def test_podscan_state_roundtrip():
    _, pod = pods(hbm_schedule=HOT["ramp"])
    scan = tp.PodScan(pod.slice())
    for _ in range(3):
        scan.monitor_once()
    back = tp.PodScan.from_state(pod.slice(), scan.state_dict())
    assert back.state_dict() == scan.state_dict()


# -- session surface ------------------------------------------------------------


def test_backend_registry_dispatch():
    assert "llc" in list_backends() and "pod" in list_backends()
    assert get_backend("pod").name == "pod"
    assert get_backend("pod").formats == ("cachex-pod-abstraction/v1",)
    with pytest.raises(KeyError):
        get_backend("gpu")
    _, pod = pods()
    s = CacheXSession.attach(pod.slice(), "pod", backend="pod")
    assert isinstance(s, tp.PodSession)


def test_pod_session_surface_equals_jax():
    """topology, colors, contention, subscriptions and validate, through
    `CacheXSession.attach(backend="pod")` in both packages."""
    res = []
    for sess, pod in zip((JSession, CacheXSession),
                         pods(hbm_schedule=lambda c, t: 1.0 + 0.1 * c)):
        s = sess.attach(pod.slice(), "pod", backend="pod", eager=True)
        colors = s.colors()
        view = s.contention()
        seen = []
        tok = s.subscribe(seen.append)
        s.refresh()
        s.unsubscribe(tok)
        s.refresh()
        res.append((as_json(s.topology()), colors.n_zones,
                    [colors.zone_of(c, k) for c in range(8)
                     for k in ("hbm", "vmem")],
                    [(colors.chip_of(z), colors.kind_of(z))
                     for z in range(16)],
                    colors.build_free_lists(2), as_json(view),
                    [as_json(v) for v in seen], s.validate(),
                    s.effective_vmem(5), s.axis_stats()))
    assert as_json(res[0]) == as_json(res[1])
    assert res[1][7]["vmem_ok"] and res[1][7]["link_ok"]


def test_pod_export_equals_jax_and_imports_across_packages():
    exports = []
    for mod, pod in zip((jp, tp), pods()):
        s = mod.PodSession.attach(pod.slice(), eager=True)
        for _ in range(3):
            s.refresh()
        exports.append(json.loads(s.export_json()))
    assert exports[0] == exports[1]
    assert exports[1]["format"] == "cachex-pod-abstraction/v1"
    jpod, tpod = pods()
    # the JAX export into the port, and the port's into JAX
    t_from_j = tp.PodSession.import_(tpod.slice(), exports[0])
    j_from_t = jp.PodSession.import_(jpod.slice(), exports[1])
    assert as_json(t_from_j.export()) == as_json(j_from_t.export()) \
        == exports[0]
    # CacheXSession.import_ routes a pod export to the backend
    assert isinstance(CacheXSession.import_(tpod.slice(), exports[0]),
                      tp.PodSession)
    assert isinstance(JSession.import_(jpod.slice(), exports[1]),
                      jp.PodSession)
    # restored sessions refresh on as the originals do
    for s in (t_from_j, j_from_t):
        s.refresh()
    assert as_json(t_from_j.export()) == as_json(j_from_t.export())


def test_pod_staleness_and_repair_equal_jax():
    res = []
    for mod, pod in zip((jp, tp), pods()):
        s = mod.PodSession.attach(pod.slice(), eager=True)
        js = s.export_json()
        pod.reprovision(reserved_vmem=6 << 20)
        stale = mod.PodSession.import_json
        with pytest.raises(Exception) as err:
            stale(pod.slice(), js)
        s4 = stale(pod.slice(), js, allow_stale=True)
        res.append((type(err.value).__name__, s4.check_drift(),
                    as_json(s4.repair()), s4.validate(),
                    as_json(s4.export())))
    assert res[0] == res[1]
    assert res[1][0] == "StaleAbstractionError"
    _, tpod = pods()
    tpod.reprovision()
    js = tp.PodSession.attach(pods()[1].slice(), eager=True).export_json()
    with pytest.raises(StaleAbstractionError):
        tp.PodSession.import_json(tpod.slice(), js)
    with pytest.raises(ValueError):
        tp.PodSession.import_(tpod.slice(), {"format": "not-a-format"})


def test_llc_import_still_rejects_garbage():
    from repro_torch.core import get_platform
    _host, vm = get_platform("skylake_sp").make_host_vm(
        seed=0, with_noise=False, device="cpu")
    with pytest.raises(ValueError):
        CacheXSession.import_(vm, {"format": "not-a-format"})


# -- the consumers on the session ------------------------------------------------


def test_staging_pool_follows_pod_colors_equal_jax():
    from repro.data.pipeline import ColoredStagingPool as JPool
    from repro_torch.data.pipeline import ColoredStagingPool as TPool
    res = []
    for mod, pool_of, pod in zip((jp, tp), (JPool, TPool), pods(
            hbm_schedule=lambda c, t: 3.0 if c == 0 else 1.0)):
        s = mod.PodSession.attach(pod.slice(), eager=True)
        pool = pool_of.from_colors(s.colors(), bufs_per_zone=2)
        s.subscribe(pool.on_contention)
        handles = []
        for _ in range(4):
            s.refresh()
            h = pool.stage(np.zeros(4))
            handles.append(tuple(h[:2]) if isinstance(h, tuple) else h)
            pool.release(h)
        res.append((sorted(pool.cap.free_lists), as_json(handles)))
    assert res[0] == res[1]
    assert res[1][1][-1][0] == 0   # chip 0's HBM arena, the hottest zone


def test_router_mitigator_and_experts_react_equal_jax():
    """The three subscribers of `PodFleetSim` on one session's views:
    router tiers and routes, the microbatch plan, expert moves."""
    from repro.core.cas import TierTracker as JTiers
    from repro.distributed.rebalance import ExpertRebalancer as JExperts
    from repro.distributed.rebalance import StragglerMitigator as JMit
    from repro.serve.engine import ReplicaRouter as JRouter
    from repro_torch.core.cas import TierTracker as TTiers
    from repro_torch.distributed.rebalance import ExpertRebalancer as TExperts
    from repro_torch.distributed.rebalance import StragglerMitigator as TMit
    from repro_torch.serve.engine import ReplicaRouter as TRouter
    res = []
    for mod, (tiers, router_of, mit_of, exp_of), pod in zip(
            (jp, tp), ((JTiers, JRouter, JMit, JExperts),
                       (TTiers, TRouter, TMit, TExperts)),
            pods(hbm_schedule=lambda c, t: 2.4 if c == 4 else 1.0)):
        s = mod.PodSession.attach(pod.slice(), eager=True)
        router = router_of(8, tiers=tiers(keys=list(range(8)),
                                          thresholds=[1.15, 1.5]))
        mit = mit_of(8, 32)
        exp = exp_of(16, 8, experts_per_device=2, thresholds=(1.15, 1.5))
        exp.update_load(np.arange(16, 0, -1, dtype=float))
        for fn in (router.tiers.on_contention, mit.on_contention,
                   exp.on_contention):
            s.subscribe(fn)
        trace = []
        for _ in range(5):
            s.refresh()
            trace.append((dict(router.tiers.tier),
                          [router.route() for _ in range(3)],
                          mit.plan.tolist(), mit.rebalances, exp.moves,
                          exp.placement.expert_to_device.tolist()))
        res.append(trace)
    assert res[0] == res[1]
    assert res[1][-1][4] > 0 and 4 not in res[1][-1][1]


def test_router_drained_replica_becomes_routable_again():
    from repro_torch.serve.engine import ReplicaRouter, Request
    r = ReplicaRouter(2)
    reqs = [Request(rid=i, prompt=np.zeros(1, np.int32)) for i in range(4)]
    for q in reqs:
        r.assign(q)
    assert list(r.load) == [2, 2]
    for q in reqs:
        if q.replica == 0:
            r.complete(q)
    assert list(r.load) == [0, 2] and r.route() == 0
    assert reqs[0].replica is None
    r.complete(reqs[0])                     # no-op
    with pytest.raises(ValueError):
        r.release(0)
        r.release(0)
        r.release(0)


# -- the closed pod loop --------------------------------------------------------


@pytest.mark.parametrize("mode", ["on", "off"])
def test_run_pod_loop_equals_jax_and_the_golden(mode):
    got = report_fields(tp.run_pod_loop(mode, seed=0))
    assert got == report_fields(jp.run_pod_loop(mode, seed=0))
    assert got == golden("pod_loop")[mode]


@pytest.mark.parametrize("seed", [1, 3])
def test_run_pod_loop_other_seeds_and_mesh_equal_jax(seed):
    kw = dict(seed=seed, intervals=20, warmup=4,
              mesh_shape={"data": 2, "model": 2})
    for mode in ("on", "off"):
        assert report_fields(tp.run_pod_loop(mode, **kw)) == \
            report_fields(jp.run_pod_loop(mode, **kw))


def test_closed_loop_improves_p99_and_step_time():
    g = golden("pod_loop")
    on, off = g["on"], g["off"]
    assert on["requests"] == off["requests"] > 0
    assert on["p99_decode_ms"] < off["p99_decode_ms"]
    assert on["mean_step_s"] < off["mean_step_s"]
    assert on["rebalances"] > 0 and on["expert_moves"] > 0
    assert off["rebalances"] == 0 and off["expert_moves"] == 0
    assert on["hot_request_frac"] < off["hot_request_frac"]


def test_pod_fleet_sim_12_6_equals_jax_and_the_golden():
    sims = [mod.PodFleetSim(intervals=12, warmup=6, rebalance="on")
            for mod in (jp, tp)]
    reports = [report_fields(s.run()) for s in sims]
    assert reports[0] == reports[1] == golden("pod_loop")["fleet_12_6"]
    sim = sims[1]
    assert reports[1]["hot_request_frac"] == 0.0
    assert sim.router.tiers.tier[sim.hot_chip] > 0
    assert list(sim.router.load) == [0] * sim.pod.n_chips   # all released
    assert sim.router.tiers.tier == sims[0].router.tiers.tier


def test_session_export_equals_the_golden():
    s = CacheXSession.attach(tp.SimPod().slice(), "pod", backend="pod",
                             eager=True)
    assert as_json(s.export()) == golden("pod_loop")["export"]


def test_pod_loop_report_fields_are_the_jax_fields():
    assert [f.name for f in dataclasses.fields(tp.PodLoopReport)] == \
        [f.name for f in dataclasses.fields(jp.PodLoopReport)]
    assert as_json(tp.PodProbeConfig()) == as_json(jp.PodProbeConfig())
    for name in ("POD_EXPORT_FORMAT", "NOMINAL_HBM_LAT", "NOMINAL_ICI_LAT",
                 "VMEM_FIT_LAT", "VMEM_OVER_LAT", "VMEM_THRESHOLD",
                 "VMEM_ALIGN"):
        assert getattr(tp, name) == getattr(jp, name), name
    assert as_json(tp.POD_LOWERING) == as_json(jp.POD_LOWERING)
