"""The main path end to end: `run_cachex("skylake_sp")` in the port (the
engine on the CPU) equals the JAX package's report in every field but
``wall_s``, both equal the golden report, and the sessions' exported
abstractions are byte-identical; on every platform the port's report
equals the golden the JAX package wrote (`tests/torch_goldens.py`; all
but skylake_sp slow).  The session surface `run_cachex` does not touch,
held to the JAX package on skylake_sp: the drift, repair and stale-import
steps of examples/drift_repair.py, `import_json` across the packages both
ways, and `shield.classify_trace` on the labeled traces.  Kept in a file
of its own so that xdist's ``--dist loadfile`` gives it a worker.
"""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest

import repro.core as jcore
import repro_torch.core as tcore
from repro.core import abstraction as jabs
from repro.core import runner as jrun
from repro_torch import _build
from repro_torch.core import abstraction as tabs
from repro_torch.core import runner as trun
from tests._torch_parity import jax_caches_restored  # noqa: F401

GOLDEN = Path(__file__).parent / "data" / \
    "torch_golden_run_cachex_skylake_sp.json"


def _report_fields(report):
    d = dataclasses.asdict(report)
    d.pop("wall_s")
    return json.loads(json.dumps(d, sort_keys=True))


def _run_capturing_session(monkeypatch, abstraction, runner, **kw):
    sessions = []
    orig = abstraction.CacheXSession.attach

    def attach(*args, **kwargs):
        sessions.append(orig(*args, **kwargs))
        return sessions[-1]

    monkeypatch.setattr(abstraction.CacheXSession, "attach", attach)
    report = runner.run_cachex("skylake_sp", **kw)
    monkeypatch.undo()
    assert len(sessions) == 1
    return report, sessions[0]


def test_run_cachex_skylake_sp_matches_jax_exactly(monkeypatch):
    want, jsession = _run_capturing_session(monkeypatch, jabs, jrun)
    _build.reset_counters()
    got, tsession = _run_capturing_session(monkeypatch, tabs, trun,
                                           device="cpu")
    assert _build.PLAIN_CALLS["cachesim_engine"] == 361
    assert not _build.LAUNCHES
    assert type(got.cas_tiers) is dict and got.cas_tiers == want.cas_tiers
    assert _report_fields(got) == _report_fields(want)
    golden = json.loads(GOLDEN.read_text())
    assert _report_fields(want) == golden
    assert _report_fields(got) == golden
    assert got.csv_header() == want.csv_header()
    assert tsession.export_json() == jsession.export_json()


@pytest.mark.parametrize("name", [
    p if p == "skylake_sp" else pytest.param(p, marks=pytest.mark.slow)
    for p in tcore.list_platforms()])
def test_run_cachex_equals_the_jax_golden(name):
    """Every platform: the port's report on the CPU equals the golden the
    JAX package wrote, with one plain engine call a physical dispatch."""
    _build.reset_counters()
    got = _report_fields(trun.run_cachex(name, device="cpu"))
    path = Path(__file__).parent / "data" / \
        f"torch_golden_run_cachex_{name}.json"
    assert got == json.loads(path.read_text())
    assert _build.PLAIN_CALLS["cachesim_engine"] >= got["dispatches"]
    assert not _build.LAUNCHES


def _plain(x):
    """Numpy values and dataclasses as plain JSON-able values."""
    return json.loads(json.dumps(x, sort_keys=True, default=lambda v: (
        dataclasses.asdict(v) if dataclasses.is_dataclass(v)
        else np.asarray(v).tolist())))


def _drift_steps(core, dev):
    """The steps of examples/drift_repair.py on skylake_sp, as a trace
    of everything the session and the ground truth report."""
    plat = core.get_platform("skylake_sp")
    host, vm = plat.make_host_vm(seed=42, **dev)
    session = core.CacheXSession.attach(
        vm, plat, core.ProbeConfig.for_platform(plat, seed=42), eager=True)
    pages = vm.alloc_pages(8 * plat.n_l2_colors)
    trace = {"colors": session.colors().colors_of(pages),
             "view": session.refresh().per_domain,
             "attach_dispatches": vm.stat_passes}
    snapshot = session.export_json()
    signals = []
    session.subscribe_drift(signals.append)
    host.schedule_event(core.HostEvent(at_ms=host.time_ms + 0.5,
                                       kind="remap", fraction=0.25))
    vm.wait_ms(1.0)
    trace["remapped"] = session.validate()
    trace["check_drift"] = session.check_drift()
    d0 = vm.stat_passes
    trace["repair"] = session.repair()
    trace["repair_dispatches"] = vm.stat_passes - d0
    trace["repaired"] = session.validate()
    host.schedule_event(core.HostEvent(
        at_ms=host.time_ms + 0.5, kind="cat",
        new_llc_ways=max(2, plat.effective_ways // 2)))
    vm.wait_ms(1.0)
    for k in range(6):
        session.refresh()
        if signals:
            break
    trace["signals"] = [(k, sg.kind, list(sg.set_indices)) for sg in signals]
    trace["repair_cat"] = session.repair()
    trace["associativity"] = session.topology().detected_associativity
    trace["export"] = session.export_json()
    vm2 = vm.reboot(seed=43)
    with pytest.raises(core.StaleAbstractionError):
        core.CacheXSession.import_json(vm2, snapshot)
    salvaged = core.CacheXSession.import_json(vm2, snapshot,
                                              allow_stale=True)
    trace["salvage"] = salvaged.repair()
    trace["salvaged"] = salvaged.validate()
    return _plain(trace), snapshot


def test_drift_repair_steps_match_jax():
    want, jsnap = _drift_steps(jcore, {})
    got, tsnap = _drift_steps(tcore, {"device": "cpu"})
    assert got == want
    assert tsnap == jsnap
    assert got["signals"] and got["repair"]["pages_recolored"] > 0
    assert not got["repaired"]["stale"] and not got["salvaged"]["stale"]


def test_import_json_crosses_the_packages():
    """An abstraction exported by one package imports into the other on
    a fresh guest of the same host seed, re-exports to the same bytes,
    and the next monitoring interval reads the same view."""
    exports, views = {}, {}
    for name, core, dev in (("jax", jcore, {}),
                            ("torch", tcore, {"device": "cpu"})):
        plat = core.get_platform("icelake_sp")
        _, vm = plat.make_host_vm(seed=7, **dev)
        s = core.CacheXSession.attach(
            vm, plat, core.ProbeConfig.for_platform(plat, seed=7))
        s.monitored_sets()
        exports[name] = s.export_json()
    assert exports["torch"] == exports["jax"]
    for name, core, dev, src in (("torch", tcore, {"device": "cpu"}, "jax"),
                                 ("jax", jcore, {}, "torch")):
        plat = core.get_platform("icelake_sp")
        _, vm = plat.make_host_vm(seed=7, **dev)
        s = core.CacheXSession.import_json(vm, exports[src])
        assert s.export_json() == exports[src]
        views[name] = _plain((s.refresh().per_domain, vm.stat_passes))
    assert views["torch"] == views["jax"]


def test_classify_trace_matches_jax():
    traces = json.loads((Path(__file__).parent / "data" /
                         "shield_traces.json").read_text())
    for label, tr in traces.items():
        fracs = [np.asarray(f, float) for f in tr["fracs"]]
        want = jcore.classify_trace(fracs)
        got = tcore.classify_trace(fracs)
        assert got == want, label
    assert got["detected"]
