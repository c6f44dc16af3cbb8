"""The slice end to end: `run_cachex("skylake_sp")` in the port (plain
engine on the CPU) equals the JAX package's report in every field but
``wall_s``, both equal the golden report, and the sessions' exported
abstractions are byte-identical.  Kept in a file of its own so that
xdist's ``--dist loadfile`` gives it a worker.
"""

import dataclasses
import json
from pathlib import Path

import pytest

from repro.core import abstraction as jabs
from repro.core import runner as jrun
from repro_torch import _build
from repro_torch.core import abstraction as tabs
from repro_torch.core import runner as trun

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


def test_run_cachex_tune_is_not_ported():
    with pytest.raises(NotImplementedError):
        trun.run_cachex("skylake_sp", device="cpu", tune=True)
