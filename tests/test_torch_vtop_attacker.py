"""`core/vtop.py` and `core/attacker.py` in the port against the JAX
package: the same inputs and seeds through both, the port on the CPU.

* `infer_llc_domains` groups the vCPUs of skylake_sp's and milan_ccx's
  fleet guests (two LLC domains each) as the JAX package does, which is
  the hypervisor's own map, with the same pair latencies and dispatches.
* `AttackerGuest`, both variants, on one victim: the same attach
  dispatches, profiled activity, targets, `AttackObservation` of every
  window (quiet, victim-active and under the attacker's own stream) and
  `AttackReport`.
* `attack_gen`: the same sweep under any rng.
"""

import dataclasses

import numpy as np
import pytest

from repro.core import abstraction as jabs
from repro.core import attacker as jatk
from repro.core import fleet as jfleet
from repro.core import platforms as jplat
from repro.core import vtop as jvtop
from repro_torch.core import abstraction as tabs
from repro_torch.core import attacker as tatk
from repro_torch.core import fleet as tfleet
from repro_torch.core import platforms as tplat
from repro_torch.core import vtop as tvtop
from tests._hypothesis_compat import given, settings, st
from tests._torch_parity import jax_caches_restored  # noqa: F401

PACKAGES = {"jax": (jplat, jabs, jatk, jfleet, jvtop, {}),
            "torch": (tplat, tabs, tatk, tfleet, tvtop, {"device": "cpu"})}


def _fleet_guest(pkg, name, seed):
    plat_mod, _, _, fleet_mod, _, dev = PACKAGES[pkg]
    plat = fleet_mod.fleet_view(plat_mod.get_platform(name),
                                len(fleet_mod.default_workloads()))
    return plat, plat.make_host_vm(seed=seed, **dev)[1]


@pytest.mark.parametrize("name", ["skylake_sp", "milan_ccx"])
def test_infer_llc_domains_matches_jax(name):
    out = {}
    for pkg in PACKAGES:
        vtop = PACKAGES[pkg][4]
        plat, vm = _fleet_guest(pkg, name, seed=5)
        pages = vm.alloc_pages(64)
        lat = [vtop.probe_pair_latency(vm, a, b, [vm.gva(int(pages[i]), 0)
                                                  for i in range(3)])
               for a, b in ((0, 1), (0, 4))]
        groups = vtop.infer_llc_domains(vm, pages[3:])
        truth = {v: int(c) // plat.cores_per_domain
                 for v, c in enumerate(vm.vcpu_cores)}
        out[pkg] = (groups, vtop.domain_of(groups), lat, vm.stat_passes,
                    vm.stat_accesses, truth)
    assert out["torch"] == out["jax"]
    groups, dom, _, _, _, truth = out["torch"]
    assert len(groups) == 2
    assert sorted(map(sorted, groups)) == sorted(
        [v for v in truth if truth[v] == d] for d in set(truth.values()))
    assert all(dom[v] == dom[g[0]] for g in groups for v in g)


def _attack_trace(pkg):
    """Victim attach, then each variant's attacker on the same host:
    attach, profile through the victim's refreshes, targets, a quiet
    window, a victim-active probe, windows under its own stream."""
    plat_mod, abs_mod, atk_mod, _, _, dev = PACKAGES[pkg]
    plat = plat_mod.get_platform("skylake_sp")
    host, vm = plat.make_host_vm(seed=1, **dev)
    session = abs_mod.CacheXSession.attach(
        vm, plat, abs_mod.ProbeConfig.for_platform(
            plat, seed=1, prune_self_conflicts=True))
    session.monitored_sets()
    trace = []
    for variant in ("primeprobe", "evicttime"):
        atk = atk_mod.AttackerGuest(host, plat, seed=1, variant=variant,
                                    name=variant)
        act = atk.profile(rounds=2, between=lambda: session.refresh())
        targets = atk.choose_targets(k=2)
        quiet = atk.observe(window_ms=3.0)
        atk.prime()
        session.refresh()
        busy = atk.probe()
        atk.begin()
        windows = [atk.observe(window_ms=2.0) for _ in range(2)]
        session.refresh()
        atk.stop()
        plan = atk.window_plan(3.0)
        trace.append({
            "attach_dispatches": atk.attach_dispatches,
            "activity": act.tolist(), "targets": targets,
            "blocks": atk.target_blocks().tolist(),
            "windows": [dataclasses.asdict(o) for o in [quiet] + windows],
            "victim_active": [o.victim_active for o in [quiet] + windows],
            "busy": busy.tolist(), "plan": (plan.label, plan.signature(),
                                            plan.meta["order"]),
            "report": dataclasses.asdict(atk.report()),
            "host_time_ms": host.time_ms,
            "victim_rates": session.contention().per_domain})
    return trace


def test_attacker_guest_matches_jax():
    want, got = _attack_trace("jax"), _attack_trace("torch")
    for w, g in zip(want, got):
        assert g == w
    assert [t["report"]["variant"] for t in got] == ["primeprobe",
                                                      "evicttime"]
    assert all(t["attach_dispatches"] > 0 and t["report"]["windows"] == 3
               for t in got)
    assert max(got[0]["busy"]) >= 0.5


@settings(max_examples=20, deadline=None)
@given(n_blocks=st.integers(1, 64), n=st.integers(1, 700),
       seed=st.integers(0, 10**6))
def test_attack_gen_matches_jax(n_blocks, n, seed):
    blocks = np.arange(300, 300 + 7 * n_blocks, 7, dtype=np.int64)
    want = jatk.attack_gen(blocks)(np.random.default_rng(seed), n)
    got = tatk.attack_gen(blocks)(np.random.default_rng(seed + 1), n)
    assert got.dtype == want.dtype and np.array_equal(got, want)
