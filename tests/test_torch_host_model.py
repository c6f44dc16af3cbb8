"""Parity of the port's host model (`repro_torch.core.host_model`, machine
state on the CPU) with the JAX package's: timed, committed, batched and
multi-guest latencies with guest-TSC noise, co-tenant traffic and host
events, the validation hypercalls, and the dispatch / compile-shape
accounting.  Every comparison is exact: the host logic is the same numpy.
"""

import contextlib

import numpy as np
import pytest

from repro.core import cachesim as jsim
from repro.core import host_model as jhm
from repro.core import plancost as jpc
from repro_torch.core import cachesim as tsim
from repro_torch.core import host_model as thm
from repro_torch.core import plancost as tpc


def make_pair(seed=0, replacement="lru", n_domains=1, cores_per_domain=2,
              mapping="fragmented", n_guest_pages=1 << 12):
    """The same small machine + guest booted by both packages (the
    geometry of tests/conftest.py)."""
    out = []
    for sim, hm in ((jsim, jhm), (tsim, thm)):
        geom = sim.MachineGeometry(
            n_domains=n_domains, cores_per_domain=cores_per_domain,
            l2=sim.CacheGeometry(256, 8), llc=sim.CacheGeometry(512, 8, 2),
            replacement=replacement)
        kw = {} if sim is jsim else {"device": "cpu"}
        host = hm.SimHost(geom, n_host_pages=1 << 14, seed=seed, **kw)
        vm = hm.GuestVM(host, n_guest_pages=n_guest_pages, mapping=mapping,
                        vcpu_cores=list(range(geom.n_cores)), seed=seed)
        out.append((host, vm))
    return out


def assert_same_machine(jhost, thost):
    want = {"l2": [np.asarray(x) for x in jhost.state["l2"]],
            "llc": [np.asarray(x) for x in jhost.state["llc"]]}
    got = tsim.state_to_numpy(thost.state)
    for key in ("l2", "llc"):
        for g, w in zip(got[key], want[key]):
            np.testing.assert_array_equal(g, w)
    assert int(got["clock"]) == int(jhost.state["clock"])
    assert int(got["rng"]) == int(jhost.state["rng"])
    assert thost.time_ms == jhost.time_ms and thost.epoch == jhost.epoch


@contextlib.contextmanager
def fresh_accounting():
    """Both packages' process-wide compile-shape caches, emptied for the
    test and restored after it (other tests in the worker share them)."""
    snaps = [pc.SHAPE_CACHE.snapshot() for pc in (jpc, tpc)]
    for pc in (jpc, tpc):
        pc.SHAPE_CACHE.clear()
    try:
        yield
    finally:
        for pc, snap in zip((jpc, tpc), snaps):
            pc.SHAPE_CACHE.restore(snap)


def both(pair, fn):
    """Apply ``fn(host, vm)`` to both packages' pair; results as numpy."""
    return [fn(h, v) for h, v in pair]


def assert_lats_equal(a, b):
    if isinstance(a, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert_lats_equal(x, y)
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def accounting():
    return [(hm.probe_dispatch_count(), pc.SHAPE_CACHE.hits,
             pc.SHAPE_CACHE.misses,
             sorted((k, s) for k, _, s in pc.SHAPE_CACHE.shapes()))
            for hm, pc in ((jhm, jpc), (thm, tpc))]


@pytest.mark.parametrize("replacement", ["lru", "random"])
def test_timed_committed_and_batched_latencies_match(replacement):
    pair = make_pair(seed=3, replacement=replacement)
    with fresh_accounting():
        d0 = [jhm.probe_dispatch_count(), thm.probe_dispatch_count()]
        pages = both(pair, lambda h, v: v.alloc_pages(96))
        np.testing.assert_array_equal(*pages)
        gvas = np.array([pair[0][1].gva(int(p), 64 * (i % 8))
                         for i, p in enumerate(pages[0])], np.int64)
        # cold timed reads carry guest-TSC noise
        assert_lats_equal(*both(pair, lambda h, v: v.timed_access(gvas[:40])))
        both(pair, lambda h, v: v.access(gvas[40:], vcpu=1))
        both(pair, lambda h, v: v.access_segments(
            [(gvas[:30], 0), (gvas[50:], 1), (gvas[:0], 0)]))
        both(pair, lambda h, v: v.warm_timer())
        assert_lats_equal(*both(pair, lambda h, v: v.timed_access(gvas,
                                                                  vcpu=1)))
        lanes = [gvas[i:i + 9 + i % 5] for i in range(0, 80, 7)]
        for salt, lb, bb in ((0, None, None), (3, 32, 4), (1, 64, 16)):
            both(pair, lambda h, v: v.wait_ms(0.5))       # timer goes cold
            assert_lats_equal(*both(pair, lambda h, v: v.timed_access_batch(
                lanes, vcpu=[i % 2 for i in range(len(lanes))], salt=salt,
                lane_bucket=lb, batch_bucket=bb)))
        assert_same_machine(pair[0][0], pair[1][0])
        (jh, jv), (th, tv) = pair
        assert (jv.stat_passes, jv.stat_accesses, jv._probe_seq) == \
            (tv.stat_passes, tv.stat_accesses, tv._probe_seq)
        acc = accounting()
        assert acc[0][0] - d0[0] == acc[1][0] - d0[1]
        assert acc[0][1:] == acc[1][1:]


def test_cotenants_events_and_hypercalls_match():
    pair = make_pair(seed=5, n_domains=2)
    for h, v in pair:
        hm = jhm if h.__class__ is jhm.SimHost else thm
        h.add_cotenant(hm.CotenantWorkload("pol", 0, 40.0,
                                           hm.polluter_gen(region_pages=512)))
        h.add_cotenant(hm.CotenantWorkload("zipf", 1, 25.0, hm.zipf_gen(),
                                           core=3, l2_local=True))
        h.schedule_events([
            hm.HostEvent(at_ms=1.0, kind="remap", fraction=0.25),
            hm.HostEvent(at_ms=2.5, kind="cotenant",
                         retarget={"name": "pol", "domain": 1,
                                   "rate_per_ms": 60.0}),
            hm.HostEvent(at_ms=4.0, kind="migrate", new_slice_seed=0x51C37),
            hm.HostEvent(at_ms=5.5, kind="cat", new_llc_ways=6),
        ])
    pages = both(pair, lambda h, v: v.alloc_pages(64))
    gvas = np.array([pair[0][1].gva(int(p), 0) for p in pages[0]], np.int64)
    for step in range(7):
        both(pair, lambda h, v: v.access(gvas[step::3], vcpu=step % 4))
        both(pair, lambda h, v: v.wait_ms(0.9))
        assert_lats_equal(*both(pair, lambda h, v: v.timed_access_batch(
            [gvas[:12], gvas[20:33]], vcpu=[0, 2], salt=step)))
        assert_same_machine(pair[0][0], pair[1][0])
    (jh, jv), (th, tv) = pair
    assert th.epoch == jh.epoch == 3
    assert th.geom.llc.n_ways == jh.geom.llc.n_ways == 6
    assert th.geom.slice_seed == jh.geom.slice_seed == 0x51C37
    for g in gvas[:24]:
        assert tv.hypercall_llc_setslice(int(g)) == \
            jv.hypercall_llc_setslice(int(g))
        for vcpu in range(4):
            assert tv.hypercall_resident_level(int(g), vcpu) == \
                jv.hypercall_resident_level(int(g), vcpu)
        assert tv.hypercall_hpa_page(int(g) >> 12) == \
            jv.hypercall_hpa_page(int(g) >> 12)


@pytest.mark.parametrize("shard_size", [None, 2])
def test_multi_guest_dispatch_matches(shard_size):
    """Three guests, each on its own host: committed segments and batched
    lanes in fused (optionally sharded) dispatches, per-guest salts and
    noise draws included."""
    pairs = [make_pair(seed=s) for s in (1, 2, 3)]
    guests = list(zip(*pairs))          # (jax pairs, port pairs)
    with fresh_accounting():
        d0 = [jhm.probe_dispatch_count(), thm.probe_dispatch_count()]
        segs, lanes = [], []
        for (h, v) in guests[0]:
            pages = v.alloc_pages(48)
            g = np.array([v.gva(int(p), 128) for p in pages], np.int64)
            segs.append([(g[:20], 0), (g[20:], 1)])
            lanes.append([g[i:i + 10] for i in range(0, 30, 6)])
        for (h, v) in guests[1]:
            v.alloc_pages(48)
        vcpus = [[i % 2 for i in range(len(l))] for l in lanes]
        lanes[1] = []                     # a work-free guest
        out = []
        for hm, gs in ((jhm, guests[0]), (thm, guests[1])):
            vms = [v for _, v in gs]
            hm.commit_segments_sharded(vms, segs, shard_size=shard_size)
            r = hm.timed_access_batch_sharded(vms, lanes, vcpus, salt=2,
                                              shard_size=shard_size)
            out.append(r)
        assert_lats_equal(out[0], out[1])
        for (jh, jv), (th, tv) in zip(*guests):
            assert_same_machine(jh, th)
            assert jv.stat_passes == tv.stat_passes
        acc = accounting()
        assert acc[0][0] - d0[0] == acc[1][0] - d0[1]
        assert acc[0][1:] == acc[1][1:]


def test_padding_rules_are_the_reference_rules():
    for n in (0, 1, 7, 8, 9, 100, 128, 129, 1000):
        assert thm._ladder(n) == jhm._ladder(n)
        for bucket in (8, 32, 128, 512):
            assert thm._round_up(n, bucket) == jhm._round_up(n, bucket)
        arr = np.arange(n, dtype=np.int32)
        np.testing.assert_array_equal(thm._pad_to_bucket(arr, -1),
                                      jhm._pad_to_bucket(arr, -1))
    assert (thm._STREAM_BUCKET, thm._LANE_BUCKET, thm._BATCH_BUCKET) == \
        (jhm._STREAM_BUCKET, jhm._LANE_BUCKET, jhm._BATCH_BUCKET)
    for n, s in ((5, None), (5, 2), (7, 3), (4, 4), (4, 10)):
        assert thm.shard_slices(n, s) == jhm.shard_slices(n, s)
