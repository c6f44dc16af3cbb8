"""Where the engine kernel keeps a lane's rows (`cachesim._engine_plan`):
the state in shared memory for every registered platform, rows copied on
first touch for the paper's Table 1 geometry, and the pool that design
allocates.  The state sizes are the JAX package's own (`init_machine`'s
arrays for the same geometry); the plan is pure Python, so the CPU runs
it.  The card tests in test_torch_gpu.py run both designs."""

import dataclasses

import numpy as np
import pytest

from repro.core import cachesim as jsim
from repro.core import platforms as jplat
from repro_torch.core import cachesim as tsim
from repro_torch.core import platforms as tplat

PLATFORMS = ["skylake_sp", "icelake_sp", "milan_ccx", "skylake_cat",
             "skylake_slicepart", "skylake_shared"]
# bytes of one guest's tags and ages: L2s of 2 x 256 x 8 (4 x 256 x 8 on
# milan_ccx) with LLCs of 2 slices x 512 x 8 (skylake_sp, skylake_shared),
# 256 x 12 (icelake_sp), 2 domains x 128 x 16 (milan_ccx), 2 slices x
# 512 x 4 (skylake_cat) and 512 x 8 (skylake_slicepart)
STATE_BYTES = {"skylake_sp": 98304, "icelake_sp": 57344,
               "milan_ccx": 98304, "skylake_cat": 65536,
               "skylake_slicepart": 65536, "skylake_shared": 98304}


def _table1():
    return tsim.MachineGeometry(l2=tsim.SKYLAKE_L2, llc=tsim.skylake_llc(20))


def _jax_state_bytes(tgeom):
    jgeom = jsim.MachineGeometry(
        n_domains=tgeom.n_domains, cores_per_domain=tgeom.cores_per_domain,
        l2=jsim.CacheGeometry(**dataclasses.asdict(tgeom.l2)),
        llc=jsim.CacheGeometry(**dataclasses.asdict(tgeom.llc)))
    st = jsim.init_machine(jgeom)
    return sum(int(np.asarray(x).nbytes) for x in (*st["l2"], *st["llc"]))


@pytest.mark.parametrize("commit", [False, True])
@pytest.mark.parametrize("name", PLATFORMS)
def test_platforms_stage_their_state_in_shared_memory(name, commit):
    geom = tplat.get_platform(name).machine()
    assert tsim._engine_plan(geom, 128, commit) == tsim.EnginePlan(
        "shared", STATE_BYTES[name], False, 0, 0)
    assert STATE_BYTES[name] == _jax_state_bytes(geom)
    assert jplat.get_platform(name).machine().l2.n_ways == geom.l2.n_ways
    assert STATE_BYTES[name] <= tsim.SMEM_BUDGET


def test_table1_copies_rows_on_first_touch():
    geom = _table1()
    state = _jax_state_bytes(geom)
    assert state == 3866624 > tsim.SMEM_BUDGET
    # measure mode: the row table (2,048 L2 + 40,960 LLC rows, int32) in
    # shared memory, pools sized from T
    plan = tsim._engine_plan(geom, 128, False)
    assert plan == tsim.EnginePlan("touch", 4 * 43008, True, 3 * 128, 128)
    # commit mode works in place: no table, no pool
    assert tsim._engine_plan(geom, 1536, True) == tsim.EnginePlan(
        "touch", 0, False, 0, 0)
    # pools never exceed the rows there are
    assert tsim._engine_plan(geom, 100000, False).l2_pool_rows == 2048


def test_table1_pool_at_256_lanes_of_128_steps():
    """The (256, 128) case the old design gave 1 GB of scratch (a whole
    state a lane): the pools hold (1 + cores_per_domain) x T L2 rows of
    16 ways and T LLC rows of 11 ways a lane, tags and ages."""
    geom = _table1()
    plan = tsim._engine_plan(geom, 128, False)
    lane = 8 * (plan.l2_pool_rows * geom.l2.n_ways
                + plan.llc_pool_rows * geom.llc.n_ways)
    assert (plan.l2_pool_rows, plan.llc_pool_rows) == (384, 128)
    assert lane == 60416
    assert 256 * lane == 15466496                 # was 256 whole states:
    assert 256 * _jax_state_bytes(geom) == 989855744


@pytest.mark.parametrize("name", ["skylake_sp", "milan_ccx", "table1"])
def test_budget_zero_forces_the_touch_design(name):
    """A budget of 0 (the card tests' way to run a platform through the
    copy-on-touch design): the table goes to device memory."""
    geom = _table1() if name == "table1" else \
        tplat.get_platform(name).machine()
    rows = (geom.n_cores * geom.l2.n_sets
            + geom.n_domains * geom.llc.n_slices * geom.llc.n_sets)
    plan = tsim._engine_plan(geom, 64, False, smem_budget=0)
    assert plan.design == "touch" and not plan.table_shared
    assert plan.shared_bytes == 0
    assert plan.l2_pool_rows == min(geom.n_cores * geom.l2.n_sets,
                                    (1 + geom.cores_per_domain) * 64)
    assert plan.llc_pool_rows == min(rows - geom.n_cores * geom.l2.n_sets,
                                     64)
    assert tsim._engine_plan(geom, 64, True, smem_budget=0) == \
        tsim.EnginePlan("touch", 0, False, 0, 0)


def test_segments_are_padded_to_16_bytes():
    """Each of the four staged arrays starts on a 16-byte boundary (the
    kernel's cp.async copies): a geometry whose L2 holds 3 x 5 x 3 ints."""
    geom = tsim.MachineGeometry(
        n_domains=1, cores_per_domain=3,
        l2=tsim.CacheGeometry(n_sets=5, n_ways=3),
        llc=tsim.CacheGeometry(n_sets=7, n_ways=5, n_slices=1))
    plan = tsim._engine_plan(geom, 16, False)
    assert plan.design == "shared"
    assert plan.shared_bytes == 8 * (48 + 36)     # 45 -> 48, 35 -> 36
