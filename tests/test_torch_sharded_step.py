"""The sharded step on four gloo ranks against the JAX package on the CPU:
`jit_train_step` (1 microbatch; 2 with ``sequence_parallel``),
`jit_prefill` and `jit_decode_step` of `repro_torch.train.train_step` as
DTensor programs on a ``(2, 2)`` ("data", "model") mesh, on reduced
qwen1.5-0.5b (dense), qwen2-moe-a2.7b (both dispatches) and zamba2-2.7b
(hybrid), from the JAX initializers' weights (`tests/torch_goldens.py`'s
`sharded_inputs`).

The four ranks are spawned once for every case (`tests/_torch_gloo.py`,
which imports no JAX); the parent computes the JAX references while they
run.  Two references:
  (a) JAX without a mesh: ``jax.value_and_grad(lm.loss_fn)`` per
      microbatch (JAX's rows ``[i * B // nm, (i + 1) * B // nm)``), the
      mean, ``adamw.apply_updates``; ``lm.prefill``; ``lm.decode_step``;
  (b) JAX's own sharded step on the same mesh with ``Auto`` axes, kept as
      the ``sharded_steps`` golden (losses, grad norms, prefill logits'
      absolute sums).
Every reduced config has fewer kv heads than ``TP_DEGREE``, so its kv
projections and caches are replicated over "model" while the 16 padded
query heads split 8 a rank: each case runs the GQA slicing of
`models.attention._attend_on_blocks` (rank r's head i meets kv head
``(8r + i) // group``).

Tolerances (f32 compute on both sides, sums in other orders): metrics rel
1e-5; parameters, moments, logits and caches 1e-5 (absolute, plus rel
1e-5); the golden's losses, grad norms and logits sums rel 1e-5.
"""

import functools
import json
import math
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import Shard

from repro.models import lm as jlm
from repro.optim import adamw as jadamw
from repro_torch.checkpoint import ckpt as tckpt
from repro_torch.configs import base as tbase
from repro_torch.data import pipeline as tdata
from repro_torch.launch import mesh as tmesh
from repro_torch.models import attention as tattn
from repro_torch.train import train_step as tts
from repro_torch.train.trainer import Trainer, TrainerConfig
from tests import _torch_gloo
from tests.torch_goldens import (DATA, SHARDED_CASES, SHARDED_DECODE_STEPS,
                                 SHARDED_MICRO, SHARDED_SHAPE, SHARDED_STEPS,
                                 SHARDED_VARIANTS, path_of, sharded_inputs,
                                 sharded_rows, sharded_variant_config)

ARCHS = tuple(sorted({arch for arch, _ in SHARDED_CASES}))
VARIANTS = SHARDED_VARIANTS
VARIANT_TRAIN = [(a, v) for a, v, what in VARIANTS if what == "train"]
VARIANT_SERVE = [c for c in VARIANTS if c[2] != "train"]
DECODE_STEPS = SHARDED_DECODE_STEPS
TRAIN = [(arch, mi, nm, sp) for arch, mi in SHARDED_CASES
         for nm, sp in SHARDED_STEPS]
METRIC_TOL = dict(rel=1e-5, abs=1e-8)
TENSOR_TOL = dict(rtol=1e-5, atol=1e-5)
RANK_TIMEOUT = 400
# the arch whose train steps run under `roofline.count_collectives`
COUNTED = "qwen1p5_0p5b"


def _name(arch, mi, nm, sp):
    return f"{arch}_{mi}_nm{nm}_sp{int(sp)}"


def _remat(variant):
    return "dots" if variant == "dots_remat" else "none"


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _flat(tree, prefix=""):
    """{path: numpy} with `sharding.path_str`'s paths."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {prefix + "/".join(str(getattr(k, "key", getattr(k, "name", k)))
                              for k in path): np.asarray(v)
            for path, v in flat}


# AdamW with its defaults, jitted once (the reduced trees share shapes)
_APPLY = jax.jit(functools.partial(jadamw.apply_updates,
                                   jadamw.AdamWConfig()))


@functools.lru_cache(maxsize=None)
def _jax_value_and_grad(cfg, moe_impl, remat="none"):
    """`lm.loss_fn`'s value and gradient, jitted once a config, dispatch
    and remat (both steps' microbatches share one shape)."""
    return jax.jit(jax.value_and_grad(
        lambda p, b: jlm.loss_fn(cfg, p, b, jnp.float32, remat=remat,
                                 moe_impl=moe_impl), has_aux=True))


def _jax_step(cfg, state, batch, nm, moe_impl, remat="none"):
    """Reference (a) of a train step: the JAX step's computation without a
    mesh (each function jitted whole, for speed).  Returns (metrics, new
    params, new AdamW state)."""
    vg = _jax_value_and_grad(cfg, moe_impl, remat)
    B = batch["tokens"].shape[0]
    grads, ms = None, []
    for i in range(nm):
        mb = {k: v[i * B // nm:(i + 1) * B // nm] for k, v in batch.items()}
        (_, m), g = vg(state.params, mb)
        ms.append({k: float(v) for k, v in m.items()})
        grads = g if grads is None else jax.tree_util.tree_map(jnp.add,
                                                               grads, g)
    grads = jax.tree_util.tree_map(lambda g: g / nm, grads)
    params, opt, om = _APPLY(state.params, grads, state.opt)
    metrics = {k: float(np.mean([m[k] for m in ms])) for k in ms[0]}
    metrics.update({k: float(v) for k, v in om.items()})
    return metrics, params, opt


def _jax_serve(cfg, params, batch):
    """Reference (a) of the serving steps: prefill logits, the decode
    logits and caches after `DECODE_STEPS` tokens with "dus" cache writes,
    and the same with "blend" writes."""
    seq, b = SHARDED_SHAPE
    tokens = batch["tokens"]
    prefill = np.asarray(jax.jit(
        lambda p, t: jlm.prefill(cfg, p, {"tokens": t}, seq, jnp.float32,
                                 "ref"))(params, tokens))
    decoded = []
    for update in ("dus", "blend"):
        caches = jlm.init_caches(cfg, b, seq, jnp.float32)
        decode = jax.jit(lambda p, c, t, pos: jlm.decode_step(
            cfg, p, c, t, pos, jnp.float32, cache_update=update))
        logits = []
        for pos in range(DECODE_STEPS):
            lg, caches = decode(params, caches, tokens[:, pos:pos + 1],
                                jnp.int32(pos))
            logits.append(np.asarray(lg))
        decoded += [logits, _flat(caches)]
    return (prefill,) + tuple(decoded)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(rank results, JAX references): the ranks start first, then run
    every job while the parent computes the references, the JAX functions
    compiled in threads side by side (XLA compiles without the
    interpreter lock)."""
    store = tmp_path_factory.mktemp("sharded") / "store"
    ranks = _torch_gloo.Ranks(_torch_gloo.sharded_step_worker, str(store),
                              inbox=True)
    try:
        return _run_and_reference(ranks)
    finally:
        ranks.collect(0)      # a no-op once collected; else ends the ranks


def _run_and_reference(ranks):
    """The body of `runs`: the jobs sent to the started ``ranks``, the
    references computed, the ranks' results collected."""
    with ThreadPoolExecutor(len(ARCHS)) as pool:
        inputs = dict(zip(ARCHS, pool.map(sharded_inputs, ARCHS)))
    jobs = []
    for arch, mi, nm, sp in TRAIN:
        _, state, batch = inputs[arch]
        st = _np(state)
        jobs.append(dict(kind="train", name=_name(arch, mi, nm, sp),
                         arch=arch, moe_impl=mi, nm=nm, sp=sp,
                         shape=(SHARDED_SHAPE[0], nm * SHARDED_MICRO),
                         params=st.params, step=st.opt.step, mu=st.opt.mu,
                         nu=st.opt.nu, batch=sharded_rows(batch, nm),
                         count=arch == COUNTED))
    for arch in ARCHS:
        _, state, batch = inputs[arch]
        jobs.append(dict(kind="serve", name=f"{arch}_serve", arch=arch,
                         shape=SHARDED_SHAPE, params=_np(state.params),
                         batch=batch,
                         decode=[batch["tokens"][:, i:i + 1]
                                 for i in range(DECODE_STEPS)]))
    _, _, batch = inputs[COUNTED]
    jobs.append(dict(kind="compress", name="compress", arch=COUNTED, nm=2,
                     shape=SHARDED_SHAPE, batch=batch))
    with ThreadPoolExecutor(len(SHARDED_VARIANTS)) as pool:
        vinputs = dict(zip(VARIANTS, pool.map(
            lambda c: sharded_inputs(c[0], c[1]), VARIANTS)))
    for arch, variant, what in SHARDED_VARIANTS:
        _, state, batch = vinputs[(arch, variant, what)]
        name = f"{arch}_{variant}"
        if what == "train":
            st = _np(state)
            jobs.append(dict(kind="train", name=name, arch=arch,
                             variant=variant, moe_impl="gshard", nm=1,
                             sp=False, remat=_remat(variant),
                             shape=(SHARDED_SHAPE[0], SHARDED_MICRO),
                             params=st.params, step=st.opt.step,
                             mu=st.opt.mu, nu=st.opt.nu,
                             batch=sharded_rows(batch, 1)))
        else:
            jobs.append(dict(kind="serve", name=name, arch=arch,
                             variant=variant, shape=SHARDED_SHAPE,
                             params=_np(state.params), batch=batch,
                             decode=[batch["tokens"][:, i:i + 1]
                                     for i in range(DECODE_STEPS)],
                             impls=("ref",) if what == "serve" else (),
                             updates=("dus",),
                             replparams=variant == "replparams"))
    ranks.send(jobs)

    def case(arch, mi):
        """Both steps of a case, one after the other (one compiled JAX
        function)."""
        cfg, state, batch = inputs[arch]
        return {_name(arch, mi, nm, sp): _jax_step(
            cfg, state, sharded_rows(batch, nm), nm, mi)
            for nm, sp in SHARDED_STEPS}

    def variant(arch, name, what):
        """A `SHARDED_VARIANTS` case's reference (a): the train step, or
        the serving steps (for "replparams" the same function as the
        case without it)."""
        cfg, state, batch = vinputs[(arch, name, what)]
        if what == "train":
            return _jax_step(cfg, state, sharded_rows(batch, 1), 1, "gshard",
                             _remat(name))
        return _jax_serve(cfg, state.params, batch)

    with ThreadPoolExecutor(len(SHARDED_CASES) + len(ARCHS)
                            + len(VARIANTS)) as pool:
        futures = [pool.submit(case, arch, mi)
                   for arch, mi in SHARDED_CASES]
        serve = {arch: pool.submit(_jax_serve, inputs[arch][0],
                                   inputs[arch][1].params, inputs[arch][2])
                 for arch in ARCHS}
        vrefs = {f"{a}_{v}": pool.submit(variant, a, v, w)
                 for a, v, w in VARIANTS}
        refs = {k: v for f in futures for k, v in f.result().items()}
        refs.update({f"{arch}_serve": f.result()
                     for arch, f in serve.items()})
        refs.update({k: f.result() for k, f in vrefs.items()})
    got = ranks.collect(RANK_TIMEOUT)
    return got, refs


def _results(runs):
    got, refs = runs
    assert sorted(got) == [0, 1, 2, 3], got
    for rank, res in got.items():
        assert isinstance(res, dict), f"rank {rank}:\n{res}"
    return got, refs


@pytest.fixture(scope="module")
def golden():
    return json.loads(path_of("sharded_steps", DATA).read_text())


@pytest.mark.parametrize("arch,mi,nm,sp", TRAIN)
def test_train_step_on_four_ranks_equals_jax(runs, arch, mi, nm, sp):
    """Every rank's metrics equal JAX's without a mesh (a); rank 0's
    gathered state holds JAX's parameters and moments; every output leaf
    on every rank is a DTensor with `state_shardings`' placements."""
    got, refs = _results(runs)
    name = _name(arch, mi, nm, sp)
    want_m, want_p, want_opt = refs[name]
    for rank in range(4):
        res = got[rank][name]
        assert res["misplaced"] == [], (rank, res["misplaced"])
        assert set(res["metrics"]) == set(want_m)
        for k, v in want_m.items():
            assert res["metrics"][k] == pytest.approx(v, **METRIC_TOL), \
                (rank, k)
    state = got[0][name]["state"]
    want = {**_flat(want_p, ".params/"), **_flat(want_opt.mu, ".opt/.mu/"),
            **_flat(want_opt.nu, ".opt/.nu/")}
    assert sorted(state) == sorted(list(want) + [".opt/.step"])
    assert int(state[".opt/.step"]) == int(want_opt.step)
    for k, v in want.items():
        np.testing.assert_allclose(state[k], v, err_msg=k, **TENSOR_TOL)


@pytest.mark.parametrize("arch,mi,nm,sp", TRAIN)
def test_train_step_on_four_ranks_equals_jax_sharded_golden(runs, golden,
                                                            arch, mi, nm,
                                                            sp):
    """Reference (b): the loss and grad norm of JAX's ``jit_train_step`` on
    the same (2, 2) mesh, from `tests/torch_goldens.py`."""
    got, _ = _results(runs)
    want = golden[f"{arch}_{mi}"][f"nm{nm}_sp{int(sp)}"]
    m = got[0][_name(arch, mi, nm, sp)]["metrics"]
    assert m["loss"] == pytest.approx(want["loss"], rel=1e-5)
    assert m["grad_norm"] == pytest.approx(want["grad_norm"], rel=1e-5)


def test_compression_and_cast_once_run_on_placed_gradients(runs):
    """``compress_cross_pod`` and ``cast_params_once`` on the (2, 2) mesh:
    the gradients reach the int8 error-feedback compression and AdamW as
    DTensors placed like their parameters, and the step equals the port's
    step without a mesh (metrics rel 1e-5, parameters 1e-5).  The
    moments and the error buffers are compared only for their placements:
    where the two gradient sums differ in their last bit, a rounding to
    int8 may flip by one step, which moves the moment and the buffer of
    that element by a step of the int8 grid (and the parameter by at
    most twice the learning rate, within 1e-5)."""
    got, _ = _results(runs)
    for rank in range(4):
        res = got[rank]["compress"]
        assert res["misplaced"] == [], (rank, res["misplaced"])
        for k, v in res["unsharded"].items():
            assert res["metrics"][k] == pytest.approx(v, **METRIC_TOL), k
    res = got[0]["compress"]
    assert sorted(res["state"]) == sorted(res["unsharded_state"])
    assert any(k.startswith(".ef/") for k in res["state"])
    for k, v in res["unsharded_state"].items():
        if k.startswith(".params/"):
            np.testing.assert_allclose(res["state"][k], v, err_msg=k,
                                       **TENSOR_TOL)


def _layers(arch):
    """(attention calls, SSD scans) of one forward of the reduced arch."""
    cfg = tbase.reduced_config(tbase.get_config(arch))
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.hybrid_every, cfg.n_layers
    if cfg.family == "ssm":
        return 0, cfg.n_layers
    return cfg.n_layers, 0


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_on_four_ranks_equals_jax(runs, golden, arch):
    """`jit_prefill` with ``impl`` "ref" and "kernel" gives JAX's logits
    (a) and the golden's sums (b); with "kernel" each rank hands its block
    to the kernels' wrappers (their plain versions on the CPU), once per
    attention and once per SSD layer."""
    got, refs = _results(runs)
    want = refs[f"{arch}_serve"][0]
    res = got[0][f"{arch}_serve"]["prefill"]
    n_attn, n_ssd = _layers(arch)
    for impl in ("ref", "kernel"):
        assert res[impl]["type"] == "DTensor"
        np.testing.assert_allclose(res[impl]["logits"], want, err_msg=impl,
                                   **TENSOR_TOL)
    assert res["ref"]["plain_calls"] == {"flash_attention": 0,
                                         "ssd_scan": 0}
    assert res["kernel"]["plain_calls"] == {"flash_attention": n_attn,
                                            "ssd_scan": n_ssd}
    g = golden[f"{arch}_gshard"]["prefill"]
    assert float(np.abs(res["ref"]["logits"]).sum()) == pytest.approx(
        g["logits_abs_sum"], rel=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_on_four_ranks_equal_jax(runs, arch):
    """`DECODE_STEPS` `jit_decode_step` calls ("dus" cache writes on caches
    sharded along their sequence over "model") give JAX's logits and
    caches; the caches keep `cache_shardings`' placements on every
    rank."""
    got, refs = _results(runs)
    _, want_logits, want_caches, _, _ = refs[f"{arch}_serve"]
    _check_decode(got, arch, "", want_logits, want_caches)


def _check_decode(got, arch, key, want_logits, want_caches,
                  job="serve"):
    """Rank 0's decode logits and gathered caches of the ``key`` run
    ("" for "dus", "_blend") of job ``{arch}_{job}`` against JAX's; every
    rank's caches placed by `cache_shardings`."""
    res = got[0][f"{arch}_{job}"]
    assert len(res["decode" + key]) == len(want_logits) == DECODE_STEPS
    for i, (g, w) in enumerate(zip(res["decode" + key], want_logits)):
        np.testing.assert_allclose(g, w, err_msg=f"token {i}", **TENSOR_TOL)
    assert sorted(res["caches" + key]) == sorted(want_caches)
    for k, v in want_caches.items():
        np.testing.assert_allclose(res["caches" + key][k], v, err_msg=k,
                                   **TENSOR_TOL)
    for rank in range(4):
        assert got[rank][f"{arch}_{job}"]["cache_misplaced" + key] == []


@pytest.mark.parametrize("arch", ARCHS)
def test_blend_decode_steps_on_four_ranks_equal_jax(runs, golden, arch):
    """The same `DECODE_STEPS` with ``cache_update="blend"`` (the one-hot
    masked write, each rank masking its own block of positions by global
    position): JAX's ``decode_step(..., cache_update="blend")`` without a
    mesh (a), and the logits' sums of JAX's own ``jit_decode_step(...,
    cache_update="blend")`` on the same (2, 2) mesh, from the golden
    (b): absolute sums rel 1e-5, sums (of 2,048 logits of either sign)
    within 1e-3."""
    got, refs = _results(runs)
    _, _, _, want_logits, want_caches = refs[f"{arch}_serve"]
    _check_decode(got, arch, "_blend", want_logits, want_caches)
    g = golden[f"{arch}_gshard"]["decode_blend"]
    logits = got[0][f"{arch}_serve"]["decode_blend"]
    assert len(logits) == len(g["logits_sums"]) == DECODE_STEPS
    for lg, s, a in zip(logits, g["logits_sums"], g["logits_abs_sums"]):
        assert float(np.abs(lg).sum()) == pytest.approx(a, rel=1e-5)
        assert float(lg.sum()) == pytest.approx(s, rel=1e-5, abs=1e-3)


@pytest.fixture(scope="module")
def variants_golden():
    return json.loads(path_of("sharded_variants", DATA).read_text())


@pytest.mark.parametrize("arch,variant", VARIANT_TRAIN)
def test_variant_train_step_on_four_ranks_equals_jax(runs, variants_golden,
                                                     arch, variant):
    """The hillclimb variants that change the train step on the (2, 2)
    mesh, 1 microbatch: "dots_remat" (remat "dots" under the mesh rules,
    `sharding.bind_mesh_rules`) and "moegroup" (the MoE routed in groups
    of `SHARDED_GROUP` tokens, so `moe_block`'s group reshape runs on
    DTensors).  Every rank's metrics equal JAX's without a mesh (a),
    rank 0's gathered state holds JAX's parameters and moments, every
    output leaf is placed by `state_shardings`, and the loss and grad
    norm equal JAX's own sharded step on the same mesh (b)."""
    got, refs = _results(runs)
    name = f"{arch}_{variant}"
    want_m, want_p, want_opt = refs[name]
    for rank in range(4):
        res = got[rank][name]
        assert res["misplaced"] == [], (rank, res["misplaced"])
        assert set(res["metrics"]) == set(want_m)
        for k, v in want_m.items():
            assert res["metrics"][k] == pytest.approx(v, **METRIC_TOL), \
                (rank, k)
    state = got[0][name]["state"]
    want = {**_flat(want_p, ".params/"), **_flat(want_opt.mu, ".opt/.mu/"),
            **_flat(want_opt.nu, ".opt/.nu/")}
    assert sorted(state) == sorted(list(want) + [".opt/.step"])
    for k, v in want.items():
        np.testing.assert_allclose(state[k], v, err_msg=k, **TENSOR_TOL)
    g = variants_golden[name]["train"]
    m = got[0][name]["metrics"]
    assert m["loss"] == pytest.approx(g["loss"], rel=1e-5)
    assert m["grad_norm"] == pytest.approx(g["grad_norm"], rel=1e-5)


@pytest.mark.parametrize("arch,variant,what", VARIANT_SERVE)
def test_variant_serving_on_four_ranks_equals_jax(runs, variants_golden,
                                                  arch, variant, what):
    """The hillclimb variants that change the serving steps' placements
    on the (2, 2) mesh: "replparams" (`jit_prefill` and `DECODE_STEPS`
    "dus" `jit_decode_step`s with the parameters replicated over "data":
    no parameter split there, where the same steps without it split
    some) and "kvrep" (the decode steps on 16 kv heads replicated over
    "model", ``force_kv_replicate``: no cache split by its kv heads).
    Logits and caches equal JAX's without a mesh (a); the logits' sums
    equal JAX's own sharded steps' (b), absolute sums rel 1e-5, sums
    within 1e-3."""
    got, refs = _results(runs)
    name = f"{arch}_{variant}"
    want = refs[name]
    res = got[0][name]
    g = variants_golden[name]
    if what == "serve":
        np.testing.assert_allclose(res["prefill"]["ref"]["logits"], want[0],
                                   **TENSOR_TOL)
        assert float(np.abs(res["prefill"]["ref"]["logits"]).sum()) == \
            pytest.approx(g["prefill"]["logits_abs_sum"], rel=1e-5)
    _check_decode(got, arch, "", want[1], want[2], job=variant)
    for lg, s_, a in zip(res["decode"], g["decode"]["logits_sums"],
                         g["decode"]["logits_abs_sums"]):
        assert float(np.abs(lg).sum()) == pytest.approx(a, rel=1e-5)
        assert float(lg.sum()) == pytest.approx(s_, rel=1e-5, abs=1e-3)
    if variant == "replparams":
        assert got[0][f"{arch}_serve"]["data_split_params"]
        for rank in range(4):
            assert got[rank][name]["data_split_params"] == []
    if variant == "kvrep":
        cfg = sharded_variant_config(
            tbase.reduced_config(tbase.get_config(arch)), variant)
        assert cfg.n_kv_heads == tbase.TP_DEGREE and not cfg.kv_sharded
        for path, pl in res["cache_placements"].items():
            assert Shard(3) not in pl, (path, pl)


@pytest.mark.parametrize("arch", ARCHS)
def test_every_case_runs_query_heads_against_replicated_kv(arch):
    """The cases' kv heads are too few for the "model" dim (their
    projections and caches replicate) while their query heads split over
    it, so every attention above ran `_attend_on_blocks`' GQA slicing
    with a kv group wider than one head."""
    cfg = tbase.reduced_config(tbase.get_config(arch))
    assert not cfg.kv_sharded
    assert cfg.sharding_overrides["kv_qkv"] is None
    acfg = tattn.AttnConfig(cfg.d_model, cfg.n_heads_padded,
                            cfg.n_kv_heads_eff, cfg.head_dim)
    assert acfg.n_heads // acfg.n_kv_heads > 1
    assert acfg.n_heads % 2 == 0


def _axis(ranks):
    """The mesh dim of a collective's group on the (2, 2) mesh, seen from
    rank 0: ranks (0, 2) differ in "data", (0, 1) in "model"."""
    return {(0, 2): "data", (0, 1): "model"}[ranks]


# The counts `test_count_collectives_of_the_train_step_on_four_ranks`
# pins, rank 0's: {(kind, mesh dim): collectives}, and bytes by kind.  The
# loss's log-sum-exp over the vocab-parallel logits gathers one entry a
# rank (`lm._logsumexp_vocab`), where DTensor's own rule gathered the
# logits' vocab blocks (32,640 all-gather bytes more a microbatch).  Under
# sequence parallelism each layer gathers the normed residual's sequence
# before its two tensor-parallel regions and reduce-scatters their
# outputs, and the final norm's output is gathered before the unembedding
# (`lm._whole_seq`, `lm._like_residual`), where DTensor's own rules moved
# more (62 / 38 model-dim all-gathers / reduce-scatters).  The residual
# is reduced before the final norm (`lm._resid`): left a pending sum there,
# the unembedding gathered its vocab-split weight to meet it (1 model-dim
# all-gather, 6 all-reduces and 1 reduce-scatter more without sequence
# parallelism).
COUNT_SNAPSHOT = {
    "nm1_sp0": ({("all-gather", "data"): 9, ("all-gather", "model"): 5,
                 ("all-reduce", "data"): 9, ("all-reduce", "model"): 20,
                 ("reduce-scatter", "data"): 9,
                 ("reduce-scatter", "model"): 2},
                {"all-gather": 1699968, "all-reduce": 123988,
                 "reduce-scatter": 1236992}),
    "nm2_sp1": ({("all-gather", "data"): 18, ("all-gather", "model"): 22,
                 ("all-reduce", "data"): 15, ("all-reduce", "model"): 20,
                 ("reduce-scatter", "data"): 18,
                 ("reduce-scatter", "model"): 18},
                {"all-gather": 3342592, "all-reduce": 100504,
                 "reduce-scatter": 1662976}),
}


@pytest.mark.parametrize("nm,sp", SHARDED_STEPS)
def test_count_collectives_of_the_train_step_on_four_ranks(runs, nm, sp):
    """`roofline.count_collectives` of reduced qwen1.5-0.5b's
    `jit_train_step` on the (2, 2) mesh, on the same ranks.  What the
    placements force, microbatch by microbatch (``nm`` of them, of
    ``B_l`` = 1 row a data rank):

      * every parameter sharded over "data" (FSDP: its "embed" dim) is
        gathered over "data" once before the forward (`_fsdp_gathered`),
        and its gradient reduce-scattered back onto its shard once: 9
        such leaves (the token table, the unembedding, wq/wk/wv/wo and
        the three MLP matrices), so ``9 * nm`` all-gathers and ``9 *
        nm`` reduce-scatters over "data", each of a parameter's block;
      * every other collective over "data" is an all-reduce of a
        gradient replicated over "data" (norms, biases) or of a metric:
        none moves a row of the batch, and none has an integer operand
        (the tokens and targets never move);
      * without ``sequence_parallel`` the residual stream (``B_l x S x
        D``) is whole on each "model" rank, and the "model"-parallel
        matmuls' partial sums are all-reduced over "model" at that size;
      * ``sequence_parallel`` shards the residual's sequence over
        "model" between the tensor-parallel regions: those all-reduces
        become reduce-scatters onto ``B_l x S/2 x D`` blocks and
        all-gathers back to ``B_l x S x D`` (Megatron-SP); the one
        residual-shaped all-reduce left a microbatch is the token
        embedding's vocab-parallel sum (`layers._embed_on_blocks`).  (The
        kv projections' gradients, ``B_l x S x Hkv x dh`` with the kv
        heads replicated over "model", are as many elements as the
        residual and are all-reduced too.)
    The counts by kind and mesh dim, and the bytes by kind, are pinned as
    a snapshot (rank 0's; DTensor picks them, so a torch upgrade may move
    them)."""
    got, _ = _results(runs)
    res = got[0][_name(COUNTED, "gshard", nm, sp)]
    stats = res["stats"]
    seq, b_l, d = SHARDED_SHAPE[0], SHARDED_MICRO // 2, 128
    fsdp = [p for p, (_, pl) in res["params"].items()
            if pl[0].is_shard()]
    assert len(fsdp) == 9, fsdp
    by = {}
    for kind, ranks, nbytes, shape, dtype in stats.calls:
        assert dtype.is_floating_point, (kind, shape, dtype)
        by[(kind, _axis(ranks))] = by.get((kind, _axis(ranks)), 0) + 1
    assert by[("all-gather", "data")] == 9 * nm
    assert by[("reduce-scatter", "data")] == 9 * nm
    assert not any(k == "all-to-all" for k, _ in by)
    blocks = {math.prod(shape) for shape, pl in res["params"].values()}
    for kind, ranks, nbytes, shape, dtype in stats.calls:
        if _axis(ranks) == "data":
            n = nbytes // 4
            assert n <= 2 or any(n * k in blocks for k in (1, 2, 4)), \
                (kind, shape)
    resid = [(k, nbytes // 4) for k, r, nbytes, _, _ in stats.calls
             if _axis(r) == "model"]
    summed = sum(1 for k, r, _, shape, _ in stats.calls
                 if _axis(r) == "model" and k == "all-reduce"
                 and shape == (b_l, seq, d))
    if sp:
        assert ("reduce-scatter", b_l * seq // 2 * d) in resid
        assert ("all-gather", b_l * seq * d) in resid
        assert summed == nm       # the embedding's, once a microbatch
    else:
        assert summed > 4 * nm
        assert ("reduce-scatter", b_l * seq // 2 * d) not in resid
    ops, nbytes = COUNT_SNAPSHOT[f"nm{nm}_sp{int(sp)}"]
    assert by == ops
    assert {k: v for k, v in stats.by_kind.items() if v} == nbytes
    assert stats.total_bytes == stats.tpu_corrected_bytes == sum(
        nbytes.values())
    assert stats.ops == sum(ops.values())
    assert stats.by_group_size == {2: stats.total_bytes}


# -- on a gloo world of one rank (the card's 1 x 1 mesh, in process) ---------

@pytest.fixture
def gloo_world_of_one(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    yield tmesh.make_host_mesh()
    dist.destroy_process_group()


def _trainer(tmp, mesh=None):
    cfg = tbase.reduced_config(tbase.get_config("qwen1p5_0p5b"))
    hyper = tts.TrainHyper(microbatches=2, remat="none",
                           compute_dtype=torch.float32)
    return Trainer(cfg, tbase.ShapeSpec("smoke", 16, 4, "train"), hyper,
                   TrainerConfig(ckpt_dir=str(tmp), ckpt_every=2,
                                 data=tdata.DataConfig(seed=7)),
                   device="cpu", mesh=mesh)


def test_trainer_on_a_mesh_equals_the_trainer_without(gloo_world_of_one,
                                                      tmp_path):
    """The trainer on a 1 x 1 mesh: the sharded step's losses equal the
    unsharded trainer's bit for bit; its checkpoint (gathered, written by
    rank 0) restores through `restore_on_mesh` and resumes identically;
    the mitigator counts the mesh's data ways."""
    want = _trainer(tmp_path / "plain").run(n_steps=4)
    tr = _trainer(tmp_path / "mesh", gloo_world_of_one)
    assert (tr.mitigator.n_devices, tr.mitigator.total) == \
        (1, 2)
    first = tr.run(n_steps=2)
    assert tckpt.list_steps(str(tmp_path / "mesh")) == [2]
    resumed = _trainer(tmp_path / "mesh", gloo_world_of_one).run(n_steps=4)
    assert [r["step"] for r in first + resumed] == [1, 2, 3, 4]
    for got, ref in zip(first + resumed, want):
        assert got["loss"] == ref["loss"], got["step"]
        assert got["grad_norm"] == ref["grad_norm"], got["step"]


def test_train_cli_takes_the_running_group(gloo_world_of_one, tmp_path):
    """With a process group running the CLI trains on `make_host_mesh()`;
    ``--production-mesh`` raises naming the world size it lacks."""
    from repro_torch.launch import train
    log = train.main(["--reduced", "--device", "cpu", "--steps", "1",
                      "--seq", "16", "--batch", "2", "--microbatches", "1",
                      "--ckpt", str(tmp_path / "a")])
    assert [r["step"] for r in log] == [1]
    with pytest.raises(RuntimeError, match="256 ranks.*world size 1"):
        train.main(["--reduced", "--device", "cpu", "--steps", "1",
                    "--production-mesh", "--ckpt", str(tmp_path / "b")])


def test_train_cli_production_mesh_needs_a_process_group(tmp_path):
    from repro_torch.launch import train
    with pytest.raises(RuntimeError, match="no process group"):
        train.main(["--reduced", "--device", "cpu", "--steps", "1",
                    "--production-mesh", "--ckpt", str(tmp_path)])


def test_kernel_wrappers_refuse_a_dtensor(gloo_world_of_one):
    """A DTensor reaching a kernel's wrapper raises (the model hands the
    kernels each rank's block through `local_map`), where its CPU device
    would otherwise pick the plain version."""
    from torch.distributed.tensor import Replicate, distribute_tensor
    from repro_torch.kernels.flash_attention.kernel import \
        flash_attention_bhsd
    from repro_torch.kernels.ssd_scan.kernel import ssd_scan_grid

    def dt(*shape):
        return distribute_tensor(torch.zeros(shape), gloo_world_of_one,
                                 [Replicate(), Replicate()])
    with pytest.raises(TypeError, match="DTensor"):
        flash_attention_bhsd(dt(1, 2, 4, 8), dt(1, 2, 4, 8), dt(1, 2, 4, 8))
    with pytest.raises(TypeError, match="DTensor"):
        ssd_scan_grid(dt(1, 2, 1, 4, 8), dt(1, 2, 1, 4), dt(1, 2, 1, 4),
                      dt(1, 1, 4, 16), dt(1, 1, 4, 16))
