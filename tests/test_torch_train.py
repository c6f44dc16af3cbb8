"""The port's training path against the JAX package on the CPU: data
batches, `lm.loss_fn` and its gradients, AdamW, gradient compression, the
train step, checkpoints and the trainer, on reduced qwen1.5-0.5b (dense)
and zamba2-2.7b (hybrid).  Weights and states come from the JAX
initializers and cross with `params_from_numpy` / `train_state_from_numpy`;
other inputs are numpy from a seed.

The JAX train step and trainer do not run under the installed JAX (the
mesh's sharding constraints fail: tests/test_train_integration.py), so the
reference of a step is the same computation without the mesh:
``jax.value_and_grad(lm.loss_fn)`` per microbatch, the mean, then
``adamw.apply_updates``.

Tolerances (f32 compute on both sides; the two differ only in the order
of their sums):
  * loss: rtol 1e-5;
  * every gradient leaf, and the moments built from gradients: atol 1e-5
    + rtol 1e-4 (the gradients of these small models are up to about 1;
    their sums run in another order);
  * AdamW from equal inputs: rtol 1e-6 and atol 1e-9 on params, mu and
    nu (elementwise f32 arithmetic; the two frameworks may round a
    multiply-add once or twice, and where the two terms of a moment
    update nearly cancel, one ulp of a term, about 1e-8 at 0.1, is a large
    share of the small result: 6e-11 was seen);
  * bf16 compute: the loss within 2e-2 (both round every matmul input to
    8 significant bits, at other places);
  * data, gradient compression and checkpoints: exact.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as jckpt
from repro.configs.base import ShapeSpec as JShapeSpec
from repro.configs.base import get_config as jget_config
from repro.configs.base import reduced_config as jreduced_config
from repro.data import pipeline as jdata
from repro.models import lm as jlm
from repro.optim import adamw as jadamw
from repro.optim import grad_compress as jgc
from repro.train import train_step as jts
from repro_torch import _build
from repro_torch._tree import tree_flatten_with_path, tree_leaves, tree_map
from repro_torch.checkpoint import ckpt
from repro_torch.configs.base import (ARCH_IDS, ShapeSpec, get_config,
                                      reduced_config)
from repro_torch.data import pipeline as data
from repro_torch.distributed.rebalance import StragglerMitigator
from repro_torch.models import attention, lm, mamba2
from repro_torch.optim import adamw, grad_compress
from repro_torch.tpuprobe.monitor import PodMonitor, SimClock
from repro_torch.train import train_step as ts
from repro_torch.train.trainer import Trainer, TrainerConfig

LOSS_RTOL = 1e-5
GRAD_TOL = dict(atol=1e-5, rtol=1e-4)
ADAM_TOL = dict(rtol=1e-6, atol=1e-9)
BF16_LOSS_ATOL = 2e-2
ARCHS = ["qwen1p5_0p5b", "zamba2_2p7b"]
SMOKE = (32, 8)                        # (seq, global batch)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's side on one thread: the reduced steps are host-bound,
    and under a parallel run torch's default thread count (one a core)
    in every worker oversubscribes the cores many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfgs(arch):
    return jreduced_config(jget_config(arch)), reduced_config(get_config(arch))


def _jax_params(cfg, seed=0):
    return jlm.init_params(cfg, jax.random.PRNGKey(seed))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_flat(tree):
    """{path tuple: numpy} with the port's path parts (dict keys)."""
    return {tuple(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _torch_flat(tree):
    return {path: v.detach().float().numpy()
            for path, v in tree_flatten_with_path(tree)}


def _assert_trees_close(got, want, **tol):
    g, w = _torch_flat(got), _jax_flat(want)
    assert sorted(g) == sorted(w)
    for k in g:
        np.testing.assert_allclose(g[k], w[k], err_msg=str(k), **tol)


def _batch(cfg, seq=SMOKE[0], batch=SMOKE[1], seed=1, step=0):
    return jdata.make_batch(jdata.DataConfig(seed=seed), cfg,
                            JShapeSpec("smoke", seq, batch, "train"), step)


def _grads(tcfg, params, batch, dtype=torch.float32, remat="none"):
    p = tree_map(lambda t: t.detach().requires_grad_(), params)
    loss, metrics = lm.loss_fn(tcfg, p, batch, dtype, remat=remat)
    leaves = tree_leaves(p)
    grads = torch.autograd.grad(loss, leaves)
    return float(loss.detach()), metrics, dict(zip(
        [path for path, _ in tree_flatten_with_path(p)], grads))


# -- data ------------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("seq,batch", [SMOKE, (64, 8)])
def test_batches_equal_jax(arch, seq, batch):
    """make_batch and synth_tokens are numpy functions of (seed, step):
    equal bit for bit for several of each."""
    jcfg, tcfg = _cfgs(arch)
    for seed in (0, 1, 1234):
        for step in (0, 1, 17):
            want = jdata.make_batch(jdata.DataConfig(seed=seed), jcfg,
                                    JShapeSpec("s", seq, batch, "train"), step)
            got = data.make_batch(data.DataConfig(seed=seed), tcfg,
                                  ShapeSpec("s", seq, batch, "train"), step)
            assert sorted(got) == sorted(want)
            for k in want:
                assert got[k].dtype == want[k].dtype
                np.testing.assert_array_equal(got[k], want[k])
            np.testing.assert_array_equal(
                data.synth_tokens(data.DataConfig(seed=seed), step, batch,
                                  seq, tcfg.vocab),
                jdata.synth_tokens(jdata.DataConfig(seed=seed), step, batch,
                                   seq, jcfg.vocab))


def test_data_iterator_and_staging_pool_equal_jax():
    jcfg, tcfg = _cfgs("qwen1p5_0p5b")
    jit_ = jdata.DataIterator(jdata.DataConfig(seed=3), jcfg,
                              JShapeSpec("s", 32, 4, "train"), start_step=2,
                              staging=jdata.ColoredStagingPool(4, 2))
    tit = data.DataIterator(data.DataConfig(seed=3), tcfg,
                            ShapeSpec("s", 32, 4, "train"), start_step=2,
                            staging=data.ColoredStagingPool(4, 2))
    for _ in range(5):
        w, g = next(jit_), next(tit)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k])
    assert tit.step == jit_.step == 7
    assert sorted(tit.staging._backing) == sorted(jit_.staging._backing)


# -- loss and gradients ----------------------------------------------------------------

@pytest.fixture(scope="module", params=ARCHS)
def grad_case(request):
    """JAX weights, a smoke batch, and JAX's f32 loss and gradients."""
    jcfg, tcfg = _cfgs(request.param)
    params = _jax_params(jcfg)
    batch = _batch(jcfg)
    (loss, metrics), grads = jax.value_and_grad(
        lambda p, b: jlm.loss_fn(jcfg, p, b, jnp.float32), has_aux=True)(
            params, batch)
    tparams = lm.params_from_numpy(_np_tree(params), "cpu")
    return tcfg, tparams, batch, float(loss), _jax_flat(grads)


@pytest.mark.parametrize("remat", ["none", "full", "dots"])
def test_loss_and_grads_equal_jax(grad_case, remat):
    tcfg, tparams, batch, want_loss, want_grads = grad_case
    loss, metrics, grads = _grads(tcfg, tparams, batch, remat=remat)
    assert loss == pytest.approx(want_loss, rel=LOSS_RTOL)
    assert float(metrics["loss"].detach()) == loss
    assert sorted(grads) == sorted(want_grads)
    for path, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want_grads[path],
                                   err_msg=str(path), **GRAD_TOL)


def test_remat_settings_give_equal_grads(grad_case):
    """none / full / dots recompute the same forward: the gradients agree
    bit for bit on the CPU.  Deterministic algorithms are on: the
    embedding's scatter-add otherwise sums in a varying order (one ulp
    apart between two runs of the same setting)."""
    tcfg, tparams, batch, _, _ = grad_case
    torch.use_deterministic_algorithms(True)
    try:
        runs = [_grads(tcfg, tparams, batch, remat=r)
                for r in ("none", "full", "dots")]
    finally:
        torch.use_deterministic_algorithms(False)
    for loss, _, grads in runs[1:]:
        assert loss == runs[0][0]
        for path, g in grads.items():
            assert torch.equal(g, runs[0][2][path]), path


def test_bf16_loss_close_to_jax():
    jcfg, tcfg = _cfgs("qwen1p5_0p5b")
    params = _jax_params(jcfg)
    batch = _batch(jcfg)
    want, _ = jlm.loss_fn(jcfg, params, batch, jnp.bfloat16)
    got, _ = lm.loss_fn(tcfg, lm.params_from_numpy(_np_tree(params), "cpu"),
                        batch, torch.bfloat16)
    assert abs(float(got) - float(want)) <= BF16_LOSS_ATOL


def test_loss_masks_the_vocab_pad():
    """A config whose vocab is padded: the pad logits carry no mass, so
    the loss equals the JAX loss (which masks them too)."""
    jcfg, tcfg = _cfgs("qwen1p5_0p5b")
    jcfg = dataclasses.replace(jcfg, vocab=500)
    tcfg = dataclasses.replace(tcfg, vocab=500)
    assert tcfg.vocab_padded > tcfg.vocab
    params = _jax_params(jcfg)
    batch = _batch(jcfg)
    want, _ = jlm.loss_fn(jcfg, params, batch, jnp.float32)
    got, _ = lm.loss_fn(tcfg, lm.params_from_numpy(_np_tree(params), "cpu"),
                        batch, torch.float32)
    assert float(got) == pytest.approx(float(want), rel=LOSS_RTOL)


def test_loss_refuses_an_unknown_moe_dispatch():
    """``moe_impl`` is "gshard" or "sorted" (the same function); any other
    name raises, for every family."""
    for arch in ("qwen1p5_0p5b", "qwen2_moe_a2p7b"):
        _, tcfg = _cfgs(arch)
        params = lm.init_params(tcfg, 0, device="cpu")
        with pytest.raises(ValueError, match="moe_impl"):
            lm.loss_fn(tcfg, params, _batch(tcfg), moe_impl="dense")


# -- the kernels refuse gradients ---------------------------------------------------------

def test_attention_kernel_refuses_inputs_that_require_grad():
    """The kernels have no backward: `impl="kernel"` raises on inputs that
    require grad while grad mode is on; under no_grad it runs, and
    `impl="ref"` differentiates."""
    _, tcfg = _cfgs("qwen1p5_0p5b")
    acfg = lm.attn_config(tcfg)
    gen = torch.Generator().manual_seed(0)
    params = attention.init_attention(gen, acfg)
    x = torch.randn((1, 16, tcfg.d_model), generator=gen, requires_grad=True)
    pos = torch.arange(16)[None]
    with pytest.raises(RuntimeError, match="no backward"):
        attention.attention_train(params, acfg, x, pos, torch.float32,
                                  impl="kernel")
    with torch.no_grad():
        out = attention.attention_train(params, acfg, x, pos, torch.float32,
                                        impl="kernel")
    ref = attention.attention_train(params, acfg, x, pos, torch.float32,
                                    impl="ref")
    torch.testing.assert_close(out, ref.detach(), rtol=1e-5, atol=1e-5)
    ref.sum().backward()
    assert x.grad is not None and torch.isfinite(x.grad).all()


def test_ssd_kernel_refuses_inputs_that_require_grad():
    gen = torch.Generator().manual_seed(1)
    b, S, h, p, n = 1, 64, 2, 8, 4
    x = torch.randn((b, S, h, p), generator=gen, requires_grad=True)
    dt = torch.randn((b, S, h), generator=gen)
    A = -torch.rand(h, generator=gen)
    B = torch.randn((b, S, n), generator=gen)
    C = torch.randn((b, S, n), generator=gen)
    D = torch.randn(h, generator=gen)
    with pytest.raises(RuntimeError, match="no backward"):
        mamba2.ssd_chunked(x, dt, A, B, C, D, 32, impl="kernel")
    with torch.no_grad():
        y, _ = mamba2.ssd_chunked(x, dt, A, B, C, D, 32, impl="kernel")
    y_ref, _ = mamba2.ssd_chunked(x, dt, A, B, C, D, 32, impl="ref")
    torch.testing.assert_close(y, y_ref.detach(), rtol=2e-5, atol=2e-5)
    y_ref.sum().backward()
    assert x.grad is not None and torch.isfinite(x.grad).all()


# -- optimizer and compression --------------------------------------------------------------

def _random_tree(rng, like, scale=1.0):
    return jax.tree_util.tree_map(
        lambda a: (scale * rng.standard_normal(a.shape)).astype(np.float32),
        like)


def test_adamw_three_steps_equal_jax():
    jcfg, _ = _cfgs("qwen1p5_0p5b")
    params = _np_tree(_jax_params(jcfg))
    rng = np.random.default_rng(0)
    cfg = jadamw.AdamWConfig(warmup_steps=2, decay_steps=5)
    tcfg_ = adamw.AdamWConfig(warmup_steps=2, decay_steps=5)
    jp, jst = params, jadamw.init_state(params)
    tp = lm.params_from_numpy(params, "cpu")
    tst = adamw.init_state(tp)
    for i in range(3):
        g = _random_tree(rng, params, scale=0.5 * (i + 1))
        jp, jst, jm = jadamw.apply_updates(cfg, jp, g, jst)
        tp, tst, tm = adamw.apply_updates(tcfg_, tp,
                                          lm.params_from_numpy(g, "cpu"), tst)
        assert int(tst.step) == int(jst.step) == i + 1
        for got, want in ((tp, jp), (tst.mu, jst.mu), (tst.nu, jst.nu)):
            _assert_trees_close(got, want, **ADAM_TOL)
        assert float(tm["grad_norm"]) == pytest.approx(
            float(jm["grad_norm"]), rel=1e-6)
        assert float(tm["lr"]) == pytest.approx(float(jm["lr"]), rel=1e-6)


def test_lr_schedule_and_global_norm_equal_jax():
    cfg = jadamw.AdamWConfig()
    tcfg_ = adamw.AdamWConfig()
    for step in (0, 1, 50, 99, 100, 101, 5000, 9999, 10_000, 20_000):
        want = float(jadamw.lr_at(cfg, jnp.int32(step)))
        got = float(adamw.lr_at(tcfg_, torch.tensor(step, dtype=torch.int32)))
        assert got == pytest.approx(want, rel=1e-6, abs=1e-12), step
    rng = np.random.default_rng(1)
    tree = {"a": rng.standard_normal((7, 5)).astype(np.float32),
            "b": {"c": rng.standard_normal(11).astype(np.float32)}}
    want = float(jadamw.global_norm(tree))
    got = float(adamw.global_norm(lm.params_from_numpy(tree, "cpu")))
    assert got == pytest.approx(want, rel=1e-6)


def test_grad_compression_equals_jax():
    """Round trip and error feedback over three steps: exact (both round
    half to even, and every other operation is one f32 rounding)."""
    rng = np.random.default_rng(2)
    like = {"w": np.zeros((64, 33), np.float32), "b": np.zeros(17, np.float32)}
    jerr = jgc.init_error_state(like)
    terr = grad_compress.init_error_state(lm.params_from_numpy(like, "cpu"))
    for i in range(3):
        g = _random_tree(rng, like, scale=10.0 ** -i)
        g["w"][0, :4] = [0.5, -0.5, 1.5, 2.5]      # ties, scaled by max/127
        jg, jerr = jgc.compress_grads(g, jerr)
        tg, terr = grad_compress.compress_grads(
            lm.params_from_numpy(g, "cpu"), terr)
        _assert_trees_close(tg, jg, rtol=0, atol=0)
        _assert_trees_close(terr, jerr, rtol=0, atol=0)
    same, err = grad_compress.compress_grads(tg, terr, enabled=False)
    assert same is tg and err is terr


# -- the train step --------------------------------------------------------------------------

def _jax_reference_step(jcfg, params, opt, batch, nm, ocfg):
    """The JAX train step's computation without the mesh."""
    vg = jax.value_and_grad(
        lambda p, b: jlm.loss_fn(jcfg, p, b, jnp.float32, remat="none"),
        has_aux=True)
    B = batch["tokens"].shape[0]
    grads, losses = None, []
    for i in range(nm):
        mb = {k: v[i * B // nm:(i + 1) * B // nm] for k, v in batch.items()}
        (_, m), g = vg(params, mb)
        losses.append(float(m["loss"]))
        grads = g if grads is None else jax.tree_util.tree_map(
            jnp.add, grads, g)
    grads = jax.tree_util.tree_map(lambda g: g / nm, grads)
    new_p, new_opt, om = jadamw.apply_updates(ocfg, params, grads, opt)
    return new_p, new_opt, float(np.mean(losses)), float(om["grad_norm"])


@pytest.mark.parametrize("nm", [1, 4])
def test_train_step_equals_jax_composition(nm):
    jcfg, tcfg = _cfgs("qwen1p5_0p5b")
    hyper = ts.TrainHyper(microbatches=nm, remat="none",
                          compute_dtype=torch.float32)
    jstate = jts.make_train_state(jcfg, jts.TrainHyper(),
                                  jax.random.PRNGKey(0))
    batch = _batch(jcfg)
    want_p, want_opt, want_loss, want_norm = _jax_reference_step(
        jcfg, jstate.params, jstate.opt, batch, nm, jadamw.AdamWConfig())
    state = ts.train_state_from_numpy(_np_tree(jstate), "cpu")
    tbatch = {k: torch.as_tensor(v) for k, v in batch.items()}
    new, metrics = ts.build_train_step(tcfg, hyper)(state, tbatch)
    assert float(metrics["loss"]) == pytest.approx(want_loss, rel=LOSS_RTOL)
    assert float(metrics["grad_norm"]) == pytest.approx(want_norm, rel=1e-4)
    assert int(new.opt.step) == 1
    _assert_trees_close(new.params, want_p, **GRAD_TOL)
    _assert_trees_close(new.opt.mu, want_opt.mu, **GRAD_TOL)
    _assert_trees_close(new.opt.nu, want_opt.nu, **GRAD_TOL)
    # the given state is left as it was
    _assert_trees_close(state.params, jstate.params, rtol=0, atol=0)


def test_microbatching_equals_full_batch():
    """tests/test_train_integration.py:48-70 on the port: 1 vs 4
    microbatches."""
    _, tcfg = _cfgs("qwen1p5_0p5b")
    tbatch = {k: torch.as_tensor(v) for k, v in _batch(tcfg).items()}
    outs = {}
    for nm in (1, 4):
        hyper = ts.TrainHyper(microbatches=nm, remat="none")
        state = ts.make_train_state(tcfg, hyper, 0, device="cpu")
        new, metrics = ts.build_train_step(tcfg, hyper)(state, tbatch)
        outs[nm] = (float(metrics["grad_norm"]),
                    new.params["head"]["unembed"].numpy())
    np.testing.assert_allclose(outs[1][0], outs[4][0], rtol=2e-3)
    np.testing.assert_allclose(outs[1][1], outs[4][1], rtol=2e-3, atol=2e-5)


def test_train_step_with_compression_and_cast_once():
    """compress_cross_pod carries the error buffers through the step, and
    cast_params_once gives the bf16 step's loss."""
    _, tcfg = _cfgs("qwen1p5_0p5b")
    tbatch = {k: torch.as_tensor(v) for k, v in _batch(tcfg).items()}
    hyper = ts.TrainHyper(microbatches=2, compress_cross_pod=True)
    state = ts.make_train_state(tcfg, hyper, 0, device="cpu")
    assert state.ef is not None
    new, m = ts.build_train_step(tcfg, hyper)(state, tbatch)
    assert any(float(e.abs().max()) > 0 for e in tree_leaves(new.ef))
    once = dataclasses.replace(hyper, cast_params_once=True)
    _, m2 = ts.build_train_step(tcfg, once)(state, tbatch)
    assert float(m2["loss"]) == pytest.approx(float(m["loss"]),
                                              abs=BF16_LOSS_ATOL)


def test_train_state_from_numpy_keeps_every_leaf():
    jcfg, _ = _cfgs("zamba2_2p7b")
    jstate = jts.make_train_state(jcfg, jts.TrainHyper(compress_cross_pod=True),
                                  jax.random.PRNGKey(1))
    state = ts.train_state_from_numpy(_np_tree(jstate), "cpu")
    assert state.opt.step.dtype == torch.int32
    for got, want in ((state.params, jstate.params), (state.opt.mu,
                                                       jstate.opt.mu),
                      (state.ef, jstate.ef)):
        _assert_trees_close(got, want, rtol=0, atol=0)


# -- the abstract state ---------------------------------------------------------------------

def _structure(flat):
    """{path: (shape, dtype name)} of a flattened tree."""
    return {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
            for k, v in flat}


def _jax_structure(tree):
    return _structure(
        (tuple(str(getattr(k, "key", k)) for k in path), v)
        for path, v in jax.tree_util.tree_flatten_with_path(tree)[0])


def test_abstract_train_state_allocates_nothing(monkeypatch):
    """Full-width qwen2-moe-a2.7b with compression: meta tensors only,
    built without `lm.init_params` and without a generator, with the keys,
    shapes and dtypes of the JAX `abstract_train_state` (``eval_shape``)."""
    def refuse(*a, **kw):
        raise AssertionError("the abstract state drew parameters")

    class RefusedGenerator(torch.Generator):
        """Still a type (torch's meta kernels test isinstance against
        torch.Generator), but none can be made."""

        def __new__(cls, *a, **kw):
            raise AssertionError("the abstract state made a generator")

    monkeypatch.setattr(lm, "init_params", refuse)
    monkeypatch.setattr(torch, "Generator", RefusedGenerator)
    cfg = get_config("qwen2_moe_a2p7b")
    state = ts.abstract_train_state(cfg, ts.TrainHyper(compress_cross_pod=True),
                                    device="cpu")
    monkeypatch.undo()
    leaves = tree_leaves(state)
    assert leaves and all(t.device.type == "meta" for t in leaves)
    assert sum(t.numel() for t in tree_leaves(state.params)) == \
        15_146_977_280
    want = jts.abstract_train_state(
        jget_config("qwen2_moe_a2p7b"),
        jts.TrainHyper(compress_cross_pod=True))
    for got, ref in ((state.params, want.params), (state.opt.mu, want.opt.mu),
                     (state.opt.nu, want.opt.nu), (state.ef, want.ef)):
        assert _structure(tree_flatten_with_path(got)) == _jax_structure(ref)
    assert (tuple(state.opt.step.shape), state.opt.step.dtype) == \
        ((), torch.int32)
    assert tuple(want.opt.step.shape) == () and \
        str(want.opt.step.dtype) == "int32"


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_abstract_params_equal_jax_reduced(arch):
    got = lm.abstract_params(reduced_config(get_config(arch)))
    assert all(t.device.type == "meta" for t in tree_leaves(got))
    assert _structure(tree_flatten_with_path(got)) == _jax_structure(
        jlm.abstract_params(jreduced_config(jget_config(arch))))


@pytest.mark.parametrize("arch,dtype", [("zamba2_2p7b", "float32"),
                                        ("llama4_scout_17b_a16e",
                                         "bfloat16")])
def test_abstract_params_equal_jax_full_width(arch, dtype):
    got = lm.abstract_params(get_config(arch), getattr(torch, dtype))
    assert _structure(tree_flatten_with_path(got)) == _jax_structure(
        jlm.abstract_params(jget_config(arch), getattr(jnp, dtype)))


def test_abstract_optimizer_states_follow_the_params():
    _, tcfg = _cfgs("qwen1p5_0p5b")
    params = lm.init_params(tcfg, 0, torch.bfloat16, device="cpu")
    opt = adamw.abstract_state(params)
    ef = grad_compress.abstract_error_state(params)
    for tree in (opt.mu, opt.nu, ef):
        assert all(t.device.type == "meta" and t.dtype == torch.float32
                   for t in tree_leaves(tree))
        assert lm._map(lambda t: tuple(t.shape), tree) == \
            lm._map(lambda t: tuple(t.shape), params)
    assert opt.step.device.type == "meta" and opt.step.dtype == torch.int32


# -- checkpoints -----------------------------------------------------------------------------

def _leaf_names(tree):
    return sorted(".".join(p) for p, _ in tree_flatten_with_path(tree))


def test_jax_checkpoint_restores_in_the_port(tmp_path):
    jcfg, tcfg = _cfgs("qwen1p5_0p5b")
    jhyper = jts.TrainHyper(compress_cross_pod=True)
    jstate = jts.make_train_state(jcfg, jhyper, jax.random.PRNGKey(2))
    jstate = jstate._replace(opt=jstate.opt._replace(step=jnp.int32(7)))
    jckpt.save(str(tmp_path), 7, jstate)
    assert ckpt.latest_step(str(tmp_path)) == 7
    abstract = ts.abstract_train_state(
        tcfg, ts.TrainHyper(compress_cross_pod=True), device="cpu")
    assert all(t.device.type == "meta" for t in tree_leaves(abstract))
    got = ckpt.restore(str(tmp_path), 7, abstract, device="cpu")
    assert int(got.opt.step) == 7 and got.opt.step.dtype == torch.int32
    want = _np_tree(jstate)
    for g, w in ((got.params, want.params), (got.opt.mu, want.opt.mu),
                 (got.opt.nu, want.opt.nu), (got.ef, want.ef)):
        _assert_trees_close(g, w, rtol=0, atol=0)


def test_port_checkpoint_restores_in_jax(tmp_path):
    jcfg, tcfg = _cfgs("zamba2_2p7b")
    hyper = ts.TrainHyper(compress_cross_pod=True)
    state = ts.make_train_state(tcfg, hyper, 3, device="cpu")
    state = state._replace(opt=state.opt._replace(
        step=torch.tensor(4, dtype=torch.int32)))
    ckpt.save(str(tmp_path), 4, state)
    jabstract = jts.abstract_train_state(
        jcfg, jts.TrainHyper(compress_cross_pod=True))
    got = jckpt.restore(str(tmp_path), 4, jabstract)
    assert int(got.opt.step) == 4
    for g, w in ((state.params, got.params), (state.opt.nu, got.opt.nu),
                 (state.ef, got.ef)):
        _assert_trees_close(g, w, rtol=0, atol=0)
    # the same files, leaf for leaf
    names = {e["name"] for e in __import__("json").load(
        open(tmp_path / "step_00000004" / ckpt.MANIFEST))["leaves"]}
    assert names == {n for n, _ in jckpt._leaf_files(jabstract)}


def test_restore_refuses_a_mismatched_tree(tmp_path):
    _, tcfg = _cfgs("qwen1p5_0p5b")
    state = ts.make_train_state(tcfg, ts.TrainHyper(), 0, device="cpu")
    ckpt.save(str(tmp_path), 1, state)
    wider = ts.abstract_train_state(
        dataclasses.replace(tcfg, d_ff=64), ts.TrainHyper(), device="cpu")
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore(str(tmp_path), 1, wider, device="cpu")
    with_ef = ts.abstract_train_state(
        tcfg, ts.TrainHyper(compress_cross_pod=True), device="cpu")
    with pytest.raises(KeyError, match="missing"):
        ckpt.restore(str(tmp_path), 1, with_ef, device="cpu")


# -- the trainer -------------------------------------------------------------------------------

SMOKE_SHAPE = ShapeSpec("smoke", seq_len=32, global_batch=8, kind="train")


def _trainer(tmp, arch="qwen1p5_0p5b", monitor=None, **hyper_kw):
    cfg = reduced_config(get_config(arch))
    hyper = ts.TrainHyper(microbatches=hyper_kw.pop("microbatches", 2),
                          remat="none", **hyper_kw)
    tcfg = TrainerConfig(ckpt_dir=str(tmp), ckpt_every=5,
                         data=data.DataConfig(seed=7))
    return Trainer(cfg, SMOKE_SHAPE, hyper, tcfg, monitor=monitor,
                   device="cpu")


def test_trainer_loss_decreases(tmp_path):
    log = _trainer(tmp_path / "a").run(n_steps=12)
    assert [r["step"] for r in log] == list(range(1, 13))
    assert all(np.isfinite(r["loss"]) for r in log)
    first = np.mean([r["loss"] for r in log[:3]])
    last = np.mean([r["loss"] for r in log[-3:]])
    assert last < first
    assert all(r["wall_s"] > 0 and r["lr"] > 0 for r in log)


def test_trainer_restart_resumes_identically(tmp_path):
    log1 = _trainer(tmp_path / "full").run(n_steps=12)
    _trainer(tmp_path / "restart").run(n_steps=5)   # "crash" after step 5
    assert ckpt.list_steps(str(tmp_path / "restart")) == [5]
    log3 = _trainer(tmp_path / "restart").run(n_steps=12)
    assert log3[0]["step"] == 6
    assert log3[-1]["loss"] == pytest.approx(log1[-1]["loss"], rel=1e-5)


def test_trainer_checkpoint_retention(tmp_path):
    _trainer(tmp_path / "k").run(n_steps=20)  # ckpt at 5, 10, 15, 20
    assert ckpt.list_steps(str(tmp_path / "k")) == [10, 15, 20]


def test_trainer_records_the_monitor_plan(tmp_path):
    mon = PodMonitor(1, clock=SimClock(lambda d, t: 1.0))
    log = _trainer(tmp_path / "m", monitor=mon).run(n_steps=4)
    assert all(r["mb_plan"] == [2] for r in log)
    assert len(mon.history) == 4


def test_trainer_with_monitor_rebalances(tmp_path):
    """tests/test_train_integration.py's monitor loop on the port: a
    straggler appearing mid-run shifts the committed plan after the
    3-interval hysteresis."""
    mon = PodMonitor(4, clock=SimClock(
        lambda d, t: 3.0 if (d == 1 and t >= 3.0) else 1.0))
    tr = _trainer(tmp_path / "mon", monitor=mon)
    tr.mitigator = StragglerMitigator(n_devices=4, total_microbatches=16)
    log = tr.run(n_steps=12)
    plans = [r["mb_plan"] for r in log]
    assert plans[0] == [4, 4, 4, 4]
    assert plans[-1][1] < 4 and sum(plans[-1]) == 16


def test_train_cli_runs_on_the_cpu(tmp_path, capsys):
    from repro_torch.launch import train
    log = train.main(["--arch", "qwen1.5-0.5b", "--reduced", "--device",
                      "cpu", "--steps", "3", "--seq", "32", "--ckpt",
                      str(tmp_path), "--monitor"])
    assert [r["step"] for r in log] == [1, 2, 3]
    assert all("mb_plan" in r for r in log)
    assert "step 3 loss" in capsys.readouterr().out
    assert _build.LAUNCHES["triad"] == 0
