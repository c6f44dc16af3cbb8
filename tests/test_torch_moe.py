"""The port's MoE block (`repro_torch.models.moe`) against the JAX package
on the CPU, in f32 compute, with JAX weights crossed by
`lm.params_from_numpy` and inputs made with numpy from a seed.

Cases: tests/test_moe_dispatch.py's three shapes, one with the experts
padded (8 real of 16) and a gated shared expert, one with routing groups
and an ungated shared expert, and one whose router ties every expert.

Tolerances: the chosen experts and ``frac_dropped`` exactly (a count over
integer slots, against the JAX expression run op by op: see
`_jax_frac_dropped`); ``out`` within rtol/atol 1e-5 (tests/test_moe_dispatch.py's
own: the expert products sum in another order); ``lb_loss`` and
``z_loss`` within rel 1e-6 (means of f32 softmax values); gradients
within 1e-5.
"""

import importlib
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as jmoe
from repro_torch._tree import tree_flatten_with_path
from repro_torch.models import lm, moe

TOL = dict(rtol=1e-5, atol=1e-5)
D_MODEL = 32

# (B, S, E padded, E real, K, cf, d_ff_shared, gated, group_size)
CASES = {
    "B2-S64-E8-K2": (2, 64, 8, 8, 2, 1.25, 0, False, 0),
    "B1-S128-E16-K1": (1, 128, 16, 16, 1, 1.0, 0, False, 0),
    "B2-S32-E4-K2-cf2": (2, 32, 4, 4, 2, 2.0, 0, False, 0),
    "padded-8-of-16-gated": (2, 48, 16, 8, 2, 1.25, 64, True, 0),
    "groups-of-16-shared": (2, 64, 8, 8, 2, 1.25, 48, False, 16),
}


def _cfgs(case):
    B, S, E, Er, K, cf, dsh, gated, gs = CASES[case]
    kw = dict(d_model=D_MODEL, n_experts=E, n_experts_real=Er, top_k=K,
              d_ff_expert=64, d_ff_shared=dsh, shared_gated=gated,
              capacity_factor=cf, group_size=gs)
    return jmoe.MoeConfig(**kw), moe.MoeConfig(**kw), (B, S)


def _np(x):
    return (x.detach().float().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(x, np.float32))


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    jcfg, cfg, (B, S) = _cfgs(request.param)
    jparams = jax.jit(lambda k: jmoe.init_moe(k, jcfg))(
        jax.random.PRNGKey(7))
    params = lm.params_from_numpy(jax.tree_util.tree_map(np.asarray,
                                                         jparams), "cpu")
    x = np.random.default_rng(B * S + jcfg.n_experts).standard_normal(
        (B, S, D_MODEL)).astype(np.float32)
    return (request.param, jcfg, cfg, jparams, params, x,
            _jax_frac_dropped(jcfg, jparams, x))


def _jax(jcfg, jparams, x, impl):
    return jax.jit(lambda p, a: jmoe.moe_block(
        p, jcfg, a, jnp.float32, impl=impl))(jparams, jnp.asarray(x))


def _jax_frac_dropped(jcfg, jparams, x) -> float:
    """``frac_dropped`` as `jmoe.moe_block` writes it (moe.py:98-109 and
    :167), run op by op: under `jax.jit` XLA turns the division by the
    slot count into a product with its reciprocal, one ulp away from the
    expression as written (0.41666666 against 0.41666669 at 80 dropped of
    192), which the port computes."""
    _, idx = _routing(jcfg, jparams, x)
    idx = jnp.asarray(idx)
    B, S, K = idx.shape
    onehot = jax.nn.one_hot(idx, jcfg.n_experts, dtype=jnp.int32)
    flat = onehot.reshape(B, S * K, jcfg.n_experts)
    pos = (jnp.cumsum(flat, axis=1) * flat - 1).reshape(onehot.shape)
    C = max(1, int(jcfg.capacity_factor * K * S / jcfg.n_experts))
    within_cap = (pos >= 0) & (pos < C)
    return float(1.0 - within_cap.astype(jnp.float32).sum() / (B * S * K))


def _routing(cfg, params, x):
    """The router's (probabilities, chosen experts) as `moe_block` forms
    them, for the JAX (``jmoe``) or the port's module."""
    B0, S0, D = x.shape
    if cfg.group_size and cfg.group_size < S0:
        x = x.reshape(B0 * (S0 // cfg.group_size), cfg.group_size, D)
    if isinstance(cfg, jmoe.MoeConfig):
        probs = jax.nn.softmax(jmoe._router_probs(params, cfg,
                                                  jnp.asarray(x)), axis=-1)
        return np.asarray(probs), np.asarray(jax.lax.top_k(probs,
                                                           cfg.top_k)[1])
    probs = torch.softmax(moe._router_probs(params, cfg,
                                            torch.as_tensor(x)), dim=-1)
    return probs.numpy(), moe._top_k(probs, cfg.top_k)[1].numpy()


def test_init_moe_has_the_jax_keys_shapes_and_dtypes():
    for case in sorted(CASES):
        jcfg, cfg, _ = _cfgs(case)
        for jdt, dt in ((jnp.float32, torch.float32),
                        (jnp.bfloat16, torch.bfloat16)):
            want = jax.tree_util.tree_map(
                lambda a: (tuple(a.shape), str(a.dtype)),
                jax.eval_shape(lambda: jmoe.init_moe(jax.random.PRNGKey(0),
                                                     jcfg, jdt)))
            got = lm._map(lambda t: (tuple(t.shape), str(t.dtype)[6:]),
                          moe.init_moe(torch.Generator().manual_seed(0),
                                       cfg, dt))
            assert got == want, case


def test_moe_public_names_are_the_jax_modules():
    own = {n for n, v in vars(moe).items()
           if not n.startswith("_") and (inspect.isfunction(v)
                                         or inspect.isclass(v))
           and v.__module__ == moe.__name__}
    assert own <= set(moe.__all__) <= set(dir(importlib.import_module(
        "repro.models.moe")))


def test_router_chooses_the_jax_experts(case):
    _, jcfg, cfg, jparams, params, x, _ = case
    jp, jidx = _routing(jcfg, jparams, x)
    p, idx = _routing(cfg, params, x)
    np.testing.assert_allclose(p, jp, rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(idx, jidx)


@pytest.mark.parametrize("impl", ["gshard", "sorted"])
def test_moe_block_matches_jax(case, impl):
    name, jcfg, cfg, jparams, params, x, jfrac = case
    jout, jaux = _jax(jcfg, jparams, x, impl)
    out, aux = moe.moe_block(params, cfg, torch.as_tensor(x), torch.float32,
                             impl=impl)
    assert out.shape == x.shape and out.dtype == torch.float32
    np.testing.assert_allclose(_np(out), np.asarray(jout), **TOL)
    assert float(aux["frac_dropped"]) == jfrac
    assert jfrac == pytest.approx(float(jaux["frac_dropped"]), rel=1e-6)
    for key in ("lb_loss", "z_loss"):
        assert float(aux[key]) == pytest.approx(float(jaux[key]), rel=1e-6)
    if name == "B2-S64-E8-K2":      # capacity 20 of 32 wants: some dropped
        assert float(aux["frac_dropped"]) > 0


def test_sorted_equals_gshard(case):
    _, _, cfg, _, params, x, _ = case
    xt = torch.as_tensor(x)
    out_g, aux_g = moe.moe_block(params, cfg, xt, torch.float32,
                                 impl="gshard")
    out_s, aux_s = moe.moe_block(params, cfg, xt, torch.float32,
                                 impl="sorted")
    np.testing.assert_allclose(_np(out_s), _np(out_g), **TOL)
    assert {k: float(v) for k, v in aux_s.items()} == \
        {k: float(v) for k, v in aux_g.items()}


@pytest.mark.parametrize("impl", ["gshard", "sorted"])
def test_moe_gradients_match_jax(case, impl):
    """Autograd against `jax.grad` of the mean square output plus both aux
    losses, for every parameter and the input."""
    _, jcfg, cfg, jparams, params, x, _ = case

    def jloss(p, a):
        out, aux = jmoe.moe_block(p, jcfg, a, jnp.float32, impl=impl)
        return jnp.mean(out ** 2) + aux["lb_loss"] + aux["z_loss"]

    jg, jgx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jparams,
                                                       jnp.asarray(x))
    p = lm._map(lambda t: t.detach().requires_grad_(), params)
    xt = torch.as_tensor(x).requires_grad_()
    out, aux = moe.moe_block(p, cfg, xt, torch.float32, impl=impl)
    loss = (out ** 2).mean() + aux["lb_loss"] + aux["z_loss"]
    flat = list(tree_flatten_with_path(p))
    grads = torch.autograd.grad(loss, [xt] + [t for _, t in flat])
    np.testing.assert_allclose(_np(grads[0]), np.asarray(jgx), **TOL)
    jflat = {tuple(str(getattr(k, "key", k)) for k in path): np.asarray(v)
             for path, v in jax.tree_util.tree_flatten_with_path(jg)[0]}
    assert sorted(jflat) == sorted(path for path, _ in flat)
    for (path, _), g in zip(flat, grads[1:]):
        np.testing.assert_allclose(_np(g), jflat[path], err_msg=str(path),
                                   **TOL)


def test_tied_router_picks_the_lowest_experts_as_jax():
    """A zero router ties every expert: both packages choose experts 0..K-1
    for every token, and give the same block output."""
    jcfg, cfg, (B, S) = _cfgs("B2-S64-E8-K2")
    jparams = jmoe.init_moe(jax.random.PRNGKey(1), jcfg)
    jparams["router"] = jnp.zeros_like(jparams["router"])
    params = lm.params_from_numpy(jax.tree_util.tree_map(np.asarray,
                                                         jparams), "cpu")
    x = np.random.default_rng(2).standard_normal(
        (B, S, D_MODEL)).astype(np.float32)
    _, idx = _routing(cfg, params, x)
    _, jidx = _routing(jcfg, jparams, x)
    np.testing.assert_array_equal(idx, jidx)
    assert (idx == np.arange(cfg.top_k)).all()
    for impl in ("gshard", "sorted"):
        jout, jaux = _jax(jcfg, jparams, x, impl)
        out, aux = moe.moe_block(params, cfg, torch.as_tensor(x),
                                 torch.float32, impl=impl)
        np.testing.assert_allclose(_np(out), np.asarray(jout), **TOL)
        assert float(aux["frac_dropped"]) == _jax_frac_dropped(
            jcfg, jparams, x)


def test_moe_block_refuses_an_unknown_dispatch():
    _, cfg, _ = _cfgs("B2-S32-E4-K2-cf2")
    params = moe.init_moe(torch.Generator().manual_seed(0), cfg)
    with pytest.raises(ValueError, match="moe_impl"):
        moe.moe_block(params, cfg, torch.zeros(1, 8, D_MODEL),
                      torch.float32, impl="dense")


def test_moe_block_bf16_close_to_jax():
    """bf16 compute: both round every product's inputs to 8 significant
    bits; the outputs agree within the bf16 tolerance of
    tests/test_kernels.py:15 (2e-2) and the routing stays f32."""
    jcfg, cfg, (B, S) = _cfgs("padded-8-of-16-gated")
    jparams = jmoe.init_moe(jax.random.PRNGKey(3), jcfg)
    params = lm.params_from_numpy(jax.tree_util.tree_map(np.asarray,
                                                         jparams), "cpu")
    x = np.random.default_rng(5).standard_normal(
        (B, S, D_MODEL)).astype(np.float32)
    jfrac = _jax_frac_dropped(jcfg, jparams, x)
    for impl in ("gshard", "sorted"):
        jout, _ = jax.jit(lambda p, a: jmoe.moe_block(
            p, jcfg, a, jnp.bfloat16, impl=impl))(jparams, jnp.asarray(x))
        out, aux = moe.moe_block(params, cfg, torch.as_tensor(x),
                                 torch.bfloat16, impl=impl)
        assert out.dtype == torch.bfloat16
        np.testing.assert_allclose(_np(out), np.asarray(jout, np.float32),
                                   rtol=2e-2, atol=2e-2)
        assert float(aux["frac_dropped"]) == jfrac
