"""The port's LM serving path (`repro_torch.models.lm`) against the JAX
package on the CPU, on reduced zamba2-2.7b (hybrid), qwen1.5-0.5b (dense)
and mamba2-2.7b (ssm), in f32 compute.  Weights come from the JAX
initializer and cross with `params_from_numpy`; tokens are numpy from a
seed.

Tolerance: 1e-4 absolute on logits of magnitude up to about 4.  Both sides
compute in f32 and differ only in the order of their sums (matmuls,
attention and the SSD chunk products); over these few layers that gives
differences of a few 1e-6, and 1e-4 leaves room for it without hiding a
real fault (a wrong mask, decay or cache position moves logits by 1e-2 or
more)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs.base import get_config as jget_config
from repro.configs.base import reduced_config as jreduced_config
from repro.models import lm as jlm
from repro_torch import _build
from repro_torch.configs.base import get_config, reduced_config
from repro_torch.models import lm

ATOL = dict(rtol=0, atol=1e-4)
ARCHS = ["zamba2_2p7b", "qwen1p5_0p5b", "mamba2_2p7b"]
B, S, MAX_LEN, STEPS = 2, 64, 32, 16


def _np(x):
    return np.asarray(x.float().numpy() if isinstance(x, torch.Tensor)
                      else x, np.float32)


@pytest.fixture(scope="module", params=ARCHS)
def case(request):
    arch = request.param
    jcfg = jreduced_config(jget_config(arch))
    cfg = reduced_config(get_config(arch))
    jparams = jlm.init_params(jcfg, jax.random.PRNGKey(3))
    params = lm.params_from_numpy(jax.tree_util.tree_map(np.asarray,
                                                         jparams), "cpu")
    tokens = np.random.default_rng(4).integers(
        0, cfg.vocab, (B, S)).astype(np.int32)
    return arch, jcfg, cfg, jparams, params, tokens


def _values(obj):
    return tuple(v if not dataclasses.is_dataclass(v) else
                 _values(v)
                 for v in (getattr(obj, f.name)
                           for f in dataclasses.fields(obj)))


def test_configs_are_the_jax_configs():
    from repro.configs import base as jbase
    from repro_torch.configs import base
    assert base.ARCH_IDS == jbase.ARCH_IDS and base.ALIASES == jbase.ALIASES
    assert base.SHAPES == tuple(base.ShapeSpec(*_values(s))
                                for s in jbase.SHAPES)
    for arch in base.ARCH_IDS:
        for full in (True, False):
            j, t = jget_config(arch), get_config(arch)
            if not full:
                j, t = jreduced_config(j), reduced_config(t)
            assert _values(t) == _values(j), arch
            for prop in ("vocab_padded", "head_dim", "n_heads_padded",
                         "n_kv_heads_eff"):
                assert getattr(t, prop) == getattr(j, prop), (arch, prop)


def test_init_params_has_the_jax_keys_and_shapes(case):
    arch, jcfg, cfg, jparams, _, _ = case
    want = jax.tree_util.tree_map(lambda a: tuple(a.shape),
                                  jlm.abstract_params(jcfg))
    got = lm._map(lambda t: tuple(t.shape),
                  lm.init_params(cfg, torch.Generator().manual_seed(0),
                                 device="cpu"))
    assert got == want
    # the deterministic leaves are the JAX package's values
    if "ssm" in jparams["layers"]:
        ours = lm.init_params(cfg, 0, device="cpu")["layers"]["ssm"]
        for key in ("dt_bias", "A_log", "D", "conv_b", "norm_w"):
            np.testing.assert_allclose(
                _np(ours[key]), np.asarray(jparams["layers"]["ssm"][key]),
                rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("impl", ["ref", "kernel"])
def test_prefill_matches_jax(case, impl):
    arch, jcfg, cfg, jparams, params, tokens = case
    _build.reset_counters()
    got = lm.prefill(cfg, params, {"tokens": tokens},
                     torch.float32, impl, device="cpu")
    if impl == "kernel":
        n_attn = (cfg.n_layers if cfg.family == "dense" else
                  cfg.n_layers // cfg.hybrid_every if cfg.hybrid_every
                  else 0)
        n_ssd = cfg.n_layers if cfg.family != "dense" else 0
        assert dict(_build.PLAIN_CALLS) == {
            k: v for k, v in (("flash_attention", n_attn),
                              ("ssd_scan", n_ssd)) if v}
    jimpl = "pallas" if impl == "kernel" else "ref"
    want = jax.jit(lambda p, t: jlm.prefill(
        jcfg, p, {"tokens": t}, MAX_LEN, jnp.float32, jimpl))(
        jparams, jnp.asarray(tokens))
    assert got.shape == want.shape == (B, 1, cfg.vocab_padded)
    np.testing.assert_allclose(_np(got), np.asarray(want), **ATOL)


def _jax_decode(jcfg, jparams, jcaches, tokens, start, steps):
    step = jax.jit(lambda p, c, t, pos: jlm.decode_step(
        jcfg, p, c, t, pos, jnp.float32))
    logits = []
    for pos in range(start, start + steps):
        lg, jcaches = step(jparams, jcaches,
                           jnp.asarray(tokens[:, pos:pos + 1]),
                           jnp.int32(pos))
        logits.append(np.asarray(lg))
    return logits, jcaches


def test_decode_steps_match_jax_and_continue_a_jax_decode(case):
    arch, jcfg, cfg, jparams, params, tokens = case
    half = STEPS // 2
    jlog, jcaches = _jax_decode(jcfg, jparams,
                                jlm.init_caches(jcfg, B, MAX_LEN,
                                                jnp.float32),
                                tokens, 0, STEPS)
    caches = lm.init_caches(cfg, B, MAX_LEN, torch.float32, device="cpu")
    for pos in range(STEPS):
        lg, caches = lm.decode_step(cfg, params, caches,
                                    torch.tensor(tokens[:, pos:pos + 1]),
                                    pos, torch.float32)
        np.testing.assert_allclose(_np(lg), jlog[pos], **ATOL)
    for key in caches:
        for leaf, jleaf in zip(jax.tree_util.tree_leaves(caches[key]),
                               jax.tree_util.tree_leaves(jcaches[key])):
            np.testing.assert_allclose(_np(leaf), np.asarray(jleaf), **ATOL)
    # a JAX decode of the first half, continued in the port
    _, jmid = _jax_decode(jcfg, jparams,
                          jlm.init_caches(jcfg, B, MAX_LEN, jnp.float32),
                          tokens, 0, half)
    caches = lm.caches_from_numpy(jax.tree_util.tree_map(np.asarray, jmid),
                                  "cpu")
    for pos in range(half, STEPS):
        lg, caches = lm.decode_step(cfg, params, caches,
                                    torch.tensor(tokens[:, pos:pos + 1]),
                                    pos, torch.float32)
        np.testing.assert_allclose(_np(lg), jlog[pos], **ATOL)


def test_prefill_equals_teacher_forced_decode(case):
    arch, jcfg, cfg, jparams, params, tokens = case
    pre = lm.prefill(cfg, params, {"tokens": tokens}, torch.float32,
                     "kernel", device="cpu")
    caches = lm.init_caches(cfg, B, S, torch.float32, device="cpu")
    for pos in range(S):
        lg, caches = lm.decode_step(cfg, params, caches,
                                    torch.tensor(tokens[:, pos:pos + 1]),
                                    pos, torch.float32)
    np.testing.assert_allclose(_np(lg), _np(pre), **ATOL)


def test_decode_and_engine_refuse_the_encoder():
    """The encoder has no decode (``supports_decode`` False, as in the JAX
    config): no caches, `decode_step` and `ServeEngine` raise."""
    from repro_torch.serve.engine import ServeEngine
    cfg = reduced_config(get_config("hubert_xlarge"))
    assert not cfg.supports_decode
    assert jreduced_config(jget_config("hubert_xlarge")).supports_decode \
        is False
    params = lm.init_params(cfg, 0, device="cpu")
    assert lm.init_caches(cfg, B, MAX_LEN, torch.float32, device="cpu") == {}
    with pytest.raises(ValueError, match="supports_decode"):
        lm.decode_step(cfg, params, {}, torch.zeros((B, 1), dtype=torch.int32),
                       0, torch.float32)
    with pytest.raises(ValueError, match="supports_decode"):
        ServeEngine(cfg, params, device="cpu")


class _Allocations(TorchDispatchMode):
    """The shapes of the op outputs that are new tensors (their schema
    return aliases no input: not a view, not an in-place or ``out=``
    result), in the order the ops ran."""

    def __init__(self):
        super().__init__()
        self.shapes = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        outs = out if isinstance(out, (tuple, list)) else (out,)
        for ret, t in zip(func._schema.returns, outs):
            if isinstance(t, torch.Tensor) and ret.alias_info is None:
                self.shapes.append(tuple(t.shape))
        return out


@pytest.mark.parametrize("donate", [False, True])
@pytest.mark.parametrize("cache_update", ["dus", "blend"])
@pytest.mark.parametrize("arch", ["qwen1p5_0p5b", "zamba2_2p7b"])
def test_decode_step_allocates_at_most_one_cache_a_leaf(arch, cache_update,
                                                        donate):
    """`lm.decode_step` on reduced dense and hybrid configs, counted by
    a `TorchDispatchMode` over its op outputs: without ``donate`` one
    tensor of each cache leaf's shape is allocated (its copy), with
    ``donate`` none; no kv cache's layer slice is copied either way (the
    layers write in place).  Without ``donate`` the given caches stay
    bit-equal; with it they are the returned ones, written in place, and
    both give the same logits and caches."""
    cfg = reduced_config(get_config(arch))
    params = lm.init_params(cfg, 0, device="cpu")
    gen = torch.Generator().manual_seed(5)
    caches = lm._map(lambda a: torch.rand(a.shape, generator=gen),
                     lm.init_caches(cfg, B, MAX_LEN, torch.float32,
                                    device="cpu"))
    before = lm._map(torch.clone, caches)
    tokens = torch.tensor(np.random.default_rng(6).integers(
        0, cfg.vocab, (B, 1)).astype(np.int32))
    leaves = jax.tree_util.tree_leaves(caches)
    with torch.no_grad(), _Allocations() as mode:
        logits, new = lm.decode_step(cfg, params, caches, tokens, 3,
                                     torch.float32, cache_update,
                                     donate=donate)
    for leaf in leaves:
        mine = sum(tuple(x.shape) == tuple(leaf.shape) for x in leaves)
        assert mode.shapes.count(tuple(leaf.shape)) == \
            (0 if donate else mine), leaf.shape
    kv = [x for k in ("attn", "shared_attn") if k in caches
          for x in caches[k].values()]
    assert kv and all(tuple(x.shape[1:]) not in mode.shapes for x in kv)
    flat_new = jax.tree_util.tree_leaves(new)
    flat_before = jax.tree_util.tree_leaves(before)
    if donate:
        assert all(a is b for a, b in zip(flat_new, leaves))
        want_logits, want = lm.decode_step(cfg, params, before, tokens, 3,
                                           torch.float32, cache_update)
        assert torch.equal(logits, want_logits)
        for a, b in zip(flat_new, jax.tree_util.tree_leaves(want)):
            assert torch.equal(a, b)
    else:
        for a, b in zip(leaves, flat_before):
            assert torch.equal(a, b)
        assert not any(torch.equal(a, b)
                       for a, b in zip(flat_new, flat_before))


def test_donated_decode_refuses_autograd():
    """A decode writes its caches in place, so where autograd records the
    values it writes it raises, naming ``torch.no_grad()``."""
    cfg = reduced_config(get_config("qwen1p5_0p5b"))
    params = lm._map(lambda a: a.requires_grad_(),
                     lm.init_params(cfg, 0, device="cpu"))
    caches = lm.init_caches(cfg, B, MAX_LEN, torch.float32, device="cpu")
    with pytest.raises(RuntimeError, match="no_grad"):
        lm.decode_step(cfg, params, caches,
                       torch.zeros((B, 1), dtype=torch.int32), 0,
                       torch.float32, donate=True)
