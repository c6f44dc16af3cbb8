"""The port's model layers (`repro_torch.models.layers`, `.attention`,
`.mamba2`) against the JAX package on the CPU, in f32.  Weights are made by
the JAX initializers and carried across with `lm.params_from_numpy`;
activations are numpy arrays from a seed handed to both.  Tolerance 2e-5
(the f32 tolerance of tests/test_kernels.py): both sides compute in f32 and
differ only in the order of their sums."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattn
from repro.models import layers as jL
from repro.models import mamba2 as jm2
from repro_torch.models import attention as attn
from repro_torch.models import layers as L
from repro_torch.models import lm
from repro_torch.models import mamba2 as m2

F32 = dict(rtol=2e-5, atol=2e-5)


def _carry(jtree):
    return lm.params_from_numpy(jax.tree_util.tree_map(np.asarray, jtree),
                                "cpu")


def _x(shape, seed, scale=1.0):
    a = (np.random.default_rng(seed).standard_normal(shape) * scale).astype(
        np.float32)
    return jnp.asarray(a), torch.tensor(a)


def _close(got, want, tol=F32):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), **tol)


def test_rms_norm_and_rope():
    jx, x = _x((2, 16, 4, 32), 0)
    jw, w = _x((32,), 1, 0.1)
    _close(L.rms_norm(x, w), jL.rms_norm(jx, jw))
    pos = np.arange(16)[None].repeat(2, 0) + np.array([[0], [7]])
    _close(L.apply_rope(x, torch.tensor(pos), 10000.0),
           jL.apply_rope(jx, jnp.asarray(pos), 10000.0))
    _close(L.apply_rope(x, torch.tensor(pos), 1e6),
           jL.apply_rope(jx, jnp.asarray(pos), 1e6))


@pytest.mark.parametrize("kind", ["swiglu", "gelu"])
def test_mlps(kind):
    jp = jL.init_mlp(jax.random.PRNGKey(2), 64, 96)
    jx, x = _x((2, 8, 64), 3)
    fj, ft = ((jL.mlp_swiglu, L.mlp_swiglu) if kind == "swiglu" else
              (jL.mlp_gelu, L.mlp_gelu))
    _close(ft(_carry(jp), x, torch.float32), fj(jp, jx, jnp.float32))


def test_embed_and_unembed():
    je = jL.init_embed(jax.random.PRNGKey(4), 64, 32)
    jh = jL.init_unembed(jax.random.PRNGKey(5), 32, 64)
    toks = np.random.default_rng(6).integers(0, 64, (2, 9)).astype(np.int32)
    _close(L.embed_tokens(_carry(je), torch.tensor(toks), torch.float32),
           jL.embed_tokens(je, jnp.asarray(toks), jnp.float32))
    jx, x = _x((2, 9, 32), 7)
    got = L.unembed_logits(_carry(jh), x, torch.float32)
    assert got.dtype == torch.float32
    _close(got, jL.unembed_logits(jh, jx, jnp.float32))


def _acfg(n_heads=16, n_kv=4, hd=32, causal=True, bias=False):
    kw = dict(d_model=128, n_heads=n_heads, n_kv_heads=n_kv, head_dim=hd,
              qkv_bias=bias, causal=causal)
    return jattn.AttnConfig(**kw), attn.AttnConfig(**kw)


@pytest.mark.parametrize("impl", ["ref", "kernel"])
@pytest.mark.parametrize("causal,bias", [(True, False), (False, True)])
def test_attention_train(impl, causal, bias):
    jc, c = _acfg(causal=causal, bias=bias)
    jp = jattn.init_attention(jax.random.PRNGKey(8), jc)
    if bias:   # nonzero biases, so the bias path is exercised
        jp = {**jp, **{k: jax.random.normal(jax.random.PRNGKey(i), jp[k].shape)
                       for i, k in enumerate(("bq", "bk", "bv"))}}
    jx, x = _x((2, 48, 128), 9)
    pos = np.broadcast_to(np.arange(48), (2, 48))
    want = jattn.attention_train(jp, jc, jx, jnp.asarray(pos), jnp.float32,
                                 "pallas" if impl == "kernel" else "ref")
    got = attn.attention_train(_carry(jp), c, x, torch.tensor(pos),
                               torch.float32, impl)
    _close(got, want)


@pytest.mark.parametrize("cache_update", ["dus", "blend"])
def test_attention_decode(cache_update):
    jc, c = _acfg()
    jp = jattn.init_attention(jax.random.PRNGKey(10), jc)
    p = _carry(jp)
    jcache = jattn.init_kv_cache(2, 24, jc, jnp.float32)
    cache = attn.init_kv_cache(2, 24, c, torch.float32, "cpu")
    for pos in range(6):
        jx, x = _x((2, 1, 128), 20 + pos)
        jout, jcache = jattn.attention_decode(jp, jc, jx, jcache, pos,
                                              jnp.float32, cache_update)
        before = cache["k"].clone()
        out, cache = attn.attention_decode(p, c, x, cache, pos,
                                           torch.float32, cache_update)
        _close(out, jout)
        for key in ("k", "v"):
            _close(cache[key], jcache[key])
    # the given cache is not modified
    assert torch.equal(before[:, :5], cache["k"][:, :5])
    assert not torch.equal(before[:, 5], cache["k"][:, 5])


def _mcfg():
    kw = dict(d_model=64, d_state=16, head_dim=16, expand=2, d_conv=4,
              chunk=16)
    return jm2.MambaConfig(**kw), m2.MambaConfig(**kw)


def test_causal_conv_and_its_decode_state():
    jx, x = _x((2, 12, 40), 30)
    jw, w = _x((4, 40), 31, 0.2)
    jb, b = _x((40,), 32, 0.1)
    jy, jst = jm2._causal_conv(jx, jw, jb)
    y, st = m2._causal_conv(x, w, b)
    _close(y, jy)
    _close(st, jst)
    # one more step from the K-1 state == the full sequence's last output
    jx2, x2 = _x((2, 1, 40), 33)
    jy2, jst2 = jm2._causal_conv(jx2, jw, jb, state=jst)
    y2, st2 = m2._causal_conv(x2, w, b, state=st)
    _close(y2, jy2)
    _close(st2, jst2)
    full, _ = m2._causal_conv(torch.cat([x, x2], 1), w, b)
    _close(y2, full[:, -1:].numpy())


@pytest.mark.parametrize("impl", ["ref", "kernel"])
def test_mamba_block(impl):
    jc, c = _mcfg()
    jp = jm2.init_mamba(jax.random.PRNGKey(11), jc)
    jp = {**jp, "norm_w": jax.random.normal(jax.random.PRNGKey(12),
                                            jp["norm_w"].shape) * 0.1}
    jx, x = _x((2, 64, 64), 13)
    want = jm2.mamba_block(jp, jc, jx, jnp.float32,
                           "pallas" if impl == "kernel" else "ref")
    got = m2.mamba_block(_carry(jp), c, x, torch.float32, impl)
    _close(got, want)


def test_mamba_decode_step_matches_jax_and_the_block():
    jc, c = _mcfg()
    jp = jm2.init_mamba(jax.random.PRNGKey(14), jc)
    p = _carry(jp)
    jcache = jm2.init_mamba_cache(2, jc)
    cache = m2.init_mamba_cache(2, c, device="cpu")
    jx, x = _x((2, 20, 64), 15)
    outs = []
    for t in range(20):
        jout, jcache = jm2.mamba_decode_step(jp, jc, jx[:, t:t + 1], jcache,
                                             jnp.float32)
        out, cache = m2.mamba_decode_step(p, c, x[:, t:t + 1], cache,
                                          torch.float32)
        _close(out, jout)
        outs.append(out)
    for key in ("conv", "ssm"):
        _close(cache[key], jcache[key])
    # the O(1) recurrence reproduces the chunked block (chunk 16 | S 16)
    blk = m2.mamba_block(p, c, x[:, :16], torch.float32, "ref")
    _close(torch.cat(outs[:16], 1), blk.numpy(), dict(rtol=1e-4, atol=1e-4))
