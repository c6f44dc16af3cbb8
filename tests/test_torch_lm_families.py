"""The moe, encoder and vlm LM families of the port (`repro_torch.models.lm`,
`serve.engine`, `train.trainer`) against the JAX package on the CPU, on
reduced qwen2-moe-a2.7b (8 real experts padded to 16, top-2, a gated
shared expert), llama4-scout-17b-a16e (top-1, an ungated shared
expert), hubert-xlarge (frames of 64, bidirectional) and pixtral-12b (16
patches of 64 before the tokens), in f32 compute.  Weights come from the
JAX initializer and cross with `params_from_numpy`; inputs are numpy from
a seed.  Also the flash-attention entry point at pixtral-12b's head dim
(160) and 144, whose plain version runs here.

Tolerances (both sides compute in f32 and differ only in the order of
their sums): logits 1e-4 absolute (tests/test_torch_lm.py's); the loss,
its total and each MoE metric rel 1e-5; gradients atol 1e-5 + rtol 1e-4
and the trainer's first loss rel 1e-5 (tests/test_torch_train.py's);
attention f32 2e-5 (tests/test_kernels.py:15).  Served tokens are equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.configs.base import reduced_config as jreduced_config
from repro.kernels.flash_attention import ref as jfa_ref
from repro.kernels.flash_attention.kernel import \
    flash_attention_bhsd as jflash_bhsd
from repro.models import lm as jlm
from repro.serve import engine as jengine
from repro_torch import _build
from repro_torch._tree import tree_flatten_with_path
from repro_torch.configs.base import ShapeSpec, get_config, reduced_config
from repro_torch.data.pipeline import DataConfig
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.models import lm
from repro_torch.serve import engine
from repro_torch.train import train_step as ts
from repro_torch.train.trainer import Trainer, TrainerConfig

ATOL = dict(rtol=0, atol=1e-4)
LOSS_RTOL = 1e-5
GRAD_TOL = dict(atol=1e-5, rtol=1e-4)
FA_TOL = dict(rtol=2e-5, atol=2e-5)
ARCHS = ["qwen2_moe_a2p7b", "llama4_scout_17b_a16e", "hubert_xlarge",
         "pixtral_12b"]
B, S, MAX_LEN, STEPS = 2, 32, 32, 16


def _np(x):
    return np.asarray(x.detach().float().numpy()
                      if isinstance(x, torch.Tensor) else x, np.float32)


def _batch(cfg, seed=4):
    """tokens/targets (B, S), frames (B, S, d_input_stub) for the encoder,
    patch_embeds (B, stub_seq, d_input_stub) for vlm."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
             "targets": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.family == "encoder":
        del batch["tokens"]
        batch["frames"] = rng.standard_normal(
            (B, S, cfg.d_input_stub)).astype(np.float32)
    if cfg.family == "vlm":
        batch["patch_embeds"] = rng.standard_normal(
            (B, cfg.stub_seq, cfg.d_input_stub)).astype(np.float32)
    return batch


@pytest.fixture(scope="module")
def cases():
    """Every config's (jcfg, cfg, jparams, params, batch), built once."""
    out = {}
    for arch in ARCHS:
        jcfg = jreduced_config(jget_config(arch))
        cfg = reduced_config(get_config(arch))
        jparams = jax.jit(lambda k: jlm.init_params(jcfg, k))(
            jax.random.PRNGKey(3))
        out[arch] = (jcfg, cfg, jparams, lm.params_from_numpy(
            jax.tree_util.tree_map(np.asarray, jparams), "cpu"),
            _batch(cfg))
    return out


def _inputs(batch):
    return {k: v for k, v in batch.items() if k != "targets"}


def test_reduced_configs_are_the_stated_ones():
    moe_q = reduced_config(get_config("qwen2_moe_a2p7b")).moe
    assert (moe_q.n_experts, moe_q.n_experts_padded, moe_q.top_k,
            moe_q.d_ff_shared, moe_q.shared_gated) == (8, 16, 2, 64, True)
    moe_l = reduced_config(get_config("llama4_scout_17b_a16e")).moe
    assert (moe_l.top_k, moe_l.d_ff_shared, moe_l.shared_gated) == \
        (1, 64, False)
    hub = reduced_config(get_config("hubert_xlarge"))
    assert (hub.d_input_stub, hub.causal) == (64, False)
    pix = reduced_config(get_config("pixtral_12b"))
    assert (pix.stub_seq, pix.d_input_stub) == (16, 64)
    assert get_config("pixtral_12b").head_dim == 160


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_params_has_the_jax_keys_shapes_and_dtypes(cases, arch, dtype):
    jcfg, cfg = cases[arch][:2]
    want = jax.tree_util.tree_map(
        lambda a: (tuple(a.shape), str(a.dtype)),
        jlm.abstract_params(jcfg, getattr(jnp, dtype)))
    got = lm._map(lambda t: (tuple(t.shape), str(t.dtype)[6:]),
                  lm.init_params(cfg, 0, getattr(torch, dtype),
                                 device="cpu"))
    assert got == want


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("impl", ["ref", "kernel"])
def test_prefill_matches_jax(cases, arch, impl):
    jcfg, cfg, jparams, params, batch = cases[arch]
    _build.reset_counters()
    got = lm.prefill(cfg, params, _inputs(batch), torch.float32, impl,
                     device="cpu")
    if impl == "kernel":   # one attention a layer, on the plain version
        assert dict(_build.PLAIN_CALLS) == {"flash_attention":
                                            cfg.n_layers}
    jimpl = "pallas" if impl == "kernel" else "ref"
    want = jax.jit(lambda p, b: jlm.prefill(
        jcfg, p, b, MAX_LEN, jnp.float32, jimpl))(
        jparams, {k: jnp.asarray(v) for k, v in _inputs(batch).items()})
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


@pytest.mark.parametrize("arch", ["qwen2_moe_a2p7b", "pixtral_12b"])
def test_decode_steps_match_jax_and_continue_a_jax_decode(arch):
    """qwen2-moe decodes through `moe_block` (gshard, capacity 1 a row);
    pixtral decodes text only."""
    jcfg = jreduced_config(jget_config(arch))
    cfg = reduced_config(get_config(arch))
    jparams = jax.jit(lambda k: jlm.init_params(jcfg, k))(
        jax.random.PRNGKey(5))
    params = lm.params_from_numpy(jax.tree_util.tree_map(np.asarray,
                                                         jparams), "cpu")
    tokens = _batch(cfg)["tokens"]
    jlog, _ = _jax_decode(jcfg, jparams,
                          jlm.init_caches(jcfg, B, MAX_LEN, jnp.float32),
                          tokens, 0, STEPS)
    caches = lm.init_caches(cfg, B, MAX_LEN, torch.float32, device="cpu")
    for pos in range(STEPS):
        lg, caches = lm.decode_step(cfg, params, caches,
                                    torch.tensor(tokens[:, pos:pos + 1]),
                                    pos, torch.float32)
        np.testing.assert_allclose(_np(lg), jlog[pos], **ATOL)
    half = STEPS // 2
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


def _jax_loss(jcfg, jparams, batch, moe_impl, grads=False):
    fn = jax.value_and_grad(
        lambda p: jlm.loss_fn(jcfg, p, batch, jnp.float32, "ref", "full",
                              moe_impl), has_aux=True) if grads else \
        (lambda p: jlm.loss_fn(jcfg, p, batch, jnp.float32, "ref", "none",
                               moe_impl))
    return jax.jit(fn)(jparams)


LOSS_CASES = [("qwen2_moe_a2p7b", "gshard"), ("qwen2_moe_a2p7b", "sorted"),
              ("llama4_scout_17b_a16e", "gshard"),
              ("llama4_scout_17b_a16e", "sorted"),
              ("hubert_xlarge", "gshard"), ("pixtral_12b", "gshard")]


@pytest.mark.parametrize("arch,moe_impl", LOSS_CASES)
def test_loss_and_metrics_match_jax(cases, arch, moe_impl):
    jcfg, cfg, jparams, params, batch = cases[arch]
    want, jm = _jax_loss(jcfg, jparams, batch, moe_impl)
    got, m = lm.loss_fn(cfg, params, batch, torch.float32, remat="none",
                        moe_impl=moe_impl)
    assert float(got) == pytest.approx(float(want), rel=LOSS_RTOL)
    assert sorted(m) == sorted(jm) == ["frac_dropped", "lb_loss", "loss",
                                       "z_loss"]
    for k in m:
        assert float(m[k]) == pytest.approx(float(jm[k]), rel=LOSS_RTOL), k
    assert float(got) == pytest.approx(
        float(m["loss"] + m["lb_loss"] + m["z_loss"]), rel=1e-7)
    if cfg.family == "moe":
        assert 0 < float(m["lb_loss"]) and 0 < float(m["z_loss"])
    else:
        assert float(m["lb_loss"]) == float(m["z_loss"]) == 0.0


@pytest.mark.parametrize("arch,moe_impl", [
    ("qwen2_moe_a2p7b", "gshard"), ("qwen2_moe_a2p7b", "sorted"),
    ("llama4_scout_17b_a16e", "gshard"), ("hubert_xlarge", "gshard"),
    ("pixtral_12b", "gshard")])
def test_loss_gradients_under_full_remat_match_jax(cases, arch, moe_impl):
    jcfg, cfg, jparams, params, batch = cases[arch]
    (want, _), jgrads = _jax_loss(jcfg, jparams, batch, moe_impl,
                                  grads=True)
    p = lm._map(lambda t: t.detach().requires_grad_(), params)
    loss, _ = lm.loss_fn(cfg, p, batch, torch.float32, remat="full",
                         moe_impl=moe_impl)
    flat = list(tree_flatten_with_path(p))
    # the encoder's GELU MLP leaves w_gate unused: its gradient is zero,
    # as `jax.grad` gives it (and as the train step fills it in)
    grads = [torch.zeros_like(t) if g is None else g for (_, t), g in zip(
        flat, torch.autograd.grad(loss, [t for _, t in flat],
                                  allow_unused=True))]
    assert float(loss.detach()) == pytest.approx(float(want), rel=LOSS_RTOL)
    jflat = {tuple(str(getattr(k, "key", k)) for k in path): np.asarray(v)
             for path, v in jax.tree_util.tree_flatten_with_path(jgrads)[0]}
    assert sorted(jflat) == sorted(path for path, _ in flat)
    for (path, _), g in zip(flat, grads):
        np.testing.assert_allclose(_np(g), jflat[path], err_msg=str(path),
                                   **GRAD_TOL)


def _serve_both(cases, arch, prompts, max_new, slots, max_len):
    jcfg, cfg, jparams, params, _ = cases[arch]
    jeng = jengine.ServeEngine(jcfg, jparams, batch_slots=slots,
                               max_len=max_len, dtype=jnp.float32)
    eng = engine.ServeEngine(cfg, params, batch_slots=slots,
                             max_len=max_len, dtype=torch.float32,
                             device="cpu")
    for rid, p in enumerate(prompts):
        jeng.submit(jengine.Request(rid=rid, prompt=p, max_new=max_new))
        eng.submit(engine.Request(rid=rid, prompt=p, max_new=max_new))
    return ({r.rid: r.out for r in eng.run_until_drained()},
            {r.rid: r.out for r in jeng.run_until_drained()})


@pytest.mark.parametrize("arch", ["qwen2_moe_a2p7b", "pixtral_12b"])
def test_serve_engine_returns_the_jax_tokens(cases, arch):
    """Three requests in two slots: two waves (qwen2-moe's MoE decode at
    capacity 1 a row; pixtral text-only)."""
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, 512, n).astype(np.int32) for n in (7, 3, 10)]
    done, jdone = _serve_both(cases, arch, prompts, max_new=4, slots=2,
                              max_len=20)
    assert done == jdone and sorted(done) == [0, 1, 2]
    assert all(len(v) == 4 for v in done.values())


@pytest.mark.parametrize("arch", ["hubert_xlarge", "pixtral_12b"])
def test_trainer_carries_frames_and_patches(tmp_path, arch):
    """Two steps on the CPU: finite losses, and the first equals the JAX
    loss of the trainer's own initial parameters on the step-0 batch as
    the JAX trainer forms it (frames and patches cast to bf16)."""
    cfg = reduced_config(get_config(arch))
    jcfg = jreduced_config(jget_config(arch))
    shape = ShapeSpec("smoke", seq_len=S + cfg.stub_seq, global_batch=4,
                      kind="train")
    tr = Trainer(cfg, shape, ts.TrainHyper(compute_dtype=torch.float32),
                 TrainerConfig(ckpt_dir=str(tmp_path), ckpt_every=10,
                               data=DataConfig(seed=3)), device="cpu")
    batch = tr._device_batch(0)
    stub = {"encoder": "frames", "vlm": "patch_embeds"}[cfg.family]
    assert batch[stub].dtype == torch.bfloat16
    state, start = tr.init_or_restore(seed=2)
    assert start == 0
    jparams = jax.tree_util.tree_map(
        jnp.asarray, lm._map(lambda t: t.numpy(), state.params))
    jbatch = {k: jnp.asarray(_np(v), jnp.bfloat16 if k == stub else None)
              if v.dtype == torch.bfloat16 else jnp.asarray(v.numpy())
              for k, v in batch.items()}
    want, _ = jax.jit(lambda p, b: jlm.loss_fn(jcfg, p, b, jnp.float32))(
        jparams, jbatch)
    log = tr.run(2, seed=2)
    assert [r["step"] for r in log] == [1, 2]
    assert all(np.isfinite(r["loss"]) for r in log)
    assert log[0]["loss"] == pytest.approx(float(want), rel=LOSS_RTOL)


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "pixtral-12b",
                                  "hubert-xlarge"])
def test_serve_cli_runs_the_new_families(capsys, arch):
    """Served on the CPU at --reduced; the encoder exits with the engine's
    error."""
    from repro_torch.launch import serve
    argv = ["--arch", arch, "--reduced", "--device", "cpu", "--requests",
            "2", "--max-new", "2"]
    if arch == "hubert-xlarge":
        with pytest.raises(SystemExit, match="supports_decode"):
            serve.main(argv)
        return
    serve.main(argv)
    assert "served 2 requests / 4 tokens" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "pixtral-12b",
                                  "hubert-xlarge"])
def test_train_cli_runs_the_new_families(tmp_path, capsys, arch):
    from repro_torch.launch import train
    log = train.main(["--arch", arch, "--reduced", "--device", "cpu",
                      "--steps", "2", "--seq", "32", "--batch", "4",
                      "--ckpt", str(tmp_path)])
    assert [r["step"] for r in log] == [1, 2]
    assert all(np.isfinite(r["loss"]) for r in log)
    assert "step 2 loss" in capsys.readouterr().out


@pytest.mark.parametrize("D", [144, 160])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_at_head_dims_144_and_160(D, causal):
    """The entry point's plain version (what runs on CPU tensors) at
    pixtral-12b's head dim and the one below it, GQA 4: against the JAX
    reference and the Pallas kernel in interpret mode at S = 128, and
    against the reference at a ragged S."""
    rng = np.random.default_rng(D + causal)
    for Sq, pallas in ((128, True), (77, False)):
        arrs = [rng.standard_normal((1, h, Sq, D), np.float32)
                for h in (8, 2, 2)]
        q, k, v = (torch.tensor(a) for a in arrs)
        jq, jk, jv = (jnp.asarray(a) for a in arrs)
        n0 = _build.PLAIN_CALLS["flash_attention"]
        got = fa_kernel.flash_attention_bhsd(q, k, v, causal=causal)
        assert _build.PLAIN_CALLS["flash_attention"] == n0 + 1
        np.testing.assert_allclose(
            _np(got), np.asarray(jfa_ref.attention_ref(jq, jk, jv, causal)),
            **FA_TOL)
        if pallas:
            np.testing.assert_allclose(
                _np(got), np.asarray(jflash_bhsd(jq, jk, jv, causal=causal,
                                                 interpret=True)), **FA_TOL)
        # the CUDA path's checks take the shape too (the kernel caps no
        # head dim)
        fa_kernel.check_args(q.shape, k.shape, v.shape, (q.dtype,) * 3)
