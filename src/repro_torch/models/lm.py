"""Language-model assembly for every family of the JAX package: the port
of `repro.models.lm` (training loss, prefill and decode).

Families:
  dense    GQA transformer (qwen2.5-14b, yi-6b, qwen1.5-4b/0.5b)
  moe      GQA transformer with MoE FFNs (qwen2-moe, llama4-scout;
           `models.moe`, auxiliary losses summed over the layers)
  ssm      attention-free Mamba2/SSD stack (mamba2-2.7b)
  hybrid   Mamba2 stack with a shared attention+MLP block applied before
           every `hybrid_every` layers, alternating `n_shared_blocks`
           parameter sets (zamba2-2.7b)
  encoder  bidirectional encoder over precomputed frame embeddings
           (hubert-xlarge; GELU MLP, no token table, no decode)
  vlm      decoder LM with precomputed image-patch embeddings prepended
           (pixtral-12b; decode is text-only)

Parameters are nested dicts of tensors with a leading stacked `layers`
axis, key for key the JAX package's pytree, so `params_from_numpy` carries
JAX weights across unchanged; Python loops over that axis replace
`lax.scan`.  ``impl`` picks the full-sequence backends: ``"kernel"`` (the
hand-written CUDA flash-attention and SSD kernels; the JAX package's
``"pallas"``) or ``"ref"`` (`chunked_attention`, `ssd_chunked_ref`).  The
kernels have no backward (nor do the JAX package's), so training runs
``impl="ref"``, differentiated by autograd; a kernel given an input that
requires grad raises.  ``remat`` checkpoints the same units as the JAX
`scan` body (a layer; a hybrid group) with `torch.utils.checkpoint`.
``moe_impl`` picks the MoE dispatch (``"gshard"`` or ``"sorted"``, the
same function).
"""

from __future__ import annotations

from typing import Dict

import functools

import numpy as np
import torch
from torch.utils import checkpoint as ckpt_util

import repro_torch
from repro_torch._tree import tree_map as _map
from repro_torch.configs.base import ArchConfig
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.sharding import shard_hint
from repro_torch.models import attention as attn
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as m2
from repro_torch.models import moe as moe_mod
from repro_torch.models.attention import AttnConfig
from repro_torch.models.mamba2 import MambaConfig
from repro_torch.models.moe import MoeConfig

__all__ = ["attn_config", "moe_config", "mamba_config", "init_params",
           "abstract_params", "mask_vocab_pad", "backbone", "embed_inputs", "init_caches",
           "decode_step", "prefill", "loss_fn", "params_from_numpy",
           "caches_from_numpy"]

_FAMILIES = ("dense", "moe", "ssm", "hybrid", "encoder", "vlm")
# families built of attention + MLP (or MoE) layers with a KV cache
_ATTN_FAMILIES = ("dense", "moe", "encoder", "vlm")


def _check_family(cfg: ArchConfig) -> None:
    if cfg.family not in _FAMILIES:
        raise ValueError(f"family {cfg.family!r} ({cfg.name}): expected "
                         f"one of {', '.join(_FAMILIES)}")


# -- config adapters -----------------------------------------------------------

def attn_config(cfg: ArchConfig) -> AttnConfig:
    return AttnConfig(
        d_model=cfg.d_model,
        n_heads=cfg.n_heads_padded,
        n_kv_heads=cfg.n_kv_heads_eff,
        head_dim=cfg.head_dim,
        qkv_bias=cfg.qkv_bias,
        causal=cfg.causal,
        rope_theta=cfg.rope_theta,
    )


def moe_config(cfg: ArchConfig) -> MoeConfig:
    m = cfg.moe
    return MoeConfig(
        d_model=cfg.d_model, n_experts=m.n_experts_padded,
        n_experts_real=m.n_experts, top_k=m.top_k,
        d_ff_expert=m.d_ff_expert, d_ff_shared=m.d_ff_shared,
        shared_gated=m.shared_gated, capacity_factor=m.capacity_factor,
        group_size=m.group_size)


def mamba_config(cfg: ArchConfig) -> MambaConfig:
    s = cfg.ssm
    return MambaConfig(d_model=cfg.d_model, d_state=s.d_state,
                       head_dim=s.head_dim, expand=s.expand,
                       d_conv=s.d_conv, chunk=s.chunk)


# -- pytree helpers -------------------------------------------------------------

def _stack_init(n: int, make):
    """``n`` trees from ``make()``, in order, stacked along a new leading
    axis: each is copied into its slot and dropped, so the memory used is
    the stack and one tree (a full-width MoE stack would not fit twice)."""
    first = make()
    out = _map(lambda a: a.new_empty((n,) + tuple(a.shape)), first)
    _map(lambda o, a: o[0].copy_(a), out, first)
    del first
    for i in range(1, n):
        _map(lambda o, a: o[i].copy_(a), out, make())
    return out


def _index(tree, i: int):
    """Layer ``i`` of a stacked tree (views, no copies)."""
    return _map(lambda a: a[i], tree)


def _unstack(tree, n: int):
    """The ``n`` layers of a stacked tree, as views (one `unbind` per leaf,
    whose backward stacks the layers' gradients in one pass)."""
    flat = _map(torch.unbind, tree)
    return [_map(lambda parts: parts[i], flat) for i in range(n)]


def _tensor(a, device, dtype=None) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":     # ml_dtypes' bfloat16 (JAX arrays)
        t = torch.from_numpy(a.view(np.uint16).astype(np.int16)).view(
            torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))
    return t.to(device=device, dtype=dtype or t.dtype)


def params_from_numpy(tree, device, dtype=None):
    """The JAX parameter pytree, as nested dicts of numpy arrays (e.g.
    ``jax.tree_util.tree_map(np.asarray, params)``), as the port's dict of
    tensors on ``device`` (in ``dtype`` where given, else each array's
    own: the MoE router and shared gate stay f32 beside bf16 weights)."""
    dev = repro_torch.resolve_device(device)
    return _map(lambda a: _tensor(a, dev, dtype), tree)


def caches_from_numpy(tree, device):
    """A JAX decode-cache pytree (numpy leaves) as the port's caches on
    ``device``, dtypes kept, so a JAX decode can be continued here."""
    dev = repro_torch.resolve_device(device)
    return _map(lambda a: _tensor(a, dev), tree)


# -- init -----------------------------------------------------------------------

def _init_layer(cfg: ArchConfig, gen: torch.Generator, dtype):
    d = cfg.d_model
    if cfg.family in _ATTN_FAMILIES:
        p = {"norm_attn": L.init_rms_norm(d, dtype, gen.device),
             "norm_mlp": L.init_rms_norm(d, dtype, gen.device),
             "attn": attn.init_attention(gen, attn_config(cfg), dtype)}
        if cfg.family == "moe":
            p["moe"] = moe_mod.init_moe(gen, moe_config(cfg), dtype)
        else:
            p["mlp"] = L.init_mlp(gen, d, cfg.d_ff, dtype)
        return p
    return {"norm_attn": L.init_rms_norm(d, dtype, gen.device),
            "ssm": m2.init_mamba(gen, mamba_config(cfg), dtype)}


def init_params(cfg: ArchConfig, gen, dtype=torch.float32, device=None):
    """Random parameters with the JAX pytree's keys, shapes and dtypes.
    ``gen`` is a ``torch.Generator`` on ``device`` or an int seed for one;
    ``device`` None means the CUDA card."""
    _check_family(cfg)
    dev = repro_torch.resolve_device(device)
    if isinstance(gen, int):
        gen = torch.Generator(device=dev).manual_seed(gen)
    if gen.device.type != dev.type:
        raise ValueError(f"init_params: generator on {gen.device}, "
                         f"parameters on {dev}")
    return _make_params(cfg, gen, dtype)


def abstract_params(cfg: ArchConfig, dtype=torch.float32):
    """The parameter tree of :func:`init_params` as "meta" tensors: the
    same keys, shapes and dtypes, built without a generator and without
    allocating (`repro.models.lm.abstract_params`, ``jax.eval_shape``)."""
    _check_family(cfg)
    return _make_params(cfg, L.SHAPE_ONLY, dtype)


def _make_params(cfg: ArchConfig, gen, dtype):
    """The parameter tree, drawn from ``gen`` on its device (or shapes
    only, for ``L.SHAPE_ONLY``)."""
    dev = gen.device
    stub = cfg.d_input_stub
    if cfg.family == "encoder":   # frames in, no token table
        params: Dict = {"embed": {"proj": L._normal(
            gen, (stub, cfg.d_model), dtype) * stub ** -0.5}}
    else:
        params = {"embed": L.init_embed(gen, cfg.vocab_padded, cfg.d_model,
                                        dtype)}
        if cfg.family == "vlm":   # image patches in beside the tokens
            params["embed"]["proj"] = L._normal(
                gen, (stub, cfg.d_model), dtype) * stub ** -0.5
    params["layers"] = _stack_init(cfg.n_layers,
                                   lambda: _init_layer(cfg, gen, dtype))
    if cfg.hybrid_every:
        params["shared_blocks"] = _stack_init(cfg.n_shared_blocks, lambda: {
            "attn": attn.init_attention(gen, attn_config(cfg), dtype),
            "mlp": L.init_mlp(gen, cfg.d_model, cfg.d_ff, dtype),
            "norm_attn": L.init_rms_norm(cfg.d_model, dtype, dev),
            "norm_mlp": L.init_rms_norm(cfg.d_model, dtype, dev)})
    params["final_norm"] = L.init_rms_norm(cfg.d_model, dtype, dev)
    params["head"] = L.init_unembed(gen, cfg.d_model, cfg.vocab_padded,
                                    dtype)
    return params


def mask_vocab_pad(cfg: ArchConfig, logits: torch.Tensor) -> torch.Tensor:
    """Padded vocab entries must not leak probability mass."""
    if cfg.vocab_padded == cfg.vocab:
        return logits
    keep = torch.arange(cfg.vocab_padded, device=logits.device) < cfg.vocab
    return torch.where(keep, logits, -1e30)


# -- forward blocks ---------------------------------------------------------------

def _whole_seq(h):
    """``h`` (B, S, D) with its sequence gathered where a DTensor's is
    split (Megatron-SP's all-gather into a tensor-parallel region), as
    GSPMD inserts it: torch 2.11's DTensor refuses the flatten a matmul
    makes of an activation sharded along its sequence (``aten.view``).
    Anything else as it is."""
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(h, DTensor) or not any(p.is_shard(1)
                                             for p in h.placements):
        return h
    return h.redistribute(h.device_mesh, [Replicate() if p.is_shard(1) else p
                                          for p in h.placements])


def _like_residual(out, x):
    """A tensor-parallel region's output ``out`` placed like the residual
    ``x`` where ``x``'s sequence is split (Megatron-SP's reduce-scatter
    out of the region, the pair of `_whole_seq`'s all-gather); anything
    else as it is."""
    from torch.distributed.tensor import DTensor
    if not (isinstance(out, DTensor) and isinstance(x, DTensor)
            and any(p.is_shard(1) for p in x.placements)):
        return out
    return out.redistribute(x.device_mesh, x.placements)


def _transformer_layer(cfg, p, x, positions, compute_dtype, impl,
                       moe_impl="gshard"):
    """Attention + MLP (SwiGLU; GELU for the encoder) or MoE.  Returns
    (x, the MoE aux losses or None)."""
    # Megatron-SP: residuals and norms run sequence-sharded when the rules
    # map "seq_act" to "model" (a no-op otherwise)
    x = _resid(x)
    h = _whole_seq(L.rms_norm(x, p["norm_attn"]))
    x = x + _like_residual(attn.attention_train(
        p["attn"], attn_config(cfg), h, positions, compute_dtype, impl), x)
    x = _resid(x)
    h = _whole_seq(L.rms_norm(x, p["norm_mlp"]))
    if cfg.family == "moe":
        out, aux = moe_mod.moe_block(p["moe"], moe_config(cfg), h,
                                     compute_dtype, impl=moe_impl)
        return x + _like_residual(out, x), aux
    if cfg.family == "encoder":
        return x + _like_residual(L.mlp_gelu(p["mlp"], h, compute_dtype),
                                  x), None
    return x + _like_residual(L.mlp_swiglu(p["mlp"], h, compute_dtype),
                              x), None


def _resid(x):
    """The residual stream's hint (a no-op off a mesh): a pending sum
    left by a tensor-parallel output projection is reduced here, once,
    where GSPMD reduces it.  Left pending, DTensor reduces a copy for
    each norm's mean square and carries the sum on into the next
    products, whose model-split weights it then gathers to meet it."""
    return shard_hint(x, "batch", "seq_act", "embed_act")


def _mamba_layer(cfg, p, x, compute_dtype, impl):
    x = _resid(x)
    h = _whole_seq(L.rms_norm(x, p["norm_attn"]))
    return x + _like_residual(m2.mamba_block(
        p["ssm"], mamba_config(cfg), h, compute_dtype, impl), x)


# matrix products whose outputs "dots" keeps (jax's checkpoint_dots)
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default, torch.ops.aten.baddbmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return (ckpt_util.CheckpointPolicy.MUST_SAVE if op in _DOTS
            else ckpt_util.CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(fn, policy: str):
    """``"none"`` keeps every activation; ``"full"`` keeps the unit's
    inputs and recomputes the rest in the backward; ``"dots"`` also keeps
    the matrix products' outputs.  All three give the same gradients.
    The recompute runs under the forward's mesh rules
    (`shd.bind_mesh_rules`)."""
    if policy == "none":
        return fn
    fn = shd.bind_mesh_rules(fn)
    if policy == "full":
        return functools.partial(ckpt_util.checkpoint, fn,
                                 use_reentrant=False)
    if policy == "dots":
        return functools.partial(
            ckpt_util.checkpoint, fn, use_reentrant=False,
            context_fn=functools.partial(
                ckpt_util.create_selective_checkpoint_contexts,
                _dots_policy))
    raise ValueError(f"remat {policy!r}: expected 'none', 'dots' or 'full'")


def backbone(cfg: ArchConfig, params, x: torch.Tensor,
             positions: torch.Tensor, compute_dtype=torch.bfloat16,
             impl: str = "kernel", remat: str = "full",
             moe_impl: str = "gshard"):
    """Layer stack -> final norm.  x: (B,S,d) embeddings.  Returns (x, aux):
    the MoE aux losses (``lb_loss``, ``z_loss``, ``frac_dropped``) summed
    over the layers and divided by ``n_layers``, f32 zeros for families
    without experts, as the JAX function.  ``remat`` applies per layer
    (dense, moe, encoder, vlm, ssm) or per group of a shared block and its
    Mamba2 layers (hybrid), as the JAX scan."""
    _check_family(cfg)
    layers = _unstack(params["layers"], cfg.n_layers)
    aux = {k: torch.zeros((), dtype=torch.float32, device=x.device)
           for k in ("lb_loss", "z_loss", "frac_dropped")}
    if cfg.family in _ATTN_FAMILIES:
        body = _remat(functools.partial(_transformer_layer, cfg), remat)
        for lp in layers:
            x, a = body(lp, x, positions, compute_dtype, impl, moe_impl)
            if a is not None:
                aux = {k: aux[k] + a[k] for k in aux}
    elif cfg.family == "ssm":
        body = _remat(functools.partial(_mamba_layer, cfg), remat)
        for lp in layers:
            x = body(lp, x, compute_dtype, impl)
    else:   # hybrid: the shared block first, then `every` Mamba2 layers
        every = cfg.hybrid_every
        shared = _unstack(params["shared_blocks"], cfg.n_shared_blocks)

        def group(sp, glayers, h):
            h, _ = _transformer_layer(cfg, sp, h, positions, compute_dtype,
                                      impl)
            for lp in glayers:
                h = _mamba_layer(cfg, lp, h, compute_dtype, impl)
            return h

        body = _remat(group, remat)
        for gi in range(cfg.n_layers // every):
            x = body(shared[gi % cfg.n_shared_blocks],
                     layers[gi * every:(gi + 1) * every], x)
    n = max(1, cfg.n_layers)
    return (L.rms_norm(_resid(x), params["final_norm"]),
            {k: v / n for k, v in aux.items()})


def _inputs(cfg: ArchConfig, batch, dev, loss: bool = False):
    """The batch entries ``cfg``'s family reads (``tokens``, ``frames``
    or ``patch_embeds``, and ``targets`` for the loss), as tensors on
    ``dev``; tensors or numpy may be given."""
    keys = {"encoder": ("frames",), "vlm": ("tokens", "patch_embeds")}.get(
        cfg.family, ("tokens",)) + (("targets",) if loss else ())
    missing = [k for k in keys if k not in batch]
    if missing:
        raise KeyError(f"{cfg.name} ({cfg.family}) batch lacks {missing}")
    return {k: torch.as_tensor(batch[k], device=dev) for k in keys}


def embed_inputs(cfg: ArchConfig, params, batch,
                 compute_dtype=torch.bfloat16):
    """Returns (x, positions, loss_mask).  ``batch`` holds tensors on the
    parameters' device: ``tokens`` (B,S); ``frames`` (B,S,d_input_stub)
    for the encoder; ``patch_embeds`` (B,stub_seq,d_input_stub) beside
    the tokens for vlm, whose image rows come first, share the positions
    counted from 0 with the text rows and carry no loss."""
    n_img = 0
    if cfg.family == "encoder":
        x = L.cast(batch["frames"], compute_dtype) @ L.cast(
            params["embed"]["proj"], compute_dtype)
    elif cfg.family == "vlm":
        img = L.cast(batch["patch_embeds"], compute_dtype) @ L.cast(
            params["embed"]["proj"], compute_dtype)
        txt = L.embed_tokens(params["embed"], batch["tokens"], compute_dtype)
        x = torch.cat([img, txt], dim=1)
        n_img = img.shape[1]
    else:
        x = L.embed_tokens(params["embed"], batch["tokens"], compute_dtype)
    B, S = x.shape[:2]
    positions = torch.arange(S, device=x.device).expand(B, S)
    mask = torch.ones((B, S), dtype=torch.float32, device=x.device)
    mask[:, :n_img] = 0.0
    return x, positions, mask


# -- serving: prefill + decode ------------------------------------------------------

def _on(params, device) -> torch.device:
    """Resolve ``device`` (None = the card) and require the parameters to
    live there."""
    dev = repro_torch.resolve_device(device)
    have = params["final_norm"].device
    if have.type != dev.type:
        raise ValueError(f"parameters are on {have}, the run asks for {dev}")
    return have


def _refuse_decode(cfg: ArchConfig) -> None:
    """The encoder has no decode: raise ``ValueError`` naming
    ``supports_decode``."""
    if not cfg.supports_decode:
        raise ValueError(f"decode unsupported for family {cfg.family} "
                         f"({cfg.name}: supports_decode is False)")


def init_caches(cfg: ArchConfig, batch: int, max_len: int,
                dtype=torch.bfloat16, device=None):
    """Decode caches: KV caches in ``dtype`` (per layer for dense, moe and
    vlm; per group for the hybrid's shared attention), Mamba2 caches in
    f32 per layer; none for the encoder, which has no decode."""
    _check_family(cfg)
    dev = repro_torch.resolve_device(device)

    def stacked(n, tree):
        return _map(lambda a: a[None].expand((n,) + a.shape).clone(), tree)

    caches: Dict = {}
    if cfg.family in ("ssm", "hybrid"):
        caches["ssm"] = stacked(cfg.n_layers, m2.init_mamba_cache(
            batch, mamba_config(cfg), device=dev))
    if cfg.family in ("dense", "moe", "vlm", "hybrid"):
        kv = attn.init_kv_cache(batch, max_len, attn_config(cfg), dtype, dev)
        key, n = (("shared_attn", cfg.n_layers // cfg.hybrid_every)
                  if cfg.family == "hybrid" else ("attn", cfg.n_layers))
        caches[key] = stacked(n, kv)
    return caches


def _decode_block(cfg, p, h, cache, pos, compute_dtype, cache_update):
    """Attention + MLP (or MoE, gshard) on one token: a layer or a shared
    block, its k/v written into ``cache`` in place."""
    h = _resid(h)
    hh = L.rms_norm(h, p["norm_attn"])
    out, _ = attn.attention_decode(p["attn"], attn_config(cfg), hh, cache,
                                   pos, compute_dtype, cache_update,
                                   donate=True)
    h = _resid(h + out)
    hh = L.rms_norm(h, p["norm_mlp"])
    if "moe" in p:
        o, _ = moe_mod.moe_block(p["moe"], moe_config(cfg), hh,
                                 compute_dtype)
        return h + o
    return h + L.mlp_swiglu(p["mlp"], hh, compute_dtype)


def _put(dst, src) -> None:
    """``src`` written into ``dst`` in place; on DTensors into this
    rank's block of ``dst``, ``src`` placed like it first."""
    from torch.distributed.tensor import DTensor
    if isinstance(dst, DTensor):
        if list(src.placements) != list(dst.placements):
            src = src.redistribute(dst.device_mesh, dst.placements)
        dst, src = dst.to_local(), src.to_local()
    dst.copy_(src)


def _decode_mamba(cfg, p, h, cache, compute_dtype):
    """A Mamba2 layer on one token, its conv and SSM states written into
    ``cache`` in place."""
    h = _resid(h)
    hn = L.rms_norm(h, p["norm_attn"])
    out, new = m2.mamba_decode_step(p["ssm"], mamba_config(cfg), hn, cache,
                                    compute_dtype)
    attn._no_grad_write(new["ssm"])
    _put(cache["conv"], new["conv"])
    _put(cache["ssm"], new["ssm"])
    return h + out


def decode_step(cfg: ArchConfig, params, caches, tokens: torch.Tensor,
                pos: int, compute_dtype=torch.bfloat16,
                cache_update: str = "dus", donate: bool = False):
    """One-token decode.  tokens: (B,1); pos: int position.  Returns
    (logits (B,1,V) f32, new caches).  ``donate`` False (the default,
    JAX's un-donated ``jax.jit``): the given caches are not modified;
    each cache leaf is copied once, and each layer writes its slice of
    the copy in place.  ``donate`` True (`train_step.jit_decode_step`'s
    step, JAX's ``donate_argnums``): each layer writes its slice of the
    given caches in place (on DTensors, each rank its own block), and
    the given caches are returned.  Either way one cache-sized tensor
    at most is allocated a leaf, as JAX's scan carry holds one.  The
    writes are not differentiable (`attention.attention_decode`).
    Decode runs no kernel (the JAX function's ``impl`` is unused there
    too).  vlm decodes text only; the encoder raises ``ValueError``."""
    _check_family(cfg)
    _refuse_decode(cfg)
    if not donate:
        caches = _map(torch.clone, caches)
    x = L.embed_tokens(params["embed"], tokens, compute_dtype)
    layers = params["layers"]
    if cfg.family in _ATTN_FAMILIES:
        for i in range(cfg.n_layers):
            x = _decode_block(cfg, _index(layers, i), x,
                              _index(caches["attn"], i), pos, compute_dtype,
                              cache_update)
    else:
        every = cfg.hybrid_every if cfg.family == "hybrid" else cfg.n_layers
        for gi in range(cfg.n_layers // every):
            if cfg.family == "hybrid":
                sp = _index(params["shared_blocks"],
                            gi % cfg.n_shared_blocks)
                x = _decode_block(cfg, sp, x,
                                  _index(caches["shared_attn"], gi), pos,
                                  compute_dtype, cache_update)
            for j in range(every):
                i = gi * every + j
                x = _decode_mamba(cfg, _index(layers, i), x,
                                  _index(caches["ssm"], i), compute_dtype)
    x = L.rms_norm(_resid(x), params["final_norm"])
    logits = mask_vocab_pad(
        cfg, L.unembed_logits(params["head"], x, compute_dtype))
    return logits, caches


def prefill(cfg: ArchConfig, params, batch, compute_dtype=torch.bfloat16,
            impl: str = "kernel", device=None):
    """Full-sequence prefill: last-position logits (B,1,V) f32 of the
    family's batch: ``tokens`` (B,S), ``frames`` (encoder) or
    ``patch_embeds`` beside the tokens (vlm), tensors or numpy, moved to
    the parameters' device.  With ``impl="kernel"`` every attention runs
    the CUDA flash-attention kernel and every Mamba2 layer the CUDA SSD
    kernel.  Like the JAX function it returns no caches (the JAX
    signature's ``max_len`` and ``cache_dtype`` are unused there and
    dropped here).  ``device`` None means the card; the parameters must be
    there."""
    dev = _on(params, device)
    x, positions, _ = embed_inputs(cfg, params, _inputs(cfg, batch, dev),
                                   compute_dtype)
    x, _ = backbone(cfg, params, x, positions, compute_dtype, impl,
                    remat="none")
    return mask_vocab_pad(
        cfg, L.unembed_logits(params["head"], x[:, -1:], compute_dtype))


# -- training forward ------------------------------------------------------------------

def _vocab_split(logits) -> bool:
    """Whether DTensor ``logits`` has its last (vocab) dim split over a
    mesh dim of more than one rank."""
    from torch.distributed.tensor import DTensor
    return isinstance(logits, DTensor) and any(
        p.is_shard(logits.ndim - 1) and logits.device_mesh.size(m) > 1
        for m, p in enumerate(logits.placements))


def _logsumexp_vocab(logits):
    """``logsumexp`` over the last (vocab) dim.  Where the vocab dim is
    split (`_vocab_split`), vocab-parallel: each rank takes the
    ``logsumexp`` of its own block (`shd.on_blocks`), the ranks' results
    lie side by side along the last dim, one entry a rank, and their
    ``logsumexp`` is the whole one.  DTensor's ``aten.logsumexp`` rule
    on the logits gathers them whole on every rank, and its backward
    with them; here it gathers one entry a rank."""
    if not _vocab_split(logits):
        return torch.logsumexp(logits, dim=-1)
    lpl = list(logits.placements)
    parts = shd.on_blocks(lambda lg: torch.logsumexp(lg, -1, keepdim=True),
                          (lpl,), lpl, logits)
    return torch.logsumexp(parts, dim=-1)


def _target_logits(logits, targets):
    """``logits[..., targets]``, (B, S).  Where the vocab dim is split
    (`_vocab_split`), each rank picks the targets in its own vocab block
    and gives zeros for the rest, and the ranks' picks sum (``Partial``,
    then reduced): the backward of DTensor's ``aten.gather`` allocates
    ``new_zeros`` of the whole logits on every rank (on qwen2.5-14b's
    train_4k microbatch, (32, 4096, 152064) in f32: 74 GiB a rank)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    if not _vocab_split(logits):
        tgt = shd.reduce_partial(torch.gather(logits, -1, targets[..., None]))
        return tgt[..., 0]
    v = logits.ndim - 1
    lpl = list(logits.placements)
    tpl = [p if isinstance(p, Shard) and p.dim < v else Replicate()
           for p in lpl]
    opl = [Partial() if p.is_shard(v) else t for p, t in zip(lpl, tpl)]
    off = shd.block_offset(lpl, logits.device_mesh, v, logits.shape[v])

    def local(lg, t):
        idx = t.long() - off
        hit = (idx >= 0) & (idx < lg.shape[-1])
        pick = torch.gather(lg, -1, idx.clamp(0, lg.shape[-1] - 1)[..., None])
        return torch.where(hit, pick[..., 0], torch.zeros_like(pick[..., 0]))

    return shd.reduce_partial(shd.on_blocks(local, (lpl, tpl), opl, logits,
                                            targets))


def loss_fn(cfg: ArchConfig, params, batch, compute_dtype=torch.bfloat16,
            impl: str = "ref", remat: str = "full",
            moe_impl: str = "gshard"):
    """Masked next-token (or per-frame) cross-entropy plus the MoE aux
    losses: returns (total, metrics), total = ``loss + lb_loss + z_loss``
    and metrics ``loss``, ``lb_loss``, ``z_loss`` and ``frac_dropped``, as
    the JAX function.  ``batch`` holds the family's inputs (see
    `prefill`) and ``targets`` (B,S), tensors on the parameters' device or
    numpy; for vlm the targets cover the text rows and are padded over the
    image rows, which the mask leaves out.  Logits are f32 and the padded
    vocab entries are masked before the log-sum-exp.  Families without
    experts carry the aux losses as zeros.  ``moe_impl`` is ``"gshard"``
    or ``"sorted"``; anything else raises ``ValueError``."""
    _check_family(cfg)
    if moe_impl not in moe_mod._IMPLS:
        raise ValueError(f"moe_impl {moe_impl!r}: expected one of "
                         f"{moe_mod._IMPLS}")
    dev = params["final_norm"].device
    inputs = _inputs(cfg, batch, dev, loss=True)
    x, positions, mask = embed_inputs(cfg, params, inputs, compute_dtype)
    x, aux = backbone(cfg, params, x, positions, compute_dtype, impl, remat,
                      moe_impl)
    logits = mask_vocab_pad(
        cfg, L.unembed_logits(params["head"], _whole_seq(x),
                              compute_dtype))   # f32
    targets = inputs["targets"].long()
    if cfg.family == "vlm":   # only text positions carry loss
        targets = torch.cat([targets.new_zeros(
            (targets.shape[0], cfg.stub_seq)), targets], dim=1)
    lse = _logsumexp_vocab(logits)
    tgt = _target_logits(logits, targets)
    nll = (lse - tgt) * mask
    loss = nll.sum() / torch.clamp(mask.sum(), min=1.0)
    total = loss + aux["lb_loss"] + aux["z_loss"]
    return total, {"loss": loss, **aux}
