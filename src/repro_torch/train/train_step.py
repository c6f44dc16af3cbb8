"""The train step on one device: mixed precision, remat, gradient
accumulation over microbatches, cross-pod gradient compression, AdamW.
The port of `repro.train.train_step` without the mesh.

`build_train_step(cfg, hyper)` returns ``step_fn(state, batch) -> (state,
metrics)``.  Gradients come from `torch.autograd` through `lm.loss_fn`
(with ``hyper.impl`` "ref": the kernels have no backward); microbatches
run one after another and their f32 gradients are summed, then averaged,
as the JAX `_accum_loop` scan does.  The step is functional like the JAX
one: it returns a new state and leaves the given one as it was.

The rule functions of the JAX module's mesh half are here: `arch_rules`,
`batch_specs` (specs as tuples, the contents of JAX's ``PartitionSpec``),
`state_shardings` and `cache_shardings` (DTensor placement trees,
`distributed.sharding`).  The steps that run on a mesh (`jit_train_step`,
`jit_decode_step`, `jit_prefill`) and the ``sequence_parallel`` knob
wait for the sharded-step slice (ROADMAP.md).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

import repro_torch
from repro_torch._tree import (tree_leaves, tree_map, tree_map_with_path,
                               tree_unflatten_like)
from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.distributed import sharding as shd
from repro_torch.models import lm
from repro_torch.optim import adamw, grad_compress

__all__ = ["TrainHyper", "TrainState", "arch_rules", "batch_specs",
           "state_shardings", "make_train_state", "abstract_train_state",
           "build_train_step", "train_state_from_numpy", "cache_shardings"]


@dataclasses.dataclass(frozen=True)
class TrainHyper:
    adamw: adamw.AdamWConfig = dataclasses.field(
        default_factory=adamw.AdamWConfig)
    microbatches: int = 1
    remat: str = "full"           # "none" | "dots" | "full"
    compute_dtype: Any = torch.bfloat16
    compress_cross_pod: bool = False
    impl: str = "ref"             # kernel backend ("kernel" has no backward)
    cast_params_once: bool = False   # cast f32 matrices to compute_dtype
                                     # once per step, before the layers
    moe_impl: str = "gshard"


class TrainState(NamedTuple):
    params: Any
    opt: adamw.AdamWState
    ef: Any                        # error-feedback buffers (or None)


def arch_rules(cfg: ArchConfig,
               shape: Optional[ShapeSpec] = None,
               mesh=None) -> Dict[str, Optional[object]]:
    """`shd.DEFAULT_RULES` with the arch's overrides; given a shape and a
    mesh whose batch dims do not divide its batch, the batch unsharded and
    the KV cache sharded along its sequence over "data"."""
    rules = dict(shd.DEFAULT_RULES)
    rules.update(cfg.sharding_overrides)
    if shape is not None and mesh is not None:
        # batch too small for the data axes (long_500k: batch=1): leave the
        # batch unsharded and shard the KV-cache/sequence over "data"
        sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
        dp = 1
        bmap = rules.get("batch")
        for ax in (bmap if isinstance(bmap, tuple) else (bmap,)):
            if ax in sizes:
                dp *= sizes[ax]
        if shape.global_batch % max(dp, 1) != 0:
            rules["batch"] = None
            rules["cache_seq"] = "data"
    return rules


def batch_specs(cfg: ArchConfig, mesh, kind: str,
                shape: Optional[ShapeSpec] = None) -> Dict[str, Tuple]:
    """The spec of each input of a ``kind`` step ("train", "prefill",
    "decode"): the batch dim over the batch rule's mesh dims."""
    rules = arch_rules(cfg, shape, mesh)
    bspec = shd.resolve(rules, mesh, "batch")
    b = bspec[0] if len(bspec) else None
    specs: Dict[str, Tuple] = {}
    if cfg.family == "encoder":
        specs["frames"] = (b, None, None)
    else:
        specs["tokens"] = (b, None)
    if kind == "train":
        specs["targets"] = (b, None)
    if cfg.family == "vlm":
        specs["patch_embeds"] = (b, None, None)
    if kind == "decode":
        specs = {"tokens": (b, None), "pos": ()}
    return specs


def state_shardings(cfg: ArchConfig, mesh, abstract_state: TrainState):
    """The train state's placement tree: parameters, moments and error
    buffers by their paths, the step replicated."""
    rules = arch_rules(cfg)
    pshard = shd.param_sharding(abstract_state.params, mesh, rules)
    oshard = adamw.AdamWState(
        step=shd.placements((), mesh),
        mu=shd.param_sharding(abstract_state.opt.mu, mesh, rules),
        nu=shd.param_sharding(abstract_state.opt.nu, mesh, rules))
    efshard = (shd.param_sharding(abstract_state.ef, mesh, rules)
               if abstract_state.ef is not None else None)
    return TrainState(params=pshard, opt=oshard, ef=efshard)


def make_train_state(cfg: ArchConfig, hyper: TrainHyper, gen,
                     device=None) -> TrainState:
    """Fresh parameters from ``gen`` (a ``torch.Generator`` on ``device``
    or an int seed), zero moments, zero error buffers where compression is
    on.  ``device`` None means the card."""
    params = lm.init_params(cfg, gen, device=device)
    return TrainState(params=params, opt=adamw.init_state(params),
                      ef=(grad_compress.init_error_state(params)
                          if hyper.compress_cross_pod else None))


def abstract_train_state(cfg: ArchConfig, hyper: TrainHyper,
                         device=None) -> TrainState:
    """The state's structure, shapes and dtypes as "meta" tensors (the
    target of `checkpoint.ckpt.restore`), built from `lm.abstract_params`,
    `adamw.abstract_state` and `grad_compress.abstract_error_state`: no
    generator, no allocation.  ``device``, where the state would live,
    changes nothing in its shapes; it is taken so that callers may name
    it."""
    params = lm.abstract_params(cfg)
    return TrainState(params=params, opt=adamw.abstract_state(params),
                      ef=(grad_compress.abstract_error_state(params)
                          if hyper.compress_cross_pod else None))


def train_state_from_numpy(tree, device) -> TrainState:
    """A JAX `TrainState` as numpy (``jax.tree_util.tree_map(np.asarray,
    state)``: ``params``, ``opt.step``/``mu``/``nu``, ``ef``) as the port's
    state on ``device``, dtypes kept."""
    dev = repro_torch.resolve_device(device)
    opt = tree.opt
    return TrainState(
        params=lm.params_from_numpy(tree.params, dev),
        opt=adamw.AdamWState(
            step=torch.as_tensor(np.array(opt.step), device=dev),
            mu=lm.params_from_numpy(opt.mu, dev),
            nu=lm.params_from_numpy(opt.nu, dev)),
        ef=(None if tree.ef is None
            else lm.params_from_numpy(tree.ef, dev)))


def _value_and_grad(loss_of, params, batch):
    """(gradient tree, metrics) of ``loss_of(params, batch)``: every
    floating leaf of ``params`` requires grad."""
    loss, metrics = loss_of(params, batch)
    leaves = tree_leaves(params)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    return tree_unflatten_like(params, grads), {
        k: v.detach() for k, v in metrics.items()}


def build_train_step(cfg: ArchConfig, hyper: TrainHyper):
    """Returns ``step_fn(state, batch) -> (state, metrics)``; ``batch``
    holds the family's inputs on the state's device (``tokens``;
    ``frames`` for the encoder; ``patch_embeds`` beside the tokens for
    vlm) and ``targets``, with a leading batch axis B that is a multiple
    of ``hyper.microbatches``.  The gradient is that of `lm.loss_fn`'s
    total (the loss plus the MoE aux losses), dispatched with
    ``hyper.moe_impl``."""
    nm = hyper.microbatches

    def loss_of(p, mb):
        if hyper.cast_params_once:
            p = tree_map(lambda a: a.to(hyper.compute_dtype)
                         if (a.dtype == torch.float32 and a.dim() >= 2)
                         else a, p)
        return lm.loss_fn(cfg, p, mb, compute_dtype=hyper.compute_dtype,
                          impl=hyper.impl, remat=hyper.remat,
                          moe_impl=hyper.moe_impl)

    def step_fn(state: TrainState, batch) -> Tuple[TrainState, Dict]:
        params = tree_map(lambda t: t.detach().requires_grad_(), state.params)
        if nm == 1:
            grads, metrics = _value_and_grad(loss_of, params, batch)
        else:
            b = next(iter(batch.values())).shape[0]
            if b % nm:
                raise ValueError(f"batch {b} does not split into {nm} "
                                 f"microbatches")
            mbatch = {k: v.reshape((nm, v.shape[0] // nm) + v.shape[1:])
                      for k, v in batch.items()}
            zero = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            grads, metrics = _accum_loop(loss_of, params, mbatch, zero)
            grads = tree_map(lambda g: g / nm, grads)

        ef = state.ef
        if hyper.compress_cross_pod and ef is not None:
            grads, ef = grad_compress.compress_grads(grads, ef)

        with torch.no_grad():
            new_params, opt, opt_metrics = adamw.apply_updates(
                hyper.adamw, state.params, grads, state.opt)
        return TrainState(new_params, opt, ef), {**metrics, **opt_metrics}

    return step_fn


def _accum_loop(loss_of, params, mbatch, zero):
    """Microbatches in order, summing f32 gradients into ``zero`` (in
    place: it is the step's own buffer) and averaging the metrics."""
    n = next(iter(mbatch.values())).shape[0]
    g_acc, ms = zero, []
    for i in range(n):
        g, m = _value_and_grad(loss_of, params,
                               {k: v[i] for k, v in mbatch.items()})
        tree_map(lambda a, b: a.add_(b.float()), g_acc, g)
        ms.append(m)
    metrics = {k: torch.stack([m[k] for m in ms]).mean() for k in ms[0]}
    return g_acc, metrics


# -- serving ------------------------------------------------------------------------

def cache_shardings(cfg: ArchConfig, mesh, caches, rules=None):
    """The decode caches' placement tree (`lm.init_caches`' structure):
    KV caches ``(L, B, S, Hkv, dh)``, conv states ``(L, B, K-1, C)`` and
    SSM states ``(L, B, h, p, n)`` by their logical axes, anything else
    replicated."""
    rules = rules or arch_rules(cfg)

    def named(logical, ndim):
        spec = shd.resolve(rules, mesh, *logical[:ndim])
        return shd.placements(spec, mesh)

    def spec_for(path, x):
        p = shd.path_str(path)
        if "attn" in p:  # (L, B, S, Hkv, dh)
            return named(("layers", "batch", "cache_seq", "kv_heads",
                          "null"), x.ndim)
        if "conv" in p:  # (L, B, K-1, C)
            return named(("layers", "batch", "null", "mlp"), x.ndim)
        if "ssm" in p:   # (L, B, h, p, n)
            return named(("layers", "batch", "heads", "null", "null"),
                         x.ndim)
        return shd.placements((), mesh)

    return tree_map_with_path(spec_for, caches)
