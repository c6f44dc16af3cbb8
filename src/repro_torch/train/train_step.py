"""The train step: mixed precision, remat, gradient accumulation over
microbatches, cross-pod gradient compression, AdamW, on one device or on
a mesh.  The port of `repro.train.train_step`.

`build_train_step(cfg, hyper, mesh=None)` returns ``step_fn(state, batch)
-> (state, metrics)``.  Gradients come from `torch.autograd` through
`lm.loss_fn` (with ``hyper.impl`` "ref": the kernels have no backward);
microbatches run one after another and their f32 gradients are summed,
then averaged, as the JAX `_accum_loop` scan does.  The step is
functional like the JAX one: it returns a new state and leaves the given
one as it was.

On a mesh the step is a DTensor program, PyTorch's counterpart of GSPMD:
the state and the batch are `torch.distributed.tensor.DTensor` objects placed
by the rule functions below (`state_shardings`, `batch_specs`,
`cache_shardings`: placement trees, `distributed.sharding`), the model's
`shard_hint` calls redistribute its activations where the JAX model's
``with_sharding_constraint`` calls stand, and DTensor's sharding propagation
inserts the collectives XLA's partitioner inserts.  `jit_train_step`,
`jit_prefill` and `jit_decode_step` keep the JAX names and returns, with
placement trees for ``NamedSharding`` objects; nothing is compiled, the
returned functions run eagerly, op by op.
"""

from __future__ import annotations

import dataclasses
import re
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
           "build_train_step", "train_state_from_numpy", "cache_shardings",
           "jit_train_step", "jit_prefill", "jit_decode_step"]


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
    sequence_parallel: bool = False  # Megatron-SP residuals: seq sharded on
                                     # "model" between TP regions (a mesh)
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


def _microbatches(batch, nm: int):
    """The ``nm`` microbatches of ``batch``.  On plain tensors microbatch
    i is rows ``[i * B // nm, (i + 1) * B // nm)``, JAX's ``reshape((nm,
    B // nm) + ...)``.  A DTensor is split on each rank: microbatch i
    holds the i-th of ``nm`` equal slices of every data rank's own rows,
    so no row moves (DTensor's reshape would put whole microbatches on
    single data ranks and gather each in turn).  With one data rank the
    two are the same rows."""
    from torch.distributed.tensor import DTensor
    first = next(iter(batch.values()))
    local = first.to_local() if isinstance(first, DTensor) else first
    if local.shape[0] % nm:
        raise ValueError(f"batch {first.shape[0]} ({local.shape[0]} rows a "
                         f"rank) does not split into {nm} microbatches")

    def split(v, i):
        if not isinstance(v, DTensor):
            return v.reshape((nm, v.shape[0] // nm) + v.shape[1:])[i]
        lv = v.to_local()
        lv = lv.reshape((nm, lv.shape[0] // nm) + lv.shape[1:])[i]
        return DTensor.from_local(lv, v.device_mesh, v.placements,
                                  run_check=False)

    return [{k: split(v, i) for k, v in batch.items()} for i in range(nm)]


def _as_placed(grads, params):
    """Each DTensor gradient redistributed to its parameter's placements
    (the pending sums of a data-sharded computation reduced: all-reduce,
    or reduce-scatter onto an FSDP shard), so that AdamW and the
    compression run shard by shard, as JAX's gradients arrive sharded
    like their parameters; plain gradients as they are."""
    from torch.distributed.tensor import DTensor
    return tree_map(lambda g, p: g.redistribute(p.device_mesh, p.placements)
                    if isinstance(g, DTensor) else g, grads, params)


def _live_rules(rules, mesh):
    """``rules`` without the mesh dims of size one: such a dim splits
    nothing, so a logical axis mapped only to it is replicated, as
    `distributed.sharding.resolve` drops the dims a mesh lacks.  On the
    card's 1 x 1 mesh every placement is then ``Replicate``, and the
    sharded step runs the local blocks the unsharded step runs."""
    one = {n for n, k in zip(mesh.mesh_dim_names, mesh.shape) if k == 1}

    def keep(m):
        if isinstance(m, tuple):
            kept = tuple(x for x in m if x not in one)
            return kept if len(kept) > 1 else (kept[0] if kept else None)
        return None if m in one else m
    return {k: keep(v) for k, v in rules.items()}


def _live(shardings, mesh):
    """A placement tree with ``Replicate`` on every mesh dim of size one
    (see `_live_rules`)."""
    from torch.distributed.tensor import Replicate
    return tree_map(lambda pl: [Replicate() if mesh.size(m) == 1 else p
                                for m, p in enumerate(pl)], shardings)


# the routed experts' weights, which `_fsdp_gathered` leaves on their shards
_EXPERTS = re.compile(r"moe/w_(gate|up|down)$")


def _fsdp_gathered(params, mesh, rules):
    """Each DTensor parameter with its shards over the batch's mesh dims
    (FSDP: "embed" over "data") gathered, its other placements kept, as
    GSPMD gathers an FSDP weight for its matmul; the backward of the
    gather reduce-scatters its gradient onto the shard over "data" and
    then all-reduces that shard over "pod" (`shd.redistribute`: DTensor's
    own backward all-reduces the whole gradient over "pod" first, as the
    mesh orders the dims).  Left to itself,
    DTensor's matmul rule may meet a weight's data-sharded contraction dim
    by moving the data-sharded activations instead, which moves rows of
    the batch between data ranks.  The routed experts' weights stay on
    their shards: the MoE block gathers them layer by layer on its blocks
    (`moe._experts_on_blocks`), inside the layer's remat, as the JAX scan
    gathers a layer's weights in its body (gathered all at once,
    llama4-scout-17b-a16e's 48 layers of one expert a rank are 24 GB in
    f32)."""
    from torch.distributed.tensor import DTensor, Replicate
    spec = shd.resolve(rules, mesh, "batch")[0]
    names = spec if isinstance(spec, tuple) else (() if spec is None
                                                  else (spec,))
    dims = {mesh.mesh_dim_names.index(n) for n in names}

    def one(path, p):
        if not isinstance(p, DTensor) or not any(
                p.placements[m].is_shard() for m in dims) or \
                _EXPERTS.search(shd.path_str(path)):
            return p
        return shd.redistribute(p, [Replicate() if m in dims else q
                                    for m, q in enumerate(p.placements)])
    return tree_map_with_path(one, params)


def build_train_step(cfg: ArchConfig, hyper: TrainHyper, mesh=None):
    """Returns ``step_fn(state, batch) -> (state, metrics)``; ``batch``
    holds the family's inputs on the state's device (``tokens``;
    ``frames`` for the encoder; ``patch_embeds`` beside the tokens for
    vlm) and ``targets``, with a leading batch axis B that is a multiple
    of ``hyper.microbatches``.  The gradient is that of `lm.loss_fn`'s
    total (the loss plus the MoE aux losses), dispatched with
    ``hyper.moe_impl``.  With a ``mesh`` the state and the batch are
    DTensors on it and the step runs under `use_mesh_rules` with the
    arch's rules (``seq_act`` on "model" for ``sequence_parallel``); see
    `jit_train_step` for the placed step."""
    nm = hyper.microbatches
    rules = arch_rules(cfg)
    if hyper.sequence_parallel:
        rules = {**rules, "seq_act": "model"}
    if mesh is not None:
        rules = _live_rules(rules, mesh)

    def loss_of(p, mb):
        if hyper.cast_params_once:
            p = tree_map(lambda a: a.to(hyper.compute_dtype)
                         if (a.dtype == torch.float32 and a.dim() >= 2)
                         else a, p)
        if mesh is not None:
            p = _fsdp_gathered(p, mesh, rules)
        return lm.loss_fn(cfg, p, mb, compute_dtype=hyper.compute_dtype,
                          impl=hyper.impl, remat=hyper.remat,
                          moe_impl=hyper.moe_impl)

    def step_fn(state: TrainState, batch) -> Tuple[TrainState, Dict]:
        params = tree_map(lambda t: t.detach().requires_grad_(), state.params)
        if nm == 1:
            grads, metrics = _value_and_grad(loss_of, params, batch)
            grads = _as_placed(grads, state.params)
        else:
            zero = tree_map(lambda p: torch.zeros_like(
                p, dtype=torch.float32), state.params)
            grads, metrics = _accum_loop(loss_of, params,
                                         _microbatches(batch, nm), zero)
            grads = tree_map(lambda g: g / nm, grads)

        ef = state.ef
        if hyper.compress_cross_pod and ef is not None:
            grads, ef = grad_compress.compress_grads(grads, ef)

        with torch.no_grad():
            new_params, opt, opt_metrics = adamw.apply_updates(
                hyper.adamw, state.params, grads, state.opt)
        return TrainState(new_params, opt, ef), {**metrics, **opt_metrics}

    if mesh is None:
        return step_fn

    def mesh_step(state: TrainState, batch):
        with shd.use_mesh_rules(mesh, rules):
            return step_fn(state, batch)

    return mesh_step


def _accum_loop(loss_of, params, mbatches, zero):
    """Microbatches in order, summing f32 gradients into ``zero`` (in
    place: it is the step's own buffer, placed like the parameters) and
    averaging the metrics."""
    g_acc, ms = zero, []
    for mb in mbatches:
        g, m = _value_and_grad(loss_of, params, mb)
        tree_map(lambda a, b: a.add_(b.float()), g_acc,
                 _as_placed(g, g_acc))
        ms.append(m)
    metrics = {k: torch.stack([m[k] for m in ms]).mean() for k in ms[0]}
    return g_acc, metrics


def _place(tree, shardings, mesh):
    """The inputs of a placed step, as JAX's ``in_shardings`` take them:
    a DTensor redistributed to its placements, a plain tensor (the same
    full value on every rank) distributed by them."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    def one(x, p):
        if isinstance(x, DTensor):
            return x if list(x.placements) == list(p) else \
                x.redistribute(mesh, p)
        return distribute_tensor(torch.as_tensor(x), mesh, p,
                                 src_data_rank=None)
    return tree_map(one, tree, shardings)


def _rows_by_microbatch(x, placements, mesh, nm: int):
    """A full batch tensor (the same on every rank) with its rows laid out
    so that, once distributed by ``placements``, each data rank's block
    holds its share of every microbatch in turn: `_microbatches` then
    finds in microbatch i JAX's rows ``[i * B // nm, (i + 1) * B // nm)``,
    in order, and no row moves.  A DTensor (already placed) or one
    microbatch: as it is."""
    from torch.distributed.tensor import DTensor, Shard
    dp = 1
    for m, p in enumerate(placements):
        if p == Shard(0):
            dp *= mesh.size(m)
    if isinstance(x, DTensor) or nm == 1 or dp == 1:
        return x
    x = torch.as_tensor(x)
    return x.reshape((nm, dp, -1) + x.shape[1:]).transpose(0, 1).reshape(
        x.shape)


def _full(metrics):
    """Metrics as plain tensors, the same on every rank (JAX's replicated
    outputs)."""
    from torch.distributed.tensor import DTensor
    return {k: v.full_tensor() if isinstance(v, DTensor) else v
            for k, v in metrics.items()}


def _mesh_device(mesh) -> torch.device:
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def jit_train_step(cfg: ArchConfig, mesh, hyper: TrainHyper,
                   shape: ShapeSpec):
    """The train step placed on ``mesh``: returns ``(step, astate,
    st_shard, bshard)`` as the JAX function does, ``astate`` the abstract
    state, ``st_shard`` and ``bshard`` placement trees.  ``step(state,
    batch)`` takes the state and the batch as DTensors (redistributed
    where placed otherwise) or as full tensors, the same on every rank
    (distributed without communication), and returns the new state with
    ``st_shard``'s placements (JAX's ``out_shardings``) and the metrics
    as plain tensors.  Nothing is compiled (the name is kept so that a
    reader finds the JAX counterpart), nor is the given state donated:
    the step is functional."""
    astate = abstract_train_state(cfg, hyper)
    st_shard = _live(state_shardings(cfg, mesh, astate), mesh)
    bshard = _live({k: shd.placements(v, mesh) for k, v in
                    batch_specs(cfg, mesh, "train", shape).items()}, mesh)
    step_fn = build_train_step(cfg, hyper, mesh)

    def step(state: TrainState, batch):
        state = _place(state, st_shard, mesh)
        batch = _place({k: _rows_by_microbatch(batch[k], bshard[k], mesh,
                                               hyper.microbatches)
                        for k in bshard}, bshard, mesh)
        new, metrics = step_fn(state, batch)
        return _place(new, st_shard, mesh), _full(metrics)

    return step, astate, st_shard, bshard


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


def jit_decode_step(cfg: ArchConfig, mesh, shape: ShapeSpec,
                    dtype=torch.bfloat16, cache_update: str = "dus",
                    replicate_params_over_data: bool = False):
    """One-token serve step against a ``shape.seq_len`` KV cache, placed
    on ``mesh``: returns ``(step, aparams, acaches, (pshard, cshard,
    bshard))`` as the JAX function does.  ``step(params, caches, tokens,
    pos)`` places its inputs as `jit_train_step`'s step does and returns
    (logits as a DTensor, new caches with ``cshard``'s placements).  The
    step consumes its caches, as JAX's ``donate_argnums=(1,)`` does:
    under ``torch.no_grad()`` each rank writes the new k/v (and SSM
    states) into its own block of the placed caches and returns them
    (`lm.decode_step` with ``donate``).  DTensors already placed by
    ``cshard`` are written themselves, and plain tensors may share their
    storage with their placed blocks: pass a copy to keep the old
    caches.
    ``replicate_params_over_data``: serving holds no optimizer state, so
    parameters need not be FSDP-sharded over "data"; replicated there,
    no decoded token gathers them.  Nothing is compiled."""
    rules = arch_rules(cfg, shape, mesh)
    if replicate_params_over_data:
        rules = {**rules, "embed": None}
    rules = _live_rules(rules, mesh)
    aparams = lm.abstract_params(cfg, dtype)
    pshard = shd.param_sharding(aparams, mesh, rules)
    acaches = lm.init_caches(cfg, shape.global_batch, shape.seq_len, dtype,
                             device="meta")
    cshard = cache_shardings(cfg, mesh, acaches, rules=rules)
    bshard = _live({k: shd.placements(v, mesh) for k, v in
                    batch_specs(cfg, mesh, "decode", shape).items()}, mesh)

    def step(params, caches, tokens, pos):
        params = _fsdp_gathered(_place(params, pshard, mesh), mesh, rules)
        caches = _place(caches, cshard, mesh)
        tokens = _place(tokens, bshard["tokens"], mesh)
        with torch.no_grad(), shd.use_mesh_rules(mesh, rules):
            logits, new = lm.decode_step(cfg, params, caches, tokens,
                                         int(pos), dtype,
                                         cache_update=cache_update,
                                         donate=True)
        return logits, _place(new, cshard, mesh)

    return step, aparams, acaches, (pshard, cshard, bshard)


def jit_prefill(cfg: ArchConfig, mesh, shape: ShapeSpec,
                dtype=torch.bfloat16, impl: str = "ref",
                replicate_params_over_data: bool = False):
    """The prefill placed on ``mesh``: returns ``(step, aparams, (pshard,
    bshard))`` as the JAX function does; ``step(params, batch)`` places
    its inputs as `jit_train_step`'s step does and returns the last
    position's logits as a DTensor.  With ``impl="kernel"`` every
    attention and SSD scan runs the CUDA kernel on each rank's block
    (`models.attention`, `models.mamba2`).  Nothing is compiled."""
    rules = arch_rules(cfg)
    if replicate_params_over_data:     # serving: no optimizer state
        rules = {**rules, "embed": None}
    rules = _live_rules(rules, mesh)
    aparams = lm.abstract_params(cfg, dtype)
    pshard = shd.param_sharding(aparams, mesh, rules)
    bshard = _live({k: shd.placements(v, mesh) for k, v in
                    batch_specs(cfg, mesh, "prefill").items()}, mesh)
    dev = _mesh_device(mesh)

    def step(params, batch):
        params = _fsdp_gathered(_place(params, pshard, mesh), mesh, rules)
        batch = _place({k: batch[k] for k in bshard}, bshard, mesh)
        with shd.use_mesh_rules(mesh, rules):
            return lm.prefill(cfg, params, batch, dtype, impl, device=dev)

    return step, aparams, (pshard, bshard)
