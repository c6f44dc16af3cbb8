"""Logical-axis sharding rules (DP / FSDP / TP / EP / pod), as DTensor
placements.  The port of `repro.distributed.sharding`.

Models are pure functions over parameter trees; sharding is applied at
the step's boundary by mapping each parameter's *path* to a logical-axis
signature and each logical axis to a mesh dim.  Activations get hints
through :func:`shard_hint`, which is a no-op outside a `use_mesh_rules`
context (so model code stays runnable on a single device).

A spec is what JAX's ``PartitionSpec`` holds: a tuple with one entry per
tensor dim, each ``None``, a mesh-dim name or a tuple of names.  A
sharding is its DTensor form: a list of placements, one per mesh dim,
``Shard(d)`` where the spec names that mesh dim for tensor dim ``d`` and
``Replicate()`` elsewhere.  A mesh is anything with ``mesh_dim_names``
(a `torch.distributed` ``DeviceMesh``; ``shape`` too where the batch
rules need the dims' sizes).

Mesh dims (see launch/mesh.py):
  * ``pod``   — pure data parallelism across pods
  * ``data``  — batch data parallelism + FSDP (parameter / optimizer-state
                sharding along the embed axis)
  * ``model`` — tensor parallelism over heads / d_ff / vocab / experts (EP)

Logical axes:
  batch, seq, embed, heads, kv_heads, qkv, mlp, vocab, expert, layers,
  conv, state, null
"""

from __future__ import annotations

import contextlib
import functools
import re
import threading
from typing import Dict, List, Optional, Tuple

from repro_torch._tree import tree_map, tree_map_with_path

__all__ = ["DEFAULT_RULES", "resolve", "placements", "use_mesh_rules",
           "shard_hint", "PARAM_RULES", "path_str", "logical_axes_for",
           "param_sharding", "param_spec", "distribute_tree", "gather_tree",
           "block_offset", "on_blocks", "reduce_partial", "bind_mesh_rules",
           "hint_placements", "column_groups", "redistribute"]

# logical axis -> mesh dim (None = replicated)
DEFAULT_RULES: Dict[str, Optional[object]] = {
    "batch": ("pod", "data"),
    "seq": None,
    "seq_act": None,        # Megatron-SP: set to "model" to seq-shard
                            # residuals between TP regions
    "embed": "data",        # FSDP: shard params' embed axis over data
    "embed_act": None,      # activations' embed axis stays unsharded
    "heads": "model",
    "kv_heads": "model",
    "qkv": "model",
    "kv_qkv": "model",      # per-arch: None when kv_heads < TP (replicated)
    "mlp": "model",
    "mlp_ep": None,         # expert-internal FFN dim (EP already uses model)
    "vocab": "model",
    "expert": "model",      # EP
    "layers": None,
    "conv": None,
    "state": None,
    "cache_seq": None,
    "null": None,
}

_ctx = threading.local()


def _mesh_axes(mesh) -> Tuple[str, ...]:
    return tuple(mesh.mesh_dim_names)


def resolve(rules: Dict[str, object], mesh, *logical) -> Tuple:
    """Logical axes -> spec, dropping mesh dims absent from the mesh
    (e.g. 'pod' on the single-pod mesh)."""
    names = set(_mesh_axes(mesh))
    out = []
    for ax in logical:
        m = rules.get(ax, None)
        if m is None:
            out.append(None)
        elif isinstance(m, tuple):
            kept = tuple(x for x in m if x in names)
            out.append(kept if len(kept) > 1 else (kept[0] if kept else None))
        else:
            out.append(m if m in names else None)
    return tuple(out)


def placements(spec: Tuple, mesh) -> List:
    """A spec as DTensor placements, one per mesh dim.  Raises
    ``ValueError`` where the spec names one mesh dim for two tensor dims
    (JAX's ``NamedSharding`` refuses it too), or names the dims of one
    tensor dim in an order other than the mesh's (a DTensor splits a
    tensor dim over its mesh dims in mesh order)."""
    # imported here, not with the module: checkpoints need only path_str
    from torch.distributed.tensor import Replicate, Shard
    axes = _mesh_axes(mesh)
    out: List = [Replicate() for _ in axes]
    seen: Dict[str, int] = {}
    for d, entry in enumerate(spec):
        names = entry if isinstance(entry, tuple) else \
            (() if entry is None else (entry,))
        for name in names:
            if name in seen:
                raise ValueError(f"spec {spec}: mesh dim {name!r} shards "
                                 f"tensor dims {seen[name]} and {d}")
            seen[name] = d
            out[axes.index(name)] = Shard(d)
        if list(names) != sorted(names, key=axes.index):
            raise ValueError(f"spec {spec}: tensor dim {d} names mesh dims "
                             f"{names} out of the mesh's order {axes}")
    return out


@contextlib.contextmanager
def use_mesh_rules(mesh, rules: Optional[Dict[str, object]] = None):
    """Enable shard_hint() inside model code.  Inside, a plain tensor met
    by a DTensor op counts as replicated (DTensor's
    ``implicit_replication``): the model's own constants (positions,
    masks, ranges) are the same on every rank, as JAX's are."""
    from torch.distributed.tensor.experimental import implicit_replication
    prev = getattr(_ctx, "state", None)
    _ctx.state = (mesh, rules or DEFAULT_RULES)
    try:
        with implicit_replication():
            yield
    finally:
        _ctx.state = prev


def bind_mesh_rules(fn):
    """``fn`` run under the `use_mesh_rules` context active where it is
    bound, on whichever thread calls it (unchanged outside one).  The
    context is thread-local, and activation checkpointing recomputes a
    unit in the backward, which on the card runs on autograd's device
    thread: unbound, every `shard_hint` of the recompute is a no-op, the
    recomputed blocks take other shapes than the forward's, and
    ``torch.utils.checkpoint`` raises."""
    state = getattr(_ctx, "state", None)
    if state is None:
        return fn

    def bound(*args, **kwargs):
        prev = getattr(_ctx, "state", None)
        _ctx.state = state
        try:
            return fn(*args, **kwargs)
        finally:
            _ctx.state = prev
    return bound


def block_offset(placements, mesh, dim: int, n: int) -> int:
    """The global index of this rank's first element along tensor dim
    ``dim`` (of size ``n``) under ``placements``: its block number over
    the mesh dims that shard ``dim``, in mesh order.  Raises
    ``ValueError`` where those dims do not split ``n`` evenly."""
    from torch.distributed.tensor import Shard
    coord = mesh.get_coordinate()
    idx, ways = 0, 1
    for m, p in enumerate(placements):
        if isinstance(p, Shard) and p.dim == dim:
            idx, ways = idx * mesh.size(m) + coord[m], ways * mesh.size(m)
    if n % ways:
        raise ValueError(f"block_offset: {ways} ways do not split {n} "
                         f"evenly along dim {dim}")
    return idx * (n // ways)


def on_blocks(fn, in_placements, out_placements, *args):
    """``fn`` run on each rank's own block of ``args`` (DTensors on one
    mesh), through `torch.distributed.tensor.experimental.local_map`:
    each argument is first redistributed to its entry of
    ``in_placements``, the outputs come back as DTensors with
    ``out_placements``.  The gradient of an argument replicated over a
    mesh dim that another argument shards is ``Partial`` there: each
    rank used the whole of it for its own block of the work, so the
    ranks' gradients sum."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = next(a.device_mesh for a in args if isinstance(a, DTensor))
    split = [any(isinstance(p[m], Shard) for p in in_placements)
             for m in range(mesh.ndim)]
    grads = tuple(
        tuple(Partial() if split[m] and isinstance(p[m], Replicate)
              else p[m] for m in range(mesh.ndim))
        for p in in_placements)
    return local_map(fn, out_placements=out_placements,
                     in_placements=tuple(tuple(p) for p in in_placements),
                     in_grad_placements=grads, device_mesh=mesh,
                     redistribute_inputs=True)(*args)


def reduce_partial(x):
    """A DTensor's pending sums (``Partial`` placements) reduced, its other
    placements kept (`redistribute`: the gradient passes back whole);
    anything else as it is.  For ops whose DTensor rule cannot take a
    partial input (see the callers)."""
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(x, DTensor) or not any(p.is_partial()
                                             for p in x.placements):
        return x
    return redistribute(x, [Replicate() if p.is_partial() else p
                            for p in x.placements])


def distribute_tree(tree, mesh, shardings):
    """A tree of full tensors as DTensors on ``mesh``, each leaf placed by
    the matching placement list of ``shardings`` (`param_sharding`,
    `state_shardings`, ...).  Every rank holds the same full leaf, so each
    keeps its own block without communication."""
    from torch.distributed.tensor import distribute_tensor
    return tree_map(lambda x, p: distribute_tensor(x, mesh, p,
                                                   src_data_rank=None),
                    tree, shardings)


def gather_tree(tree):
    """The full tensor of every DTensor leaf of ``tree`` (a collective
    on every rank); plain leaves as they are."""
    from torch.distributed.tensor import DTensor
    return tree_map(lambda x: x.full_tensor() if isinstance(x, DTensor)
                    else x, tree)


def shard_hint(x, *logical):
    """Annotate an activation with logical axes: inside `use_mesh_rules` a
    ``DTensor`` is redistributed to the resolved placements; a plain
    tensor, or anything outside the context, is returned unchanged."""
    from torch.distributed.tensor import DTensor
    state = getattr(_ctx, "state", None)
    if state is None or not isinstance(x, DTensor):
        return x
    mesh, rules = state
    spec = resolve(rules, mesh, *logical)
    return x.redistribute(mesh, placements(spec, mesh))


def redistribute(x, placements):
    """``x.redistribute(x.device_mesh, placements)`` with a backward that
    takes the gradient to ``x``'s placements in the order GSPMD
    transposes the forward's collectives:

      * the mesh dims whose pending sum the forward reduced get the
        gradient whole (``Replicate``): a sum's gradient is each
        addend's, and DTensor cannot split a sum's gradient back into a
        pending average (``Partial("avg")``, a mean over a split dim);
      * the other dims reduce-scatter and slice onto ``x``'s shards
        first, then all-reduce: a gradient pending over ("pod", "data")
        onto an FSDP shard is reduce-scattered over "data" and only its
        shard all-reduced over "pod".  DTensor reduces the mesh dims in
        their order, so it all-reduced the whole gradient over "pod".

    The FSDP gather (`train.train_step._fsdp_gathered`) and
    `reduce_partial` take it.  `shard_hint` keeps DTensor's own backward:
    with the hints' reduced sums' gradients passed on whole, DTensor
    picks other strategies for the products before them, which gather
    more at full width and raise the peak (PERF.md §6)."""
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    if list(x.placements) == list(placements):
        return x
    return _redistribute_fn().apply(x, tuple(placements))


@functools.lru_cache(maxsize=None)
def _redistribute_fn():
    """`redistribute`'s autograd function, built at its first use (this
    module imports torch only where a DTensor is met)."""
    import torch
    from torch.distributed.tensor import Replicate

    class Redistribute(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, placements):
            ctx.meta = (x.device_mesh, tuple(x.placements),
                        tuple(placements))
            return x.redistribute(x.device_mesh, list(placements))

        @staticmethod
        def backward(ctx, g):
            mesh, before, after = ctx.meta
            want = [Replicate() if b.is_partial() and not a.is_partial()
                    else b for b, a in zip(before, after)]
            first = [w if w.is_shard() else p
                     for w, p in zip(want, g.placements)]
            if first != list(g.placements):
                g = g.redistribute(mesh, first)
            if want != list(g.placements):
                g = g.redistribute(mesh, want)
            return g, None

    return Redistribute


def hint_placements(*logical):
    """The placements `shard_hint` would give a DTensor with these
    logical axes under the active `use_mesh_rules` context, or None
    outside one."""
    state = getattr(_ctx, "state", None)
    if state is None:
        return None
    mesh, rules = state
    return placements(resolve(rules, mesh, *logical), mesh)


def column_groups(w, widths, group_placements):
    """The column groups of DTensor ``w`` (..., N): consecutive slices of
    ``widths`` (summing to N) of its last dim, group i placed as
    ``group_placements[i]``, each group on the mesh dims that split it
    in blocks of its own.  ``w``'s columns may be split in blocks that do
    not align with the groups (Mamba2's in-projection packs z, x, B, C
    and dt in one matrix), so ``w`` is gathered over the mesh dims that
    split its columns (the weight, never its product) and each rank keeps
    its block of each group.  The backward never gathers a gradient:
    each rank writes its groups' gradients into a zero block of the whole
    columns, and that pending sum is reduce-scattered onto ``w``'s
    split; on other mesh dims the gradient keeps the placement the
    groups' gradients arrive with (a pending sum over the batch stays
    pending)."""
    return _column_groups_fn().apply(
        w, tuple(widths), tuple(tuple(p) for p in group_placements))


@functools.lru_cache(maxsize=None)
def _column_groups_fn():
    """`column_groups`' autograd function, built at its first use (this
    module imports torch only where a DTensor is met)."""
    import torch
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    class ColumnGroups(torch.autograd.Function):
        @staticmethod
        def forward(ctx, w, widths, group_placements):
            mesh, last = w.device_mesh, w.ndim - 1
            split = [p == Shard(last) for p in w.placements]
            whole = w.redistribute(mesh, [Replicate() if s else p for s, p
                                          in zip(split, w.placements)])
            ctx.meta = (mesh, last, split, tuple(w.placements),
                        tuple(w.shape), w.stride(), widths)
            out, lo = [], 0
            for width, pl in zip(widths, group_placements):
                out.append(whole[..., lo:lo + width].redistribute(
                    mesh, list(pl)))
                lo += width
            return tuple(out)

        @staticmethod
        def backward(ctx, *grads):
            mesh, last, split, wpl, shape, stride, widths = ctx.meta
            first = next(g for g in grads if g is not None)
            # every group's gradient on the first's placements off the
            # split dims (there: a block of the group's columns, a pending
            # sum, or the whole on every rank)
            other = [None if s else p for s, p in zip(split, first.placements)]
            coord = mesh.get_coordinate()
            local = first.to_local()
            acc = local.new_zeros(local.shape[:-1] + (shape[last],))
            lo = 0
            for width, g in zip(widths, grads):
                if g is not None:
                    g = g.redistribute(mesh, [o if o is not None else p
                                              for o, p in zip(other,
                                                              g.placements)])
                    # a group whole on every rank of a split dim counts
                    # once, from the rank at coordinate 0
                    mine = all(coord[m] == 0 for m, p in
                               enumerate(g.placements)
                               if split[m] and p.is_replicate())
                    off = block_offset([p if split[m] else Replicate()
                                        for m, p in enumerate(g.placements)],
                                       mesh, last, width)
                    if mine:
                        gl = g.to_local()
                        acc[..., lo + off:lo + off + gl.shape[-1]] = gl
                lo += width
            pending = DTensor.from_local(
                acc, mesh, [Partial() if s else o
                            for s, o in zip(split, other)],
                run_check=False, shape=torch.Size(shape), stride=stride)
            return (pending.redistribute(mesh, [p if s else o for s, p, o
                                                in zip(split, wpl, other)]),
                    None, None)

    return ColumnGroups


# ---------------------------------------------------------------------------
# Parameter-path -> logical axes.  Paths are '/'-joined tree key paths.
# First matching regex wins.  Signatures must cover the array's full rank
# (scan-stacked params have a leading 'layers' axis).
# ---------------------------------------------------------------------------

PARAM_RULES: Tuple[Tuple[str, Tuple[str, ...]], ...] = (
    # embeddings / heads
    (r"embed/tokens$", ("vocab", "embed")),
    (r"embed/proj$", ("null", "embed")),
    (r"head/unembed$", ("embed", "vocab")),
    (r"final_norm", ("null",)),
    # attention (stacked: leading layers axis)
    (r"attn/wq$", ("layers", "embed", "qkv")),
    (r"attn/wk$", ("layers", "embed", "kv_qkv")),
    (r"attn/wv$", ("layers", "embed", "kv_qkv")),
    (r"attn/bq$", ("layers", "qkv")),
    (r"attn/bk$", ("layers", "kv_qkv")),
    (r"attn/bv$", ("layers", "kv_qkv")),
    (r"attn/wo$", ("layers", "qkv", "embed")),
    # dense mlp
    (r"mlp/w_gate$", ("layers", "embed", "mlp")),
    (r"mlp/w_up$", ("layers", "embed", "mlp")),
    (r"mlp/w_down$", ("layers", "mlp", "embed")),
    # MoE — experts sharded over "model" (EP); inside an expert the FFN dims
    # are NOT tensor-parallel (a mesh axis may appear only once per spec)
    (r"moe/router$", ("layers", "embed", "expert")),
    (r"moe/w_gate$", ("layers", "expert", "embed", "mlp_ep")),
    (r"moe/w_up$", ("layers", "expert", "embed", "mlp_ep")),
    (r"moe/w_down$", ("layers", "expert", "mlp_ep", "embed")),
    (r"moe/shared_gate$", ("layers", "embed", "null")),
    (r"moe/shared/w_(gate|up)$", ("layers", "embed", "mlp")),
    (r"moe/shared/w_down$", ("layers", "mlp", "embed")),
    # mamba2 / ssd
    (r"ssm/in_proj$", ("layers", "embed", "mlp")),
    (r"ssm/conv_w$", ("layers", "conv", "mlp")),
    (r"ssm/conv_b$", ("layers", "mlp")),
    (r"ssm/dt_bias$", ("layers", "heads")),
    (r"ssm/A_log$", ("layers", "heads")),
    (r"ssm/D$", ("layers", "heads")),
    (r"ssm/out_proj$", ("layers", "mlp", "embed")),
    (r"ssm/norm_w$", ("layers", "mlp")),
    # shared (hybrid zamba) blocks: no leading layers axis
    (r"shared.*/attn/wq$", ("embed", "qkv")),
    (r"shared.*/attn/w[kv]$", ("embed", "kv_qkv")),
    (r"shared.*/attn/bq$", ("qkv",)),
    (r"shared.*/attn/b[kv]$", ("kv_qkv",)),
    (r"shared.*/attn/wo$", ("qkv", "embed")),
    (r"shared.*/mlp/w_(gate|up)$", ("embed", "mlp")),
    (r"shared.*/mlp/w_down$", ("mlp", "embed")),
    (r"shared.*/norm", ("null",)),
    # norms inside stacked layers
    (r"norm", ("layers", "null")),
)


def path_str(path) -> str:
    """``"/"``-joined key path: a part with a ``key`` (a dict key) or an
    ``idx`` (a sequence index) gives that, any other part its ``str`` (a
    named-tuple field is ``".name"``, as JAX's ``GetAttrKey`` prints)."""
    parts = []
    for k in path:
        if hasattr(k, "key"):
            parts.append(str(k.key))
        elif hasattr(k, "idx"):
            parts.append(str(k.idx))
        else:
            parts.append(str(k))
    return "/".join(parts)


def logical_axes_for(path: str, ndim: int) -> Tuple[str, ...]:
    for pat, sig in PARAM_RULES:
        if re.search(pat, path):
            if len(sig) == ndim:
                return sig
            # tolerate missing/extra leading 'layers' axis (shared blocks /
            # non-stacked single layers)
            if len(sig) == ndim + 1 and sig[0] == "layers":
                return sig[1:]
            if len(sig) + 1 == ndim:
                return ("layers",) + sig
    return ("null",) * ndim  # replicate by default


def param_sharding(params, mesh, rules: Optional[Dict[str, object]] = None):
    """Placement-list tree for a parameter tree."""
    rules = rules or DEFAULT_RULES

    def one(path, x):
        sig = logical_axes_for(path_str(path), x.ndim)
        return placements(resolve(rules, mesh, *sig), mesh)

    return tree_map_with_path(one, params)


def param_spec(params, mesh, rules=None):
    rules = rules or DEFAULT_RULES

    def one(path, x):
        sig = logical_axes_for(path_str(path), x.ndim)
        return resolve(rules, mesh, *sig)

    return tree_map_with_path(one, params)
