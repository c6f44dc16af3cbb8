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
import re
import threading
from typing import Dict, List, Optional, Tuple

from repro_torch._tree import tree_map, tree_map_with_path

__all__ = ["DEFAULT_RULES", "resolve", "placements", "use_mesh_rules",
           "shard_hint", "PARAM_RULES", "path_str", "logical_axes_for",
           "param_sharding", "param_spec", "distribute_tree", "gather_tree",
           "block_offset", "on_blocks", "reduce_partial", "bind_mesh_rules"]

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
    placements kept; anything else as it is.  For ops whose DTensor rule
    cannot take a partial input (see the callers)."""
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(x, DTensor) or not any(p.is_partial()
                                             for p in x.placements):
        return x
    return x.redistribute(x.device_mesh, [Replicate() if p.is_partial()
                                          else p for p in x.placements])


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
