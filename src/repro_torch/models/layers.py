"""Shared model layers: norms, rotary embeddings, MLPs, embeddings.

The port of `repro.models.layers`.  Parameters are plain dicts of tensors;
the compute dtype policy is explicit (parameters live in their own dtype,
compute runs in ``compute_dtype``, reductions and logits in f32).  The
activation hints (`distributed.sharding.shard_hint`) sit where the JAX
module's do: no-ops on plain tensors, a redistribute of a DTensor on a
mesh.

Random initializers draw from an explicit ``torch.Generator`` and put the
tensors on the generator's device.  Given :data:`SHAPE_ONLY` in its place,
they build the same tree as "meta" tensors: shapes and dtypes, no values,
no memory (the counterpart of ``jax.eval_shape`` over an initializer).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

import repro_torch
from repro_torch.distributed.sharding import (block_offset, on_blocks,
                                              shard_hint)

__all__ = ["cast", "rms_norm", "init_rms_norm", "rope_freqs", "apply_rope",
           "init_mlp", "mlp_swiglu", "mlp_gelu", "init_embed",
           "embed_tokens", "init_unembed", "unembed_logits"]


def cast(x: torch.Tensor, dtype) -> torch.Tensor:
    return x.to(dtype) if x.dtype != dtype else x


class _ShapeOnly:
    """Stands where an initializer takes its ``torch.Generator``: its
    device is "meta", so every tensor made on ``gen.device`` holds a shape
    and a dtype only, and :func:`_normal` draws nothing."""

    device = torch.device("meta")


SHAPE_ONLY = _ShapeOnly()


def _normal(gen: torch.Generator, shape, dtype) -> torch.Tensor:
    if gen is SHAPE_ONLY:
        return torch.empty(shape, dtype=dtype, device=gen.device)
    return torch.randn(shape, generator=gen, device=gen.device, dtype=dtype)


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * (1.0 + weight.float())).to(dtype)


def init_rms_norm(d: int, dtype=torch.float32, device=None) -> torch.Tensor:
    # stored as (scale - 1) so zero-init == identity
    return torch.zeros((d,), dtype=dtype,
                       device=repro_torch.resolve_device(device))


# -- rotary position embeddings ------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq).  Half-split
    (not interleaved) rotation with f32 angles."""
    head_dim = x.shape[-1]
    freqs = rope_freqs(head_dim, theta, x.device)               # (hd/2,)
    angles = positions[..., :, None].float() * freqs            # (...,S,hd/2)
    cos = torch.cos(angles)[..., :, None, :]                    # (...,S,1,hd/2)
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# -- MLPs -----------------------------------------------------------------------

def init_mlp(gen: torch.Generator, d_model: int, d_ff: int,
             dtype=torch.float32):
    s_in = d_model ** -0.5
    s_ff = d_ff ** -0.5
    return {
        "w_gate": _normal(gen, (d_model, d_ff), dtype) * s_in,
        "w_up": _normal(gen, (d_model, d_ff), dtype) * s_in,
        "w_down": _normal(gen, (d_ff, d_model), dtype) * s_ff,
    }


def mlp_swiglu(params, x: torch.Tensor,
               compute_dtype=torch.bfloat16) -> torch.Tensor:
    """SwiGLU MLP (llama/qwen/yi family)."""
    x = cast(x, compute_dtype)
    gate = x @ cast(params["w_gate"], compute_dtype)
    up = x @ cast(params["w_up"], compute_dtype)
    h = F.silu(gate) * up
    h = shard_hint(h, "batch", "seq", "mlp")
    return h @ cast(params["w_down"], compute_dtype)


def mlp_gelu(params, x: torch.Tensor,
             compute_dtype=torch.bfloat16) -> torch.Tensor:
    """GELU MLP (classic encoder stacks); reuses w_up/w_down.  The tanh
    approximation, as `jax.nn.gelu` computes by default."""
    x = cast(x, compute_dtype)
    h = F.gelu(x @ cast(params["w_up"], compute_dtype), approximate="tanh")
    h = shard_hint(h, "batch", "seq", "mlp")
    return h @ cast(params["w_down"], compute_dtype)


# -- embeddings -------------------------------------------------------------------

def init_embed(gen: torch.Generator, vocab: int, d_model: int,
               dtype=torch.float32):
    return {"tokens": _normal(gen, (vocab, d_model), dtype)
            * (d_model ** -0.5)}


def embed_tokens(params, tokens: torch.Tensor,
                 compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Rows of the table, cast after the gather (elementwise, so the same
    values as casting the whole table first)."""
    table = params["tokens"]
    if isinstance(table, DTensor):
        out = _embed_on_blocks(table, tokens)
    else:
        out = table[tokens.long()]
    return shard_hint(cast(out, compute_dtype), "batch", "seq", "embed_act")


def _embed_on_blocks(table, tokens):
    """The lookup on each rank's blocks of DTensors (`on_blocks`), vocab-
    parallel: a rank holding rows ``[off, off + n)`` of the table looks up
    the tokens in its range and gives zeros for the rest, and the ranks'
    rows sum (``Partial`` over the table's vocab dims).  DTensor's own
    rules meet the table's embed dim, sharded over "data" (FSDP), by
    gathering the data-sharded tokens, and in the backward
    (``aten.index_put``) the activation gradients too, over "data"; so
    the table is redistributed explicitly: its embed dim gathered, as
    GSPMD gathers it, and no row of the batch moves."""
    tpl = [Shard(0) if p == Shard(0) else Replicate()
           for p in tokens.placements]
    wpl = [Shard(0) if p == Shard(0) and t != Shard(0) else Replicate()
           for p, t in zip(table.placements, tpl)]
    opl = [Partial() if w == Shard(0) else t for w, t in zip(wpl, tpl)]
    off = block_offset(wpl, table.device_mesh, 0, table.shape[0])

    def local(tab, tok):
        idx = tok.long() - off
        hit = (idx >= 0) & (idx < tab.shape[0])
        rows = tab[idx.clamp(0, tab.shape[0] - 1)]
        return torch.where(hit[..., None], rows, torch.zeros_like(rows))

    return on_blocks(local, (wpl, tpl), opl, table, tokens)


def init_unembed(gen: torch.Generator, d_model: int, vocab: int,
                 dtype=torch.float32):
    return {"unembed": _normal(gen, (d_model, vocab), dtype)
            * (d_model ** -0.5)}


def unembed_logits(params, x: torch.Tensor,
                   compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Logits in f32 (sampling numerics)."""
    logits = cast(x, compute_dtype) @ cast(params["unembed"], compute_dtype)
    logits = shard_hint(logits, "batch", "seq", "vocab")
    return logits.float()
