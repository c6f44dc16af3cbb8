"""Mixture-of-Experts block: top-k router + GShard-style capacity dispatch.
The port of `repro.models.moe`.

Covers:

  * qwen2-moe-a2.7b: 60 routed experts (padded to 64), top-4, plus a
    shared expert (4x expert width) with a learned sigmoid gate,
  * llama4-scout-17b-a16e: 16 routed experts, top-1, plus a shared expert.

Router aux losses: load-balancing (Switch/GShard LB loss) + router z-loss.
The semantics are the JAX function's: capacity ``C = max(1, int(cf * K *
S / E))`` with E the padded expert count, a token's slot in its expert
counted over the flattened (S*K) axis (s major, k minor), over-capacity
slots dropped, the shared expert on every token, the router, the shared
gate and the aux losses in f32.  On a mesh the dispatch, the experts and
the combine run on each rank's (batch, expert) block, the placements of
the JAX module's expert-parallel hints (`_experts_on_blocks`); its hint
on the output (`distributed.sharding.shard_hint`) sits where the JAX
module's does.  The router, the dispatch, the expert SwiGLU and the
combine are torch ops: the JAX package computes them outside any Pallas
kernel too.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.distributed import sharding as shd
from repro_torch.distributed.sharding import shard_hint
from repro_torch.models.layers import _normal, cast, init_mlp, mlp_swiglu

__all__ = ["MoeConfig", "init_moe", "moe_block"]

_IMPLS = ("gshard", "sorted")


@dataclasses.dataclass(frozen=True)
class MoeConfig:
    d_model: int
    n_experts: int            # padded routed experts
    n_experts_real: int       # unpadded count (router masks the padding)
    top_k: int
    d_ff_expert: int
    d_ff_shared: int = 0      # 0 = no shared expert
    shared_gated: bool = False  # qwen2-moe: sigmoid-gated shared expert
    capacity_factor: float = 1.25
    router_z_coef: float = 1e-3
    lb_coef: float = 1e-2
    # routing group size: capacity is enforced per group of `group_size`
    # tokens instead of per full sequence (GShard "groups").  0 = one group
    # per (batch, sequence) row.
    group_size: int = 0


def init_moe(gen: torch.Generator, cfg: MoeConfig, dtype=torch.float32,
             device=None):
    """Random MoE parameters with the JAX tree's keys and shapes, drawn
    from ``gen`` on its device (``device``, where given, must be that
    device).  The router and the shared gate are f32 whatever ``dtype``
    is, as in the JAX package."""
    if device is not None and torch.device(device).type != gen.device.type:
        raise ValueError(f"init_moe: generator on {gen.device}, "
                         f"parameters on {device}")
    s_in = cfg.d_model ** -0.5
    s_ff = cfg.d_ff_expert ** -0.5
    E, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff_expert
    p = {"router": _normal(gen, (d, E), torch.float32) * s_in,
         "w_gate": _normal(gen, (E, d, f), dtype) * s_in,
         "w_up": _normal(gen, (E, d, f), dtype) * s_in,
         "w_down": _normal(gen, (E, f, d), dtype) * s_ff}
    if cfg.d_ff_shared:
        p["shared"] = init_mlp(gen, d, cfg.d_ff_shared, dtype)
        if cfg.shared_gated:
            p["shared_gate"] = _normal(gen, (d, 1), torch.float32) * s_in
    return p


def _router_probs(params, cfg: MoeConfig, x: torch.Tensor) -> torch.Tensor:
    """f32 router logits; padded experts masked to -1e30."""
    logits = x.float() @ params["router"].float()
    if cfg.n_experts_real < cfg.n_experts:
        keep = torch.arange(cfg.n_experts, device=x.device) \
            < cfg.n_experts_real
        logits = torch.where(keep, logits, -1e30)
    return logits


def _top_k(probs: torch.Tensor, k: int):
    """(values, indices) of the ``k`` largest probabilities, ties to the
    lower index first as `jax.lax.top_k` breaks them: a stable descending
    sort.  On a DTensor the sort runs on each rank's rows (`on_blocks`),
    the experts whole: the backward of DTensor's sort gathered the
    batch's rows, the indices in int64 too, over every mesh dim that
    splits it ("pod" among them)."""
    if isinstance(probs, DTensor):
        last = probs.ndim - 1
        pl = [p if p.is_shard() and p.dim < last else Replicate()
              for p in probs.placements]
        return shd.on_blocks(lambda pr: _top_k(pr, k), (pl,), (pl, pl),
                             probs)
    order = torch.sort(probs, dim=-1, descending=True, stable=True)
    return order.values[..., :k], order.indices[..., :k]


def _expert_ffn(xe, wg, wu, wd):
    """SwiGLU of every expert on its capacity buffer: xe (B,E,C,D) ->
    (B,E,C,D)."""
    h = F.silu(torch.einsum("becd,edf->becf", xe, wg)) * \
        torch.einsum("becd,edf->becf", xe, wu)
    return torch.einsum("becf,efd->becd", h, wd)


def _dispatch_combine(impl: str, C: int, xc, gate_vals, onehot, pos_clip,
                      within_cap, wg, wu, wd):
    """The dispatch into the capacity buffers, the experts and the combine:
    ``xc`` (B,S,D) in the compute dtype, the routing (B,S,K) ``gate_vals``
    and (B,S,K,E) ``onehot``, ``pos_clip``, ``within_cap``, and the expert
    weights, with E the experts held here (all of them, or one rank's
    block of them): (B,S,D), the sum over those experts.  A (b,s,k) routed
    to an expert not held here scatters a zero row and gathers nothing."""
    B, S, D = xc.shape
    E = wg.shape[0]
    cd = xc.dtype
    if impl == "sorted":
        sel_pos = (pos_clip * onehot).sum(-1)                 # (B,S,K)
        sel_cap = (within_cap & (onehot > 0)).any(-1)         # (B,S,K)
        dest = onehot.argmax(-1) * C + sel_pos                # (B,S,K)
        xk = xc[:, :, None, :] * sel_cap[..., None].to(cd)    # (B,S,K,D)
        bidx = torch.arange(B, device=xc.device)[:, None, None].expand_as(
            dest)
        xe = torch.zeros((B, E * C, D), dtype=cd, device=xc.device
                         ).index_put((bidx, dest), xk, accumulate=True
                                     ).reshape(B, E, C, D)
        ye = _expert_ffn(xe, wg, wu, wd)
        gathered = ye.reshape(B, E * C, D)[bidx, dest]        # (B,S,K,D)
        w = (gate_vals.to(cd) * sel_cap.to(cd))[..., None]
        return (gathered * w).sum(dim=2)
    disp = ((pos_clip[..., None] == torch.arange(C, device=xc.device))
            & within_cap[..., None]).to(cd)                   # (B,S,K,E,C)
    dispatch = disp.sum(2)                                    # (B,S,E,C)
    combine = (disp * gate_vals[..., None, None].to(cd)).sum(2)
    del disp
    ye = _expert_ffn(torch.einsum("bsd,bsec->becd", xc, dispatch),
                     wg, wu, wd)
    return torch.einsum("becd,bsec->bsd", ye, combine)


def _experts_on_blocks(impl: str, C: int, xc, gate_vals, onehot, pos_clip,
                       within_cap, wg, wu, wd):
    """`_dispatch_combine` on each rank's (batch, expert) block of
    DTensors: the rows of the batch ``xc`` splits, the experts the weights
    split over "model" (EP), each rank's output its experts' part of the
    sum (``Partial`` over the expert dims).  These are the placements of
    the JAX module's hints on the capacity buffer (batch, expert) and the
    expert FFN.  DTensor refuses the dispatch's ops on a real split:
    torch 2.11 raises on ``aten.index_put`` into the sorted dispatch's
    buffer (a ``Shard(-1)`` its rule does not normalize) and on the
    ``aten._unsafe_view`` the combine einsum makes of a buffer whose
    expert dim is split ("flatten multiple dimensions ... being
    sharded"); and DTensor's einsum of the batch-sharded buffer with the
    expert weights calls ``aten.view`` on a block its permute left
    non-contiguous (torch 2.13).  The weights are gathered over their
    FSDP "embed" dim here, one layer at a time, as GSPMD gathers them in
    the JAX scan's body.  The routing (``onehot``,
    ``pos_clip``, ``within_cap``) arrives whole along the sequence: a
    token's slot is a cumsum over its row."""
    from torch.distributed.tensor import Partial
    batch = [p == Shard(0) for p in xc.placements]
    expert = [p == Shard(0) for p in wg.placements]
    xpl = [Shard(0) if b else Replicate() for b in batch]
    rpl = [Shard(0) if b else Shard(3) if e else Replicate()
           for b, e in zip(batch, expert)]
    wpl = [Shard(0) if e else Replicate() for e in expert]
    opl = [Shard(0) if b else Partial() if e else Replicate()
           for b, e in zip(batch, expert)]
    return shd.on_blocks(
        lambda *a: _dispatch_combine(impl, C, *a),
        (xpl, xpl, rpl, rpl, rpl, wpl, wpl, wpl), opl,
        xc, gate_vals, onehot, pos_clip, within_cap, wg, wu, wd)


def moe_block(params, cfg: MoeConfig, x: torch.Tensor,
              compute_dtype=torch.bfloat16,
              deterministic_capacity: Optional[int] = None,
              impl: str = "gshard"):
    """x: (B, S, d) -> (out, aux dict of ``lb_loss``, ``z_loss``,
    ``frac_dropped``, f32 scalars).

    Two dispatch implementations of the same function:

      impl="gshard": a (B,S,K,E,C) dispatch tensor (a bool compare, cast
        to ``compute_dtype``) summed over K, then dense dispatch and
        combine einsums.
      impl="sorted": each (b,s,k) scattered into its slot ``e*C + pos`` of
        a (B, E*C, D) buffer and gathered back; a live slot receives
        exactly one token, and a dropped (b,s,k) adds a zero row to slot
        ``e*C + C-1`` (on a rank's expert block, a (b,s,k) routed to
        another rank's expert one to slot 0), so the order of the
        additions changes no sum.

    The choice of experts is a stable descending sort of the router
    probabilities: ties go to the lower expert index, as in
    `jax.lax.top_k`.
    """
    if impl not in _IMPLS:
        raise ValueError(f"moe_impl {impl!r}: expected one of {_IMPLS}")
    B0, S0, D = x.shape
    grouped = bool(cfg.group_size) and cfg.group_size < S0
    if grouped:
        if S0 % cfg.group_size:
            raise ValueError(f"moe_block: sequence {S0} is not a multiple "
                             f"of group_size {cfg.group_size}")
        x = _regroup(x, cfg.group_size)
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    C = deterministic_capacity or max(
        1, int(cfg.capacity_factor * K * S / E))
    cd = compute_dtype

    logits = _router_probs(params, cfg, x)                    # (B,S,E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = _top_k(probs, K)                    # (B,S,K)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)            # renormalize

    # position of each (token, k) within its expert's capacity buffer
    onehot = F.one_hot(gate_idx, E)                           # (B,S,K,E)
    flat = onehot.reshape(B, S * K, E)
    pos_in_expert = (torch.cumsum(flat, dim=1) * flat - 1).reshape(
        B, S, K, E)
    within_cap = (pos_in_expert >= 0) & (pos_in_expert < C)
    pos_clip = torch.clamp(pos_in_expert, 0, C - 1)
    xc = cast(x, cd)

    # dispatch, expert FFN (SwiGLU), combine; on a mesh the expert axis
    # over "model"
    wg, wu, wd = (cast(params["w_gate"], cd), cast(params["w_up"], cd),
                  cast(params["w_down"], cd))
    if isinstance(xc, DTensor):
        out = _experts_on_blocks(impl, C, xc, gate_vals, onehot, pos_clip,
                                 within_cap, wg, wu, wd)
    else:
        out = _dispatch_combine(impl, C, xc, gate_vals, onehot, pos_clip,
                                within_cap, wg, wu, wd)
    out = shard_hint(out, "batch", "seq", "embed_act")

    if cfg.d_ff_shared:
        sh = mlp_swiglu(params["shared"], x, cd)
        if cfg.shared_gated:
            g = torch.sigmoid(x.float() @ params["shared_gate"].float())
            sh = sh * g.to(cd)
        out = out + sh

    # aux losses (f32); on a mesh the means over the split batch are
    # reduced here (`shd.reduce_partial`), so their gradients reach the
    # router whole: left pending, DTensor reduce-scattered each token's
    # router gradient over the batch's mesh dims ("pod" among them)
    me = shd.reduce_partial(probs.mean(dim=(0, 1)))           # (E,)
    ce = onehot.sum(2).float().mean(dim=(0, 1)) / K
    lb = cfg.n_experts_real * torch.sum(me * ce) * cfg.lb_coef
    z = shd.reduce_partial(torch.mean(torch.logsumexp(logits, dim=-1) ** 2)
                           ) * cfg.router_z_coef
    # exactly one (expert) entry per (b,s,k) routing slot is live
    frac_dropped = 1.0 - within_cap.float().sum() / (B * S * K)
    aux = {"lb_loss": lb, "z_loss": z, "frac_dropped": frac_dropped}
    return (_regroup(out, S0) if grouped else out.reshape(B0, S0, D)), aux


def _regroup(x, rows: int):
    """``x`` (B, S, D) as (B * S // rows, rows, D): the routing groups'
    reshape (``rows`` the group size) and its inverse (``rows`` the
    sequence).  On a DTensor each rank reshapes its own block
    (`shd.on_blocks`), its sequence whole and its pending sums reduced
    first (its batch whole too where the batch does not split evenly):
    rank r's groups are the groups of its own rows, and a pending sum's
    gradient would come back to each rank whole, counted once a rank.
    DTensor's view rule mis-sizes the block of a batch-split tensor whose
    sequence folds into the batch (``shape '[0, 16, 128]' is
    invalid``)."""
    B, S, D = x.shape
    if not isinstance(x, DTensor):
        return x.reshape(B * S // rows, rows, D)
    pl = [Replicate() if p.is_shard(1) or p.is_partial() else p
          for p in x.placements]
    ways = 1
    for m, p in enumerate(pl):
        if p.is_shard(0):
            ways *= x.device_mesh.size(m)
    if B % ways or (B * S // rows) % ways:
        pl = [Replicate() if p.is_shard(0) else p for p in pl]
    return shd.on_blocks(lambda b: b.reshape(-1, rows, D), (pl,), pl, x)
