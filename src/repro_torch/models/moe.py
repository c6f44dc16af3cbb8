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
gate and the aux losses in f32.  The expert-parallel hints
(`distributed.sharding.shard_hint`) sit where the JAX module's do.  The
router, the dispatch, the expert SwiGLU and the combine are torch ops:
the JAX package computes them outside any Pallas kernel too.
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
    sort."""
    order = torch.sort(probs, dim=-1, descending=True, stable=True)
    return order.values[..., :k], order.indices[..., :k]


def _expert_ffn(xe, wg, wu, wd):
    """SwiGLU of every expert on its capacity buffer: xe (B,E,C,D) ->
    (B,E,C,D)."""
    h = F.silu(torch.einsum("becd,edf->becf", xe, wg)) * \
        torch.einsum("becd,edf->becf", xe, wu)
    h = shard_hint(h, "batch", "expert", "null", "mlp_ep")
    return torch.einsum("becf,efd->becd", h, wd)


def _experts_on_blocks(xe, wg, wu, wd):
    """`_expert_ffn` on each rank's (batch, expert) block of DTensors.
    DTensor's einsum of a batch-sharded buffer with the expert weights
    permutes and then calls ``aten.view`` on a local block that the
    permute left non-contiguous, which raises; so the weights are
    redistributed explicitly to the buffer's expert placements (gathered
    over their FSDP "embed" dim, as GSPMD gathers them) and the three
    einsums run on the local blocks."""
    xpl = [p if p in (Shard(0), Shard(1)) else Replicate()
           for p in xe.placements]
    wpl = [Shard(0) if p == Shard(1) else Replicate() for p in xpl]
    return shd.on_blocks(_expert_ffn, (xpl, wpl, wpl, wpl), xpl,
                         xe, wg, wu, wd)


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
        ``e*C + C-1``, so the order of the additions changes no sum.

    The choice of experts is a stable descending sort of the router
    probabilities: ties go to the lower expert index, as in
    `jax.lax.top_k`.
    """
    if impl not in _IMPLS:
        raise ValueError(f"moe_impl {impl!r}: expected one of {_IMPLS}")
    B0, S0, D = x.shape
    if cfg.group_size and cfg.group_size < S0:
        if S0 % cfg.group_size:
            raise ValueError(f"moe_block: sequence {S0} is not a multiple "
                             f"of group_size {cfg.group_size}")
        x = x.reshape(B0 * (S0 // cfg.group_size), cfg.group_size, D)
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

    if impl == "sorted":
        sel_pos = (pos_clip * onehot).sum(-1)                 # (B,S,K)
        sel_cap = (within_cap & (onehot > 0)).any(-1)         # (B,S,K)
        dest = gate_idx * C + sel_pos                         # (B,S,K)
        xk = xc[:, :, None, :] * sel_cap[..., None].to(cd)    # (B,S,K,D)
        bidx = torch.arange(B, device=x.device)[:, None, None].expand_as(
            dest)
        xe_flat = torch.zeros((B, E * C, D), dtype=cd,
                              device=x.device).index_put(
            (bidx, dest), xk, accumulate=True)
        xe = xe_flat.reshape(B, E, C, D)
    else:
        disp = ((pos_clip[..., None]
                 == torch.arange(C, device=x.device))
                & within_cap[..., None]).to(cd)               # (B,S,K,E,C)
        dispatch = disp.sum(2)                                # (B,S,E,C)
        combine = (disp * gate_vals[..., None, None].to(cd)).sum(2)
        del disp
        xe = torch.einsum("bsd,bsec->becd", xc, dispatch)
    xe = shard_hint(xe, "batch", "expert", "null", "embed_act")

    # expert FFN (SwiGLU), the expert axis over "model" on a mesh
    wg, wu, wd = (cast(params["w_gate"], cd), cast(params["w_up"], cd),
                  cast(params["w_down"], cd))
    if isinstance(xe, DTensor):
        ye = _experts_on_blocks(xe, wg, wu, wd)
    else:
        ye = _expert_ffn(xe, wg, wu, wd)

    if impl == "sorted":
        gathered = ye.reshape(B, E * C, D)[bidx, dest]        # (B,S,K,D)
        w = (gate_vals.to(cd) * sel_cap.to(cd))[..., None]
        out = (gathered * w).sum(dim=2)
    else:
        out = torch.einsum("becd,bsec->bsd", ye, combine)
    out = shard_hint(out, "batch", "seq", "embed_act")

    if cfg.d_ff_shared:
        sh = mlp_swiglu(params["shared"], x, cd)
        if cfg.shared_gated:
            g = torch.sigmoid(x.float() @ params["shared_gate"].float())
            sh = sh * g.to(cd)
        out = out + sh

    # aux losses (f32)
    me = probs.mean(dim=(0, 1))                               # (E,)
    ce = onehot.sum(2).float().mean(dim=(0, 1)) / K
    lb = cfg.n_experts_real * torch.sum(me * ce) * cfg.lb_coef
    z = torch.mean(torch.logsumexp(logits, dim=-1) ** 2) * cfg.router_z_coef
    # exactly one (expert) entry per (b,s,k) routing slot is live
    frac_dropped = 1.0 - within_cap.float().sum() / (B * S * K)
    aux = {"lb_loss": lb, "z_loss": z, "frac_dropped": frac_dropped}
    return out.reshape(B0, S0, D), aux
