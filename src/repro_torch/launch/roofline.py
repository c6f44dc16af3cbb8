"""Roofline accounting: the analytic per-device cost model (the analytic
half of `repro.launch.roofline`, line for line).

Three terms per (arch x shape x mesh), in seconds:

    compute    = FLOPs_per_device  / PEAK_FLOPS_BF16
    memory     = HBM_bytes_per_device / HBM_BW
    collective = collective_bytes_per_device / ICI_BW_PER_LINK

with the card's constants (`launch.mesh`: an NVIDIA H100 SXM5), so the
seconds differ from the JAX module's by the constants alone.

  * The compute and memory terms come from an analytic model that mirrors
    the program the production mesh runs (the same einsums including the
    GShard dispatch, TP padding, KV replication, remat recompute,
    microbatching).  Every number is a Python float or int computed in the
    JAX module's order, so both packages give equal results.  On "meta"
    tensors, `torch.utils.flop_counter.FlopCounterMode` over the port's
    `lm.loss_fn` at depth 1 is the program's own count to hold it to
    (tests/test_torch_roofline.py).

  * MODEL_FLOPS = 6·N·D (dense) or 6·N_active·D (MoE); the ratio
    MODEL_FLOPS / FLOPs exposes padding, dispatch-einsum and remat waste.

The collective half of the JAX module parses the HLO text XLA compiles
(`split_computations`, `entry_computation`, `parse_collectives`), which
the port never produces, so none of them is carried over.  Its
counterpart here, `count_collectives`, counts the collectives a sharded
torch step issues as it runs, into the JAX module's `CollectiveStats`.
"""

from __future__ import annotations

import dataclasses
import os
import sys
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.launch.mesh import HBM_BW, ICI_BW_PER_LINK, PEAK_FLOPS_BF16

__all__ = ["TP", "AnalyticCosts", "analytic_costs", "count_params",
           "active_params", "model_flops_per_token", "cache_bytes",
           "roofline_terms", "DTYPE_BYTES", "COLLECTIVES",
           "CollectiveStats", "count_collectives"]

DTYPE_BYTES = {"f64": 8, "f32": 4, "f16": 2, "bf16": 2, "s64": 8, "u64": 8,
               "s32": 4, "u32": 4, "s16": 2, "u16": 2, "s8": 1, "u8": 1,
               "pred": 1, "c64": 8, "c128": 16}

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

TP = 16  # "model" axis extent on the production mesh


def _layer_fwd_flops_per_token(cfg: ArchConfig, S: int, local_S: int) -> float:
    """Forward FLOPs per *token* per layer, per model-shard (x TP = global).

    `S`: attention context length; `local_S`: tokens this device computes.
    Mirrors the compiled einsums, including TP padding and KV replication.
    """
    D = cfg.d_model
    fl = 0.0
    if cfg.family in ("dense", "moe", "encoder", "vlm", "hybrid"):
        Hp, dh = cfg.n_heads_padded, cfg.head_dim
        Hkv = cfg.n_kv_heads_eff
        q_cols = Hp * dh / TP
        kv_cols = Hkv * dh / (TP if cfg.kv_sharded else 1)
        fl += 2 * D * q_cols              # wq
        fl += 2 * 2 * D * kv_cols         # wk, wv
        fl += 2 * q_cols * D              # wo
        # attention: scores + AV;  causal halves the window on average
        causal_frac = 0.5 if cfg.causal else 1.0
        fl += 2 * 2 * S * causal_frac * (Hp / TP) * dh
    if cfg.family in ("dense", "encoder", "vlm", "hybrid"):
        n_mats = 2 if cfg.family == "encoder" else 3   # gelu vs swiglu
        fl += 2 * n_mats * D * (cfg.d_ff / TP)
    if cfg.family == "moe":
        m = cfg.moe
        E = m.n_experts_padded
        fl += 2 * D * E                              # router (replicated f32)
        # expert FFN: k*cf capacity slots per token, experts sharded over TP
        fl += 2 * 3 * D * m.top_k * m.capacity_factor * m.d_ff_expert / TP
        if m.d_ff_shared:
            fl += 2 * 3 * D * (m.d_ff_shared / TP)
        # (GShard dispatch/combine einsums are O(S) per token and added at
        #  sequence level by _moe_dispatch_flops_per_device)
    if cfg.family in ("ssm", "hybrid") and cfg.ssm:
        s = cfg.ssm
        d_in = 2 * s.expand * D + 2 * s.d_state + (s.expand * D // s.head_dim)
        h_loc = (s.expand * D // s.head_dim) / TP
        p, n, L = s.head_dim, s.d_state, s.chunk
        fl_ssm = 2 * D * (d_in / TP)                  # in_proj
        fl_ssm += 2 * (s.expand * D / TP) * D         # out_proj
        fl_ssm += 2 * s.d_conv * (s.expand * D + 2 * n)  # conv (cheap)
        # SSD per token: cb (2*L*n) + att*x (2*L*h*p) + states (2*h*p*n/L ...)
        fl_ssm += 2 * L * n                           # cb einsum (B/C shared)
        fl_ssm += 2 * L * h_loc * p                   # intra-chunk AV
        fl_ssm += 2 * 2 * h_loc * p * n               # states + y_inter
        fl = fl + fl_ssm if cfg.family == "ssm" else fl_ssm + _hybrid_attn_frac(cfg) * fl
    return fl


def _hybrid_attn_frac(cfg: ArchConfig) -> float:
    """Hybrid: the shared attn+MLP block runs once per `hybrid_every` ssm
    layers; amortize its flops across the stack."""
    return 1.0 / cfg.hybrid_every if cfg.hybrid_every else 0.0


def _moe_dispatch_flops_per_device(cfg: ArchConfig, tokens_local: float,
                                   S_mb: int) -> float:
    """GShard dense dispatch/combine einsum flops (per device, per layer):
    dispatch bsd,bsec->becd + combine becd,bsec->bsd = 2 * 2*T*E*C*D with
    E*C = k*cf*group (group = routing group size, default the full row)."""
    m = cfg.moe
    group = m.group_size if m.group_size else S_mb
    ec = m.top_k * m.capacity_factor * min(group, S_mb)
    return 2 * 2 * tokens_local * ec * cfg.d_model


@dataclasses.dataclass
class AnalyticCosts:
    flops_per_device: float
    hbm_bytes_per_device: float
    model_flops_global: float
    params_global: float
    notes: str = ""


def analytic_costs(cfg: ArchConfig, shape: ShapeSpec, n_chips: int,
                   microbatches: int = 1, remat: str = "full",
                   dp_shards: Optional[int] = None) -> AnalyticCosts:
    """Per-device per-step FLOPs and HBM-byte estimates."""
    dp = dp_shards or (n_chips // TP)
    B, S = shape.global_batch, shape.seq_len
    L_layers = cfg.n_layers
    D = cfg.d_model

    params = count_params(cfg)
    if shape.kind == "decode":
        tokens_local = max(1.0, B / dp) * 1          # one token per seq
        ctx = S
        fwd = tokens_local * L_layers * _layer_fwd_flops_per_token(
            cfg, ctx, 1)
        if cfg.family == "moe":
            fwd += L_layers * _moe_dispatch_flops_per_device(cfg, tokens_local, 1)
        fwd += tokens_local * 2 * D * (cfg.vocab_padded / TP)   # unembed
        flops = fwd
        # decode memory: params (bf16) + KV/state cache read per token
        pbytes = params * 2 / n_chips
        cache = cache_bytes(cfg, B, S) / n_chips
        hbm = pbytes + cache
        mf = model_flops_per_token(cfg) * B
    else:
        tokens_local = B * S / dp
        S_mb = S  # microbatching splits batch, not seq
        fwd = tokens_local * L_layers * _layer_fwd_flops_per_token(cfg, S, S)
        if cfg.family == "moe":
            fwd += L_layers * _moe_dispatch_flops_per_device(
                cfg, tokens_local / microbatches, S_mb) * microbatches
        fwd += tokens_local * 2 * D * (cfg.vocab_padded / TP)
        if shape.kind == "train":
            mult = 3.0 + (1.0 if remat == "full" else 0.0)  # fwd+bwd(2)+remat
            flops = fwd * mult
        else:
            flops = fwd
        # memory: params read ~3x (fwd, bwd) + opt update (f32 read+write) +
        # activations written+read once per layer boundary
        pshard = params / n_chips
        act = tokens_local * D * L_layers * 2 * 2     # bf16, write+read
        if shape.kind == "train":
            hbm = pshard * (2 * 3 + 4 * 3) + act * (2 if remat == "full" else 1)
        else:
            hbm = pshard * 2 + act
        mf = model_flops_per_token(cfg) * B * S * \
            (3.0 if shape.kind == "train" else 1.0)

    return AnalyticCosts(flops_per_device=flops, hbm_bytes_per_device=hbm,
                         model_flops_global=mf, params_global=params)


def count_params(cfg: ArchConfig, padded: bool = True) -> float:
    """padded=True mirrors the compiled program (TP head/vocab/expert
    padding); padded=False is the true architecture (MODEL_FLOPS basis)."""
    D, L = cfg.d_model, cfg.n_layers
    vocab = cfg.vocab_padded if padded else cfg.vocab
    p = vocab * D * 2  # embed + unembed
    if cfg.n_heads:
        Hq = cfg.n_heads_padded if padded else cfg.n_heads
        Hkv = cfg.n_kv_heads_eff if padded else cfg.n_kv_heads
        dh = cfg.head_dim
        attn = D * Hq * dh * 2 + D * Hkv * dh * 2
    else:
        attn = 0.0
    per = 0.0
    if cfg.family in ("dense", "moe", "encoder", "vlm"):
        per += attn
        if cfg.family == "moe":
            m = cfg.moe
            E = m.n_experts_padded if padded else m.n_experts
            per += D * E                    # router
            per += E * 3 * D * m.d_ff_expert
            per += 3 * D * m.d_ff_shared
        else:
            n_mats = 2 if cfg.family == "encoder" else 3
            per += n_mats * D * cfg.d_ff
    if cfg.family in ("ssm", "hybrid"):
        s = cfg.ssm
        di = s.expand * D
        d_in = 2 * di + 2 * s.d_state + di // s.head_dim
        per += D * d_in + di * D + s.d_conv * (di + 2 * s.d_state)
    p += per * L
    if cfg.hybrid_every:
        shared = attn + 3 * D * cfg.d_ff
        p += shared * cfg.n_shared_blocks
    return p


def active_params(cfg: ArchConfig) -> float:
    """True parameters touched per token (MoE: top_k experts + shared)."""
    if cfg.family != "moe":
        return count_params(cfg, padded=False)
    m = cfg.moe
    D, L = cfg.d_model, cfg.n_layers
    p = cfg.vocab * D * 2
    dh = cfg.head_dim
    per = D * cfg.n_heads * dh * 2 + D * cfg.n_kv_heads * dh * 2
    per += m.top_k * 3 * D * m.d_ff_expert + 3 * D * m.d_ff_shared
    per += D * m.n_experts
    return p + per * L


def model_flops_per_token(cfg: ArchConfig) -> float:
    """MODEL_FLOPS/token = 6*N (dense) or 6*N_active (MoE), forward+backward
    counted by the caller via the x3 train multiplier (so this returns 2*N:
    the forward matmul flops)."""
    return 2.0 * active_params(cfg)


def cache_bytes(cfg: ArchConfig, B: int, S: int, dtype_bytes: int = 2) -> float:
    if cfg.family in ("dense", "moe", "vlm"):
        return (cfg.n_layers * 2 * B * S * cfg.n_kv_heads_eff *
                cfg.head_dim * dtype_bytes)
    if cfg.family == "ssm":
        s = cfg.ssm
        h = s.expand * cfg.d_model // s.head_dim
        return cfg.n_layers * B * h * s.head_dim * s.d_state * 4
    if cfg.family == "hybrid":
        s = cfg.ssm
        h = s.expand * cfg.d_model // s.head_dim
        ssm = cfg.n_layers * B * h * s.head_dim * s.d_state * 4
        groups = cfg.n_layers // cfg.hybrid_every
        attn = groups * 2 * B * S * cfg.n_kv_heads_eff * cfg.head_dim * \
            dtype_bytes
        return ssm + attn
    return 0.0


def roofline_terms(flops_dev: float, hbm_dev: float, coll_dev: float,
                   model_flops_dev: Optional[float] = None) -> Dict:
    compute_s = flops_dev / PEAK_FLOPS_BF16
    memory_s = hbm_dev / HBM_BW
    coll_s = coll_dev / ICI_BW_PER_LINK
    terms = {"compute_s": compute_s, "memory_s": memory_s,
             "collective_s": coll_s}
    dom = max(terms, key=terms.get)
    bound = max(terms.values())
    terms["dominant"] = dom
    terms["step_lower_bound_s"] = bound
    # roofline fraction — USEFUL (model) flop-time over the step bound:
    # 1.0 means every cycle of the bound does model math at peak; padding,
    # dispatch einsums, remat and comm-boundness all pull it down.
    useful = (model_flops_dev if model_flops_dev is not None else flops_dev)
    terms["roofline_fraction"] = (useful / PEAK_FLOPS_BF16) / bound \
        if bound > 0 else 0.0
    return terms


# ---------------------------------------------------------------------------
# Collective count of a sharded torch step
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class CollectiveStats:
    """The JAX module's fields: bytes by kind (over `COLLECTIVES`) and by
    process-group size, the number of collectives, and
    ``tpu_corrected_bytes``, which equals ``total_bytes`` here: the JAX
    module halves activation-shaped f32 collectives because XLA:CPU
    normalises bf16 dots to f32 before partitioning, which DTensor does
    not.  ``calls`` lists each collective as ``(kind, group ranks, bytes,
    shape, dtype)``, the counterpart of the HLO lines
    `parse_collectives` reads; ``sites``, filled only when
    `count_collectives` is asked for them, is the parallel list of where
    each was issued (the HLO line's ``op_name``)."""
    total_bytes: int
    by_kind: Dict[str, int]
    by_group_size: Dict[int, int]
    ops: int
    tpu_corrected_bytes: int = 0
    calls: List[Tuple] = dataclasses.field(default_factory=list)
    sites: List[str] = dataclasses.field(default_factory=list)


def _collective_kinds():
    """``torch.ops`` overload packets of the functional collectives
    DTensor issues, by the HLO name of their kind."""
    funcol = torch.ops._c10d_functional
    kinds = {funcol.all_gather_into_tensor: "all-gather",
             funcol.all_gather_into_tensor_coalesced: "all-gather",
             funcol.all_reduce: "all-reduce",
             funcol.all_reduce_coalesced: "all-reduce",
             funcol.reduce_scatter_tensor: "reduce-scatter",
             funcol.reduce_scatter_tensor_coalesced: "reduce-scatter",
             funcol.all_to_all_single: "all-to-all",
             funcol.broadcast: "broadcast",
             torch.ops._dtensor.shard_dim_alltoall: "all-to-all"}
    return kinds


_HERE = os.path.abspath(__file__)
_PACKAGE = os.path.dirname(os.path.dirname(_HERE))
# the placement helpers (`shard_hint`, `on_blocks`, `column_groups`, ...):
# a collective they issue is sited at the model or step code calling them
_HELPERS = os.path.join(_PACKAGE, "distributed", "sharding.py")


def _site() -> str:
    """Where a collective is issued: in a backward pass ``"backward of
    <node>"``, the autograd node running (autograd runs a CUDA backward on
    a thread of its own, with no frame of the port); else ``"file:line
    function"`` of the innermost frame of the port's package outside this
    module and the placement helpers of `distributed.sharding` (paths
    relative to the package), or "?"."""
    node = torch._C._current_autograd_node()
    if node is not None:
        return f"backward of {node.name()}"
    f = sys._getframe(1)
    while f is not None:
        path = os.path.abspath(f.f_code.co_filename)
        if path.startswith(_PACKAGE + os.sep) and path not in (_HERE,
                                                               _HELPERS):
            return (f"{os.path.relpath(path, _PACKAGE)}:{f.f_lineno} "
                    f"{f.f_code.co_name}")
        f = f.f_back
    return "?"


def count_collectives(fn, *args, sites: bool = False, on_local=None,
                      **kwargs):
    """Run ``fn(*args, **kwargs)`` once and count the collectives it
    issues on this rank: returns ``(out, CollectiveStats)``.  Each
    ``_c10d_functional`` collective (and DTensor's ``shard_dim_alltoall``)
    is counted by its kind, by the size of its process group and by the
    bytes of its result on this rank, the per-device shape
    `parse_collectives` reads first on an HLO line: the gathered block of
    an all-gather, the kept block of a reduce-scatter.  The counter is a
    ``TorchDispatchMode`` that lets DTensor ops through to DTensor (so it
    sees the collectives they lower to), as
    ``torch.distributed.tensor.debug.CommDebugMode`` does.  A broadcast,
    which has no HLO kind here, is counted under ``"broadcast"``.  On
    plain tensors it counts nothing.  With ``sites``, each collective's
    ``CollectiveStats.sites`` entry is the innermost frame of the port's
    package that issued it (`_site`).  ``on_local(func, args, kwargs,
    out)``, if given, is called after each op run on this rank's plain
    tensors (not on the fake tensors DTensor's sharding propagation runs
    the global op on)."""
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group
    from torch.distributed.tensor import DTensor
    from torch.utils._python_dispatch import TorchDispatchMode

    kinds = _collective_kinds()
    calls: List[Tuple] = []
    where: List[str] = []

    class _Counter(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            if isinstance(func, torch._ops.HigherOrderOperator):
                return func(*args, **kwargs)
            if any(issubclass(t, DTensor) for t in types):
                return NotImplemented     # DTensor lowers it first
            out = func(*args, **kwargs)
            if on_local is not None and all(t is torch.Tensor
                                            for t in types):
                on_local(func, args, kwargs, out)
            kind = kinds.get(func._overloadpacket)
            if kind is not None:
                # the group's name is the op's last string argument (a
                # reduction's op name comes before it)
                group = [a for a in list(args) + list(kwargs.values())
                         if isinstance(a, str)][-1]
                ranks = tuple(dist.get_process_group_ranks(
                    _resolve_process_group(group)))
                site = _site() if sites else None
                for t in (out if isinstance(out, (list, tuple)) else [out]):
                    calls.append((kind, ranks,
                                  t.numel() * t.element_size(),
                                  tuple(t.shape), t.dtype))
                    if sites:
                        where.append(site)
            return out

    with _Counter():
        out = fn(*args, **kwargs)
    by_kind = {k: 0 for k in COLLECTIVES}
    by_gs: Dict[int, int] = {}
    for kind, ranks, nbytes, _, _ in calls:
        by_kind[kind] = by_kind.get(kind, 0) + nbytes
        by_gs[len(ranks)] = by_gs.get(len(ranks), 0) + nbytes
    total = sum(c[2] for c in calls)
    return out, CollectiveStats(total_bytes=total, by_kind=by_kind,
                                by_group_size=by_gs, ops=len(calls),
                                tpu_corrected_bytes=total, calls=calls,
                                sites=where)
