"""Mamba2 (SSD, state-space duality) block: chunked scan + O(1) decode.
The port of `repro.models.mamba2`.

The sequence is split into chunks; within a chunk the quadratic
"attention-like" form is used, and a small recurrence carries the
(heads, head_dim, d_state) state across chunks (Dao & Gu,
arXiv:2405.21060).  `ssd_chunked_ref` is the model's own reference;
``impl="kernel"`` runs the hand-written CUDA SSD kernel
(`repro_torch.kernels.ssd_scan`; the JAX package's ``"pallas"``).

Scalar-A parameterization: per-head decay a_t = exp(dt * -exp(A_log)),
B/C shared across heads (one group).  d_inner = n_heads * head_dim.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate, Shard

import repro_torch
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.sharding import shard_hint
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.models.layers import _normal, cast

__all__ = ["MambaConfig", "init_mamba", "gated_rms_norm", "ssd_chunked",
           "ssd_chunked_ref", "mamba_block", "init_mamba_cache",
           "mamba_decode_step"]


@dataclasses.dataclass(frozen=True)
class MambaConfig:
    d_model: int
    d_state: int = 128
    head_dim: int = 64
    expand: int = 2
    d_conv: int = 4
    chunk: int = 128

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def n_heads(self) -> int:
        return self.d_inner // self.head_dim


def init_mamba(gen: torch.Generator, cfg: MambaConfig, dtype=torch.float32):
    di, hs = cfg.d_inner, cfg.n_heads
    # in_proj packs [z (gate), x, B, C, dt] as in the reference implementation
    d_in_proj = 2 * di + 2 * cfg.d_state + hs
    conv_dim = di + 2 * cfg.d_state
    dev = gen.device
    lin = torch.linspace(1e-3, 1e-1, hs, dtype=torch.float32, device=dev)
    return {
        "in_proj": _normal(gen, (cfg.d_model, d_in_proj), dtype)
        * cfg.d_model ** -0.5,
        "conv_w": _normal(gen, (cfg.d_conv, conv_dim), dtype) * 0.2,
        "conv_b": torch.zeros((conv_dim,), dtype=dtype, device=dev),
        "dt_bias": torch.log(torch.expm1(lin.to(dtype))),
        "A_log": torch.log(torch.linspace(1.0, 16.0, hs, dtype=torch.float32,
                                          device=dev).to(dtype)),
        "D": torch.ones((hs,), dtype=dtype, device=dev),
        "norm_w": torch.zeros((di,), dtype=dtype, device=dev),
        "out_proj": _normal(gen, (di, cfg.d_model), dtype) * di ** -0.5,
    }


def _split_proj(cfg: MambaConfig, zxbcdt: torch.Tensor):
    di, ds = cfg.d_inner, cfg.d_state
    z = zxbcdt[..., :di]
    x = zxbcdt[..., di:2 * di]
    B = zxbcdt[..., 2 * di:2 * di + ds]
    C = zxbcdt[..., 2 * di + ds:2 * di + 2 * ds]
    dt = zxbcdt[..., 2 * di + 2 * ds:]
    return z, x, B, C, dt


def _proj_and_conv(params, cfg: MambaConfig, x: torch.Tensor,
                   compute_dtype, state: Optional[torch.Tensor] = None):
    """The in-projection, its five-way split and the causal conv: ``(z,
    x, B, C, dt, new conv state)``, x, B and C through the conv.  Where
    DTensor ``in_proj``'s columns are split (over "model"), its five
    column groups and the three channel groups of ``conv_w`` and
    ``conv_b`` are separate products (`shd.column_groups`), each placed
    for its consumer: z, x and dt split by heads, as the scan and the
    norm take them; B and C whole on every rank (the heads share them).
    The packed product's shards end at offsets that are no group's
    boundaries, so splitting it would move activations of the
    projection's width between ranks; the groups move only the weights.
    A decode step (one position a row, ``state`` the last K-1 conv
    inputs) splits the packed product: its activations are a few rows,
    the weights thousands (zamba2-2.7b ``decode_32k`` on 16 x 16: the 54
    in-projections' weights 2.89 GB a token, their products 9 MB)."""
    di, ds = cfg.d_inner, cfg.d_state
    w, cw, cb = params["in_proj"], params["conv_w"], params["conv_b"]
    if not (isinstance(w, DTensor) and Shard(w.ndim - 1) in w.placements
            and state is None and x.shape[1] > 1):
        zxbcdt = cast(x, compute_dtype) @ cast(w, compute_dtype)
        z, xs, B, C, dt = _split_proj(cfg, zxbcdt)
        conv_in = torch.cat([xs, B, C], dim=-1)
        conv_out, new_state = _causal_conv(
            conv_in, cast(cw, compute_dtype), cast(cb, compute_dtype), state)
        return (z, conv_out[..., :di], conv_out[..., di:di + ds],
                conv_out[..., di + ds:], dt, new_state)
    heads = _head_dims(cfg, w)

    def placed(t, by_heads: bool):
        last = t.ndim - 1
        return [Shard(last) if by_heads and m in heads else
                Replicate() if p == Shard(last) else p
                for m, p in enumerate(t.placements)]

    wz, wx, wb, wc, wdt = shd.column_groups(
        w, (di, di, ds, ds, cfg.n_heads),
        [placed(w, h) for h in (True, True, False, False, True)])
    cws, cbs = (shd.column_groups(t, (di, ds, ds),
                                  [placed(t, h) for h in (True, False, False)])
                for t in (cw, cb))
    xc = cast(x, compute_dtype)
    z, xs, B, C, dt = (xc @ cast(g, compute_dtype)
                       for g in (wz, wx, wb, wc, wdt))
    xs, B, C = (_causal_conv(a, cast(cwg, compute_dtype),
                             cast(cbg, compute_dtype))[0]
                for a, cwg, cbg in zip((xs, B, C), cws, cbs))
    return z, xs, B, C, dt, None


def _head_dims(cfg: MambaConfig, w) -> set:
    """The mesh dims that split DTensor ``w``'s columns and that the
    active rules split the heads over, where they split the heads
    evenly; else none (the groups whole on every rank)."""
    hp = shd.hint_placements("heads") or []
    dims = {m for m, p in enumerate(hp)
            if p == Shard(0) and w.placements[m] == Shard(w.ndim - 1)}
    ways = math.prod(w.device_mesh.size(m) for m in dims)
    return dims if cfg.n_heads % ways == 0 else set()


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: Optional[torch.Tensor] = None):
    """Depthwise causal conv1d.  x: (B,S,C); w: (K,C); returns (y, new_state)
    where state is the last K-1 inputs (for decode)."""
    K = w.shape[0]
    if state is None:
        pad = torch.zeros((x.shape[0], K - 1, x.shape[2]), dtype=x.dtype,
                          device=x.device)
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)                            # (B,S+K-1,C)
    S = x.shape[1]
    y = 0
    for i in range(K):
        y = y + xp[:, i:i + S] * w[i]
    y = y + b
    new_state = xp[:, -(K - 1):] if K > 1 else None
    return F.silu(y), new_state


def gated_rms_norm(x: torch.Tensor, z: torch.Tensor, weight: torch.Tensor,
                   eps: float = 1e-6) -> torch.Tensor:
    """Mamba2's norm: RMSNorm(x * silu(z)) * w.  On DTensors split along
    d_inner the mean square is each rank's pending sum, all-reduced
    (`shd.reduce_partial`), and nothing of d_inner's width moves."""
    h = x * F.silu(z)
    hf = h.float()
    var = shd.reduce_partial((hf * hf).mean(dim=-1, keepdim=True))
    out = hf * torch.rsqrt(var + eps) * (1.0 + weight.float())
    return out.to(x.dtype)


def ssd_chunked(x, dt, A, B, C, D, chunk: int, initial_state=None,
                impl: str = "ref"):
    """SSD scan.  Shapes:
      x: (b, S, h, p)   dt: (b, S, h)   A: (h,)  [negative decay rates]
      B, C: (b, S, n)   D: (h,)
    Returns (y: (b,S,h,p), final_state: (b,h,p,n)).  On DTensors the scan
    runs on each rank's (batch, heads) block (`_ssd_on_blocks`).
    """
    if isinstance(x, DTensor):
        if initial_state is not None:
            raise NotImplementedError("ssd_chunked on DTensors starts from "
                                      "the zero state (prefill, training)")
        return _ssd_on_blocks(x, dt, A, B, C, D, chunk, impl)
    if impl == "kernel":
        return ssd_ops.ssd_scan(x, dt, A, B, C, D, chunk=chunk,
                                initial_state=initial_state)
    if impl != "ref":
        raise ValueError(f"ssd impl {impl!r}: expected 'ref' or 'kernel'")
    return ssd_chunked_ref(x, dt, A, B, C, D, chunk, initial_state)


def _ssd_on_blocks(x, dt, A, B, C, D, chunk: int, impl: str):
    """The scan on each rank's block of DTensors (`shd.on_blocks`): it is
    independent per batch row and per head, so x and dt keep the batch and
    head mesh dims x's hint gave them, A and D (per head) the head dims,
    B and C (shared by the heads) the batch dims; everything else whole."""
    xpl, apl, bpl, spl = [], [], [], []
    for p in x.placements:
        if p == Shard(0) or p == Shard(2):
            xpl.append(p)
        else:
            xpl.append(Replicate())
        apl.append(Shard(0) if p == Shard(2) else Replicate())
        bpl.append(p if p == Shard(0) else Replicate())
        spl.append(Shard(1) if p == Shard(2) else bpl[-1])

    def local(xl, dtl, al, bl, cl, dl):
        return ssd_chunked(xl, dtl, al, bl, cl, dl, chunk, impl=impl)

    return shd.on_blocks(local, (xpl, xpl, apl, bpl, bpl, apl), (xpl, spl),
                         x, dt, A, B, C, D)


def ssd_chunked_ref(x, dt, A, B, C, D, chunk: int, initial_state=None):
    b, S, h, p = x.shape
    n = B.shape[-1]
    nc = max(1, (S + chunk - 1) // chunk)
    L = -(-S // nc)  # chunk length
    if nc * L != S:
        raise ValueError("seq must divide into equal chunks")
    dev = x.device

    xf = x.float().reshape(b, nc, L, h, p)
    dtf = F.softplus(dt.float()).reshape(b, nc, L, h)
    Bf = B.float().reshape(b, nc, L, n)
    Cf = C.float().reshape(b, nc, L, n)
    Af = A.float()

    # per-step log decay: (b,nc,L,h)
    dA = dtf * Af[None, None, None, :]
    seg = torch.cumsum(dA, dim=2)                     # cumulative within chunk

    # intra-chunk (quadratic) term; mask BEFORE the exp: the upper
    # triangle has positive exponents whose overflow would give inf * 0.
    diff = seg[:, :, :, None, :] - seg[:, :, None, :, :]   # (b,nc,L,L,h)
    mask = torch.tril(torch.ones((L, L), dtype=torch.bool, device=dev))
    decay = torch.exp(torch.where(mask[None, None, :, :, None], diff,
                                  -math.inf))
    cb = torch.einsum("bcln,bcmn->bclm", Cf, Bf)      # (b,nc,L,L)
    att = cb[..., None] * decay * dtf[:, :, None, :, :]
    y_intra = torch.einsum("bclmh,bcmhp->bclhp", att, xf)

    # chunk summaries: state contribution of each chunk
    chunk_decay = torch.exp(seg[:, :, -1:, :] - seg)  # decay to chunk end
    states = torch.einsum("bclh,bcln,bclhp->bchpn",
                          chunk_decay * dtf, Bf, xf)  # (b,nc,h,p,n)

    # inter-chunk recurrence over nc chunks
    total = torch.exp(seg[:, :, -1, :])               # (b,nc,h)
    st = (initial_state.float() if initial_state is not None
          else torch.zeros((b, h, p, n), dtype=torch.float32, device=dev))
    before = []
    for c in range(nc):
        before.append(st)                             # state BEFORE chunk c
        st = st * total[:, c, :, None, None] + states[:, c]
    st_before = torch.stack(before, dim=1)            # (b,nc,h,p,n)

    # inter-chunk contribution: y_inter[t] = C_t . (decay_to_t * state_in)
    in_decay = torch.exp(seg)                         # decay from chunk start
    y_inter = torch.einsum("bcln,bclh,bchpn->bclhp", Cf, in_decay, st_before)

    y = (y_intra + y_inter).reshape(b, S, h, p)
    y = y + xf.reshape(b, S, h, p) * D.float()[None, None, :, None]
    return y.to(x.dtype), st


def mamba_block(params, cfg: MambaConfig, x: torch.Tensor,
                compute_dtype=torch.bfloat16, impl: str = "ref"):
    """Full Mamba2 block (training / prefill).  x: (B,S,d_model)."""
    Bsz, S, _ = x.shape
    z, xs, B, C, dt, _ = _proj_and_conv(params, cfg, x, compute_dtype)
    xh = xs.reshape(Bsz, S, cfg.n_heads, cfg.head_dim)
    xh = shard_hint(xh, "batch", "seq", "heads", "null")
    dt = dt + cast(params["dt_bias"], compute_dtype)
    A = -torch.exp(params["A_log"].float())
    y, _ = ssd_chunked(xh, dt, A, B, C, params["D"], cfg.chunk, impl=impl)
    y = y.reshape(Bsz, S, cfg.d_inner)
    y = gated_rms_norm(y, z, params["norm_w"])
    return cast(y, compute_dtype) @ cast(params["out_proj"], compute_dtype)


# -- decode (O(1) per token) -------------------------------------------------------

def init_mamba_cache(batch: int, cfg: MambaConfig, dtype=torch.float32,
                     device=None):
    dev = repro_torch.resolve_device(device)
    conv_dim = cfg.d_inner + 2 * cfg.d_state
    return {
        "conv": torch.zeros((batch, cfg.d_conv - 1, conv_dim), dtype=dtype,
                            device=dev),
        "ssm": torch.zeros((batch, cfg.n_heads, cfg.head_dim, cfg.d_state),
                           dtype=dtype, device=dev),
    }


def mamba_decode_step(params, cfg: MambaConfig, x: torch.Tensor, cache,
                      compute_dtype=torch.bfloat16):
    """x: (B,1,d_model) -> (y, new_cache).  Constant work per token."""
    Bsz = x.shape[0]
    z, xs, B, C, dt, conv_state = _proj_and_conv(params, cfg, x,
                                                 compute_dtype, cache["conv"])
    xh = xs.reshape(Bsz, cfg.n_heads, cfg.head_dim).float()
    dtv = F.softplus((dt[:, 0] + params["dt_bias"]).float())
    A = -torch.exp(params["A_log"].float())
    dec = torch.exp(dtv * A[None, :])                      # (B,h)
    Bv = B[:, 0].float()                                   # (B,n)
    Cv = C[:, 0].float()
    st = cache["ssm"].float()
    st = st * dec[..., None, None] + torch.einsum(
        "bh,bhp,bn->bhpn", dtv, xh, Bv)
    y = torch.einsum("bhpn,bn->bhp", st, Cv) + xh * params["D"].float()[
        None, :, None]
    y = y.reshape(Bsz, 1, cfg.d_inner)
    y = gated_rms_norm(y.to(compute_dtype), z, params["norm_w"])
    out = cast(y, compute_dtype) @ cast(params["out_proj"], compute_dtype)
    return out, {"conv": conv_state.to(cache["conv"].dtype),
                 "ssm": st.to(cache["ssm"].dtype)}
