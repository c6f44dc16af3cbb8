"""Plain PyTorch version of the SSD chunked-scan kernel's own function, in
the kernel's chunked layout: the oracle the CUDA `ssd_scan` kernel
(`csrc/ssd_scan.cu`) is held against.

As `repro.kernels.ssd_scan.ref` in the JAX package, it re-exports the
model's reference, `repro_torch.models.mamba2.ssd_chunked_ref` (the same
object); it adds the chunked form that the kernel computes, chunk by chunk
as the Pallas grid does.

It also writes out, for the tests, the four stages in which the CUDA
kernel computes the same function (Mamba2's chunk-parallel
decomposition): `ssd_chunk_cb`, `ssd_chunk_states`, `ssd_carry_states`
and `ssd_chunk_outputs`, composed by `ssd_scan_stages_ref`.  No path of
the port runs them.
"""

from __future__ import annotations

import torch

from repro_torch.models.mamba2 import ssd_chunked_ref

__all__ = ["ssd_chunked_ref", "ssd_scan_grid_ref", "ssd_chunk_cb", "ssd_chunk_states",
           "ssd_carry_states", "ssd_chunk_outputs", "ssd_scan_stages_ref"]


def _cumsum_in_order(t: torch.Tensor) -> torch.Tensor:
    """cumsum along the last dim, one add at a time from the first element,
    on every device: the order of the kernel's seg and of the model's
    `ssd_chunked_ref` (which scans a non-innermost dim).  On CUDA,
    `torch.cumsum` along the innermost dim is a parallel scan that rounds
    otherwise; at a chunk of 256, |seg| ~ 180, that moved y by up to 1.1e-4
    on an H100."""
    return t.movedim(-1, 0).contiguous().cumsum(0).movedim(0, -1)


def ssd_scan_grid_ref(x: torch.Tensor, dt: torch.Tensor, dA: torch.Tensor,
                      Bm: torch.Tensor, Cm: torch.Tensor):
    """x: (B, H, nc, L, p); dt, dA: (B, H, nc, L); Bm, Cm: (B, nc, L, n);
    all f32.  Returns y (B, H, nc, L, p) in x's dtype and the final state
    (B, H, p, n) in f32."""
    Bsz, H, nc, L, p = x.shape
    n = Bm.shape[-1]
    xf, dtf, dAf = x.float(), dt.float(), dA.float()
    Bf, Cf = Bm.float(), Cm.float()
    state = torch.zeros((Bsz, H, p, n), dtype=torch.float32, device=x.device)
    tril = torch.tril(torch.ones((L, L), dtype=torch.bool, device=x.device))
    ys = []
    for c in range(nc):
        xc, dtc, Bc, Cc = xf[:, :, c], dtf[:, :, c], Bf[:, c], Cf[:, c]
        seg = _cumsum_in_order(dAf[:, :, c])                     # (B,H,L)
        # mask BEFORE the exp: the upper triangle's exponents are positive
        diff = seg[..., :, None] - seg[..., None, :]             # (B,H,L,L)
        decay = torch.exp(torch.where(tril, diff, -torch.inf))
        cb = torch.einsum("bln,bmn->blm", Cc, Bc)                # (B,L,L)
        att = cb[:, None] * decay * dtc[:, :, None, :]
        y_intra = torch.einsum("bhlm,bhmp->bhlp", att, xc)
        cs = torch.einsum("bhpn,bln->bhlp", state, Cc)
        ys.append(y_intra + cs * torch.exp(seg)[..., None])
        total = torch.exp(seg[..., -1])                          # (B,H)
        w = torch.exp(seg[..., -1:] - seg) * dtc                 # (B,H,L)
        newst = torch.einsum("bhlp,bln->bhpn", xc * w[..., None], Bc)
        state = state * total[..., None, None] + newst
    y = torch.stack(ys, dim=2)
    return y.to(x.dtype), state


def ssd_chunk_cb(Bm: torch.Tensor, Cm: torch.Tensor) -> torch.Tensor:
    """Stage 1, per (batch, chunk), shared by the heads: C . B^T,
    (B, nc, L, n) x 2 -> (B, nc, L, L).  Only m <= l is used later."""
    return torch.einsum("bcln,bcmn->bclm", Cm.float(), Bm.float())


def ssd_chunk_states(x: torch.Tensor, dt: torch.Tensor, dA: torch.Tensor,
                     Bm: torch.Tensor):
    """Stage 2, per (batch, head, chunk): seg = cumsum(dA) over the chunk
    (B, H, nc, L), and the chunk's own state contribution
    sum_l exp(seg_{L-1} - seg_l) dt_l x_l B_l^T, (B, H, nc, p, n)."""
    seg = _cumsum_in_order(dA.float())
    w = torch.exp(seg[..., -1:] - seg) * dt.float()
    contrib = torch.einsum("bhclp,bcln->bhcpn", x.float() * w[..., None],
                           Bm.float())
    return seg, contrib


def ssd_carry_states(seg: torch.Tensor, contrib: torch.Tensor):
    """Stage 3, along the chunks: S_c = S_{c-1} exp(seg_{L-1,c}) +
    contribution_c from S_{-1} = 0.  Returns the state entering each chunk
    (B, H, nc, p, n) and the final state (B, H, p, n)."""
    total = torch.exp(seg[..., -1])                          # (B,H,nc)
    state = torch.zeros_like(contrib[:, :, 0])
    entering = []
    for c in range(contrib.shape[2]):
        entering.append(state)
        state = state * total[:, :, c, None, None] + contrib[:, :, c]
    return torch.stack(entering, dim=2), state


def ssd_chunk_outputs(x: torch.Tensor, dt: torch.Tensor, Cm: torch.Tensor,
                      cb: torch.Tensor, seg: torch.Tensor,
                      s_in: torch.Tensor) -> torch.Tensor:
    """Stage 4, per (batch, head, chunk): y = (CB o decay o dt) . x +
    exp(seg) o (C . S_in^T), the decay exp(seg_l - seg_m) taken only for
    m <= l (masked before the exp).  Returns y (B, H, nc, L, p) in f32."""
    L = x.shape[3]
    tril = torch.tril(torch.ones((L, L), dtype=torch.bool, device=x.device))
    diff = seg[..., :, None] - seg[..., None, :]             # (B,H,nc,L,L)
    decay = torch.exp(torch.where(tril, diff, -torch.inf))
    att = cb[:, None] * decay * dt.float()[..., None, :]
    y_intra = torch.einsum("bhclm,bhcmp->bhclp", att, x.float())
    y_inter = torch.einsum("bhcpn,bcln->bhclp", s_in, Cm.float())
    return y_intra + y_inter * torch.exp(seg)[..., None]


def ssd_scan_stages_ref(x: torch.Tensor, dt: torch.Tensor, dA: torch.Tensor,
                        Bm: torch.Tensor, Cm: torch.Tensor):
    """The four stages composed: the same (y, final state) as
    `ssd_scan_grid_ref`, with the state carried across chunks only in
    stage 3."""
    cb = ssd_chunk_cb(Bm, Cm)
    seg, contrib = ssd_chunk_states(x, dt, dA, Bm)
    s_in, final = ssd_carry_states(seg, contrib)
    y = ssd_chunk_outputs(x, dt, Cm, cb, seg, s_in)
    return y.to(x.dtype), final
