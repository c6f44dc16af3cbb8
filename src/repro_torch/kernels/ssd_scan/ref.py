"""Plain PyTorch version of the SSD chunked-scan kernel's own function, in
the kernel's chunked layout: the oracle the CUDA `ssd_scan` kernel
(`csrc/ssd_scan.cu`) is held against.

`repro.kernels.ssd_scan.ref` in the JAX package re-exports the model's
reference (`models.mamba2.ssd_chunked_ref`, here
`repro_torch.models.mamba2.ssd_chunked_ref`); this module adds the chunked
form that the kernel computes, chunk by chunk as the Pallas grid does.
"""

from __future__ import annotations

import torch

__all__ = ["ssd_scan_grid_ref"]


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
        seg = torch.cumsum(dAf[:, :, c], dim=-1)                 # (B,H,L)
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
