"""Entry point for the SSD chunked-scan kernel in the model's layout, with
the same contract as `models.mamba2.ssd_chunked_ref`
(`repro.kernels.ssd_scan.ops.ssd_scan` in the JAX package).

softplus(dt) and dA = dt * A are taken in f32 outside the kernel, the
sequence is reshaped into chunks, and the D skip term is added after it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssd_scan.kernel import ssd_scan_grid

__all__ = ["ssd_scan"]


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor, D: torch.Tensor,
             chunk: int = 128, initial_state=None, block_h: int = 8):
    """x: (b, S, h, p); dt: (b, S, h) raw; A: (h,); B, C: (b, S, n);
    D: (h,).  Returns (y (b, S, h, p) in x's dtype, final state
    (b, h, p, n) f32)."""
    if initial_state is not None:
        raise NotImplementedError(
            "nonzero initial_state: prefill always starts from zero state; "
            "decode uses the O(1) recurrent step, not this kernel")
    b, S, h, p = x.shape
    n = B.shape[-1]
    nc = max(1, (S + chunk - 1) // chunk)
    L = -(-S // nc)
    if nc * L != S:
        raise ValueError(f"ssd_scan: seq {S} does not divide into equal "
                         f"chunks of at most {chunk}")
    if h % block_h != 0:
        block_h = 1

    dtv = F.softplus(dt.float())                                 # (b,S,h)
    dA = dtv * A.float()[None, None, :]

    xk = x.float().reshape(b, nc, L, h, p).permute(0, 3, 1, 2, 4).contiguous()
    dtk = dtv.reshape(b, nc, L, h).permute(0, 3, 1, 2).contiguous()
    dAk = dA.reshape(b, nc, L, h).permute(0, 3, 1, 2).contiguous()
    Bk = B.float().reshape(b, nc, L, n).contiguous()
    Ck = C.float().reshape(b, nc, L, n).contiguous()

    y, st = ssd_scan_grid(xk, dtk, dAk, Bk, Ck, block_h=block_h)
    y = y.permute(0, 2, 3, 1, 4).reshape(b, S, h, p)
    y = y + x.float() * D.float()[None, None, :, None]
    return y.to(x.dtype), st
