"""`ssd_scan_grid`: the wrapper of the CUDA SSD chunked-scan kernel
(`csrc/ssd_scan.cu`), the port of the Pallas kernel
`repro.kernels.ssd_scan.kernel.ssd_scan_grid`.

On CUDA tensors it launches the kernel's four stages (and counts each
launch in ``_build.LAUNCHES["ssd_scan"]``: `LAUNCHES_PER_CALL` a call) or
raises; on CPU tensors it runs the plain version, `ref.ssd_scan_grid_ref`,
and counts that in ``_build.PLAIN_CALLS``.  The kernel has no backward (the Pallas kernel has
none either), so on any device it refuses inputs that require grad while
grad mode is on, rather than return a result cut from the graph.  A DTensor
raises (`_build.refuse_dtensor`): the model runs the kernel on each rank's
block through `local_map`.
"""

from __future__ import annotations

import torch

from repro_torch import _build
from repro_torch.kernels.ssd_scan.ref import ssd_scan_grid_ref

__all__ = ["ssd_scan_grid"]

#: the largest chunk length, head dim and state width the kernel takes
MAX_CHUNK, MAX_HEAD_DIM, MAX_STATE = 128, 64, 128
#: CUDA launches of one call: C.B^T per (batch, chunk); seg and the chunk
#: states; the carry across chunks; y
LAUNCHES_PER_CALL = 4


def ssd_scan_grid(x: torch.Tensor, dt: torch.Tensor, dA: torch.Tensor,
                  Bm: torch.Tensor, Cm: torch.Tensor, *, block_h: int = 8):
    """x: (B, H, nc, L, p); dt, dA: (B, H, nc, L); Bm, Cm: (B, nc, L, n),
    all f32.  Returns (y (B, H, nc, L, p), final state (B, H, p, n) f32).

    ``block_h`` is accepted for signature parity with the Pallas kernel
    (heads per grid step there; the CUDA kernel runs one (head, chunk) per
    block) and must divide H once capped at H; it does not change the
    result.  On the card the wrapper allocates the stages' workspaces:
    C.B^T (B, nc, L, L), seg (B, H, nc, L) and the chunk states
    (B, H, nc, p, n)."""
    if x.dim() != 5 or tuple(dt.shape) != tuple(x.shape[:4]) \
            or dA.shape != dt.shape or Bm.dim() != 4 \
            or tuple(Bm.shape[:3]) != (x.shape[0], x.shape[2], x.shape[3]) \
            or Cm.shape != Bm.shape:
        raise ValueError(f"ssd_scan: shapes x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, dA {tuple(dA.shape)}, B "
                         f"{tuple(Bm.shape)}, C {tuple(Cm.shape)}")
    Bsz, H, nc, L, p = x.shape
    n = Bm.shape[-1]
    if H % min(block_h, H) != 0:
        raise ValueError(f"ssd_scan: block_h {block_h} does not divide {H} "
                         f"heads")
    _build.refuse_dtensor("ssd_scan", x, dt, dA, Bm, Cm)
    _build.refuse_grad("ssd_scan", x, dt, dA, Bm, Cm)
    if x.device.type == "cpu":
        _build.PLAIN_CALLS["ssd_scan"] += 1
        return ssd_scan_grid_ref(x, dt, dA, Bm, Cm)
    _build.check_cuda("ssd_scan", x, dt, dA, Bm, Cm,
                      dtypes=(torch.float32,) * 5)
    if not (1 <= L <= MAX_CHUNK and 1 <= p <= MAX_HEAD_DIM
            and 1 <= n <= MAX_STATE and nc >= 1):
        raise ValueError(f"ssd_scan: chunk {L} (max {MAX_CHUNK}), head dim "
                         f"{p} (max {MAX_HEAD_DIM}), state {n} (max "
                         f"{MAX_STATE}), {nc} chunks")
    y = torch.empty_like(x)
    st = torch.empty((Bsz, H, p, n), dtype=torch.float32, device=x.device)
    if Bsz * H == 0:
        return y, st
    f32 = dict(dtype=torch.float32, device=x.device)
    cb = torch.empty((Bsz, nc, L, L), **f32)
    seg = torch.empty((Bsz, H, nc, L), **f32)
    states = torch.empty((Bsz, H, nc, p, n), **f32)
    _build.call("ssd_scan", "ssd_scan_launch", _build.ptr(x), _build.ptr(dt),
                _build.ptr(dA), _build.ptr(Bm), _build.ptr(Cm), _build.ptr(y),
                _build.ptr(st), _build.ptr(cb), _build.ptr(seg),
                _build.ptr(states), Bsz, H, nc, L, p, n,
                _build.stream(x.device))
    _build.LAUNCHES["ssd_scan"] += LAUNCHES_PER_CALL
    return y, st
