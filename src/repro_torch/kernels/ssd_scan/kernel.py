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

__all__ = ["ssd_scan_grid", "check_args"]

#: CUDA launches of one call: C.B^T per (batch, chunk); seg and the chunk
#: states; the carry across chunks; y
LAUNCHES_PER_CALL = 4


def check_args(x_shape, dt_shape, dA_shape, B_shape, C_shape,
               block_h: int = 8, dtypes=None) -> None:
    """The wrapper's checks on shapes and dtypes alone: x (B, H, nc, L, p),
    dt and dA (B, H, nc, L), Bm and Cm (B, nc, L, n), and ``block_h``
    dividing H once capped at H, as the Pallas grid takes them (any B, H,
    chunk count, chunk L, head dim p and state n); with ``dtypes`` (the five
    inputs'), the CUDA kernel's too: all float32.  Raises ValueError or
    TypeError."""
    x_shape, dt_shape, dA_shape, B_shape, C_shape = (
        tuple(s) for s in (x_shape, dt_shape, dA_shape, B_shape, C_shape))
    if len(x_shape) != 5 or dt_shape != x_shape[:4] or dA_shape != dt_shape \
            or len(B_shape) != 4 \
            or B_shape[:3] != (x_shape[0], x_shape[2], x_shape[3]) \
            or C_shape != B_shape:
        raise ValueError(f"ssd_scan: shapes x {x_shape}, dt {dt_shape}, dA "
                         f"{dA_shape}, B {B_shape}, C {C_shape}")
    H = x_shape[1]
    if H % min(block_h, H) != 0:
        raise ValueError(f"ssd_scan: block_h {block_h} does not divide {H} "
                         f"heads")
    if dtypes is not None and any(d != torch.float32 for d in dtypes):
        raise TypeError(f"ssd_scan: dtypes {', '.join(map(str, dtypes))}; "
                        f"expected float32")


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
    inputs = (x, dt, dA, Bm, Cm)
    check_args(*(t.shape for t in inputs), block_h=block_h)
    Bsz, H, nc, L, p = x.shape
    n = Bm.shape[-1]
    _build.refuse_dtensor("ssd_scan", *inputs)
    _build.refuse_grad("ssd_scan", *inputs)
    if x.device.type == "cpu":
        # imported here: ref re-exports the model's ssd_chunked_ref, and
        # the model imports this module's entry point
        from repro_torch.kernels.ssd_scan.ref import ssd_scan_grid_ref
        _build.PLAIN_CALLS["ssd_scan"] += 1
        return ssd_scan_grid_ref(*inputs)
    check_args(*(t.shape for t in inputs), block_h=block_h,
               dtypes=tuple(t.dtype for t in inputs))
    _build.check_cuda("ssd_scan", *inputs)
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
