"""Int8 error-feedback gradient compression for the cross-pod axis.  The
port of `repro.optim.grad_compress`, with the same arithmetic.

Gradients crossing the scarcest links are quantized to int8 with
per-tensor scales, and the quantization residual is fed back into the
next step (error feedback keeps the compression unbiased over time).  On
one card there is no cross-pod mean: `compress_grads` models the
information loss exactly, as the JAX function does on a mesh without a
``pod`` axis.  ``torch.round`` rounds half to even, as ``jnp.round``
does, so the two agree bit for bit.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch._tree import tree_map

__all__ = ["init_error_state", "abstract_error_state", "compress_tensor",
           "compress_grads"]


def init_error_state(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def abstract_error_state(params):
    """:func:`init_error_state`'s tree as "meta" tensors (shapes and
    dtypes; no memory), whatever device ``params`` lie on."""
    return tree_map(lambda p: torch.empty(p.shape, dtype=torch.float32,
                                          device="meta"), params)


def _quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    scale = torch.max(torch.abs(x)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def compress_tensor(g: torch.Tensor, err: torch.Tensor):
    """Quantize (g + err) to int8; return (dequantized, new_err)."""
    gf = g.float() + err
    q, scale = _quantize(gf)
    deq = q.float() * scale
    return deq.to(g.dtype), gf - deq


def compress_grads(grads, err_state, enabled: bool = True):
    """Apply error-feedback int8 compression tensor-wise.  Returns
    (grads, new_err)."""
    if not enabled:
        return grads, err_state
    out = tree_map(compress_tensor, grads, err_state)
    return (tree_map(lambda o: o[0], out), tree_map(lambda o: o[1], out))
