"""`flash_attention_bhsd`: the wrapper of the CUDA flash-attention kernel
(`csrc/flash_attention.cu`), the port of the Pallas kernel
`repro.kernels.flash_attention.kernel.flash_attention_bhsd`.

On CUDA tensors it launches the kernel (and counts each launch in
``_build.LAUNCHES["flash_attention"]``: one a call, unless the batch or the
query-block count passes a grid's 65,535) or raises; on CPU tensors it runs
the plain version, `ref.attention_ref`, and counts that in
``_build.PLAIN_CALLS``.  The kernel has no backward (the Pallas kernel has
none either), so on any device it refuses inputs that require grad while
grad mode is on, rather than return a result cut from the graph.  A DTensor
raises (`_build.refuse_dtensor`): the model runs the kernel on each rank's
block through `local_map`.  The kernel reads any strides with a unit last
dimension, so the (B, S, H, D) model layout needs no transposed copy.
"""

from __future__ import annotations

import torch

from repro_torch import _build
from repro_torch.kernels.flash_attention.ref import NEG_INF, attention_ref

__all__ = ["NEG_INF", "flash_attention_bhsd", "check_args", "grid_launches"]

#: query rows per CUDA block (any head dim, batch and length: the Pallas
#: kernel's domain)
BLOCK_Q = 128
#: the largest gridDim.y and z: a batch or a query-block count past it
#: takes one more launch of the kernel (a grid) for each 65,535
MAX_GRID_YZ = 65535
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def grid_launches(B: int, Sq: int) -> int:
    """CUDA launches of one call on a (B, ., Sq, .) query: one grid for
    each 65,535 batches times each 65,535 blocks of `BLOCK_Q` rows."""
    n_q = -(-Sq // BLOCK_Q)
    return -(-B // MAX_GRID_YZ) * -(-n_q // MAX_GRID_YZ)


def check_args(q_shape, k_shape, v_shape, dtypes=None) -> None:
    """The wrapper's checks on shapes and dtypes alone: q (B, Hq, Sq, D),
    k and v (B, Hkv, Sk, D) with Hq % Hkv == 0, the shapes the Pallas
    kernel takes (any B, head count, length and head dim); with
    ``dtypes`` (q's, k's, v's), the CUDA kernel's too: all float32 or all
    bfloat16.  Raises ValueError or TypeError."""
    q_shape, k_shape, v_shape = (tuple(s) for s in (q_shape, k_shape,
                                                     v_shape))
    if len(q_shape) != 4 or len(k_shape) != 4 or v_shape != k_shape \
            or q_shape[0] != k_shape[0] or q_shape[3] != k_shape[3] \
            or k_shape[1] == 0 or q_shape[1] % k_shape[1] != 0:
        raise ValueError(f"flash_attention: shapes q {q_shape}, k "
                         f"{k_shape}, v {v_shape}")
    if dtypes is not None and (dtypes[0] not in _DTYPES
                               or set(dtypes) != {dtypes[0]}):
        raise TypeError(f"flash_attention: dtypes "
                        f"{', '.join(map(str, dtypes))}; expected one of "
                        f"float32, bfloat16")


def flash_attention_bhsd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True,
                         out: torch.Tensor = None) -> torch.Tensor:
    """q: (B, Hq, Sq, D); k/v: (B, Hkv, Sk, D).  Returns (B, Hq, Sq, D) in
    q's dtype (written into ``out`` where given, a view of any strides).
    The Pallas kernel's ``block_q``/``block_k`` have no counterpart: the
    CUDA kernel's blocking is fixed (`BLOCK_Q` query rows a block)."""
    check_args(q.shape, k.shape, v.shape)
    _build.refuse_dtensor("flash_attention", q, k, v)
    _build.refuse_grad("flash_attention", q, k, v)
    if q.device.type == "cpu":
        _build.PLAIN_CALLS["flash_attention"] += 1
        res = attention_ref(q, k, v, causal)
        if out is None:
            return res
        out.copy_(res)
        return out
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    check_args(q.shape, k.shape, v.shape, (q.dtype, k.dtype, v.dtype))
    if out is None:
        out = torch.empty((B, Hq, Sq, D), dtype=q.dtype, device=q.device)
    for name, t in (("q", q), ("k", k), ("v", v), ("out", out)):
        if t.device != q.device:
            raise ValueError(f"flash_attention: {name} is on {t.device}, "
                             f"q on {q.device}")
        if t.stride(3) != 1:
            raise ValueError(f"flash_attention: {name} has last-dim stride "
                             f"{t.stride(3)}, expected 1")
    if tuple(out.shape) != (B, Hq, Sq, D) or out.dtype != q.dtype:
        raise ValueError(f"flash_attention: out {tuple(out.shape)} "
                         f"{out.dtype}")
    if B * Hq * Sq == 0:
        return out
    strides = [s for t in (q, k, v, out) for s in t.stride()[:3]]
    _build.call("flash_attention", "flash_attention_launch",
                _build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(out),
                B, Hq, Hkv, Sq, Sk, D, *strides, int(bool(causal)),
                _DTYPES[q.dtype], float(D ** -0.5),
                _build.stream(q.device))
    _build.LAUNCHES["flash_attention"] += grid_launches(B, Sq)
    return out
