"""`flash_attention_bhsd`: the wrapper of the CUDA flash-attention kernel
(`csrc/flash_attention.cu`), the port of the Pallas kernel
`repro.kernels.flash_attention.kernel.flash_attention_bhsd`.

On CUDA tensors it launches the kernel (and counts the launch in
``_build.LAUNCHES["flash_attention"]``) or raises; on CPU tensors it runs
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

__all__ = ["NEG_INF", "flash_attention_bhsd"]

#: query rows per CUDA block, and the largest head dim the kernel takes:
#: 160, pixtral-12b's, the widest of the registered configs (the Pallas
#: kernel takes any head dim; wider ones raise here)
BLOCK_Q = 128
MAX_HEAD_DIM = 160
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def flash_attention_bhsd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True,
                         out: torch.Tensor = None) -> torch.Tensor:
    """q: (B, Hq, Sq, D); k/v: (B, Hkv, Sk, D).  Returns (B, Hq, Sq, D) in
    q's dtype (written into ``out`` where given, a view of any strides).
    The Pallas kernel's ``block_q``/``block_k`` have no counterpart: the
    CUDA kernel's blocking is fixed (`BLOCK_Q` query rows a block)."""
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape \
            or q.shape[0] != k.shape[0] or q.shape[3] != k.shape[3] \
            or k.shape[1] == 0 or q.shape[1] % k.shape[1] != 0:
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
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
    if D > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head dim {D} > {MAX_HEAD_DIM}, "
                         f"the widest the CUDA kernel takes")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: dtypes {q.dtype}, {k.dtype}, "
                        f"{v.dtype}; expected one of float32, bfloat16")
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
    _build.LAUNCHES["flash_attention"] += 1
    return out
