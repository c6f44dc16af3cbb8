"""Entry point for the flash-attention kernel in the model's layout
(`repro.kernels.flash_attention.ops.flash_attention` in the JAX package)."""

from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.kernel import flash_attention_bhsd

__all__ = ["flash_attention"]


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """q: (B, S, Hq, D); k/v: (B, S, Hkv, D) -> (B, S, Hq, D).

    One kernel launch on CUDA tensors: the (B, H, S, D) views it is given
    are strided views of the inputs and of the output, so nothing is
    transposed in memory."""
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    flash_attention_bhsd(q.transpose(1, 2), k.transpose(1, 2),
                         v.transpose(1, 2), causal=causal,
                         out=out.transpose(1, 2))
    return out
