"""Plain PyTorch GQA attention: the oracle the CUDA `flash_attention`
kernel (`csrc/flash_attention.cu`) is held against.

Mirrors `repro.kernels.flash_attention.ref.attention_ref`.
"""

from __future__ import annotations

import torch

__all__ = ["NEG_INF", "attention_ref"]

NEG_INF = -1e30


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True) -> torch.Tensor:
    """q: (B, Hq, Sq, D); k/v: (B, Hkv, Sk, D), Hq % Hkv == 0.

    Full-materialization softmax attention in f32; output in q's dtype.
    The causal mask is ``q_pos >= k_pos`` with both counted from 0.
    """
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    group = Hq // Hkv
    kk = k.repeat_interleave(group, dim=1)
    vv = v.repeat_interleave(group, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kk.float()) * (D ** -0.5)
    if causal:
        mask = (torch.arange(Sq, device=q.device)[:, None]
                >= torch.arange(Sk, device=q.device)[None, :])
        s = torch.where(mask[None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", p, vv.float())
    return out.to(q.dtype)
