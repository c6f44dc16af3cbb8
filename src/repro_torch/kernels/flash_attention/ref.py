"""Plain PyTorch GQA attention: the oracle the CUDA `flash_attention`
kernel (`csrc/flash_attention.cu`) is held against.

Mirrors `repro.kernels.flash_attention.ref.attention_ref`.  For the tests,
`attention_bf16_probs_ref` writes out the arithmetic of the kernel's bf16
path, which rounds the softmax numerators P to bf16 before P.V; no path of
the port runs it.
"""

from __future__ import annotations

import torch

__all__ = ["NEG_INF", "attention_ref", "attention_bf16_probs_ref"]

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


def attention_bf16_probs_ref(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, causal: bool = True,
                             block_k: int = 64) -> torch.Tensor:
    """The bf16 kernel's arithmetic: scores in f32 (exact products of the
    inputs, summed in f32), an online softmax over key tiles of
    ``block_k``, P rounded to bf16 before P.V (accumulated in f32), the
    softmax sum taken from the unrounded P, and the sum floored at 1e-30.
    Shapes as `attention_ref`; output in q's dtype."""
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    group = Hq // Hkv
    kk = k.repeat_interleave(group, dim=1).float()
    vv = v.repeat_interleave(group, dim=1).float()
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kk) * (D ** -0.5)
    if causal:
        mask = (torch.arange(Sq, device=q.device)[:, None]
                >= torch.arange(Sk, device=q.device)[None, :])
        s = torch.where(mask[None, None], s, NEG_INF)
    m = torch.full((B, Hq, Sq), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, Hq, Sq, D), dtype=torch.float32, device=q.device)
    for k0 in range(0, Sk, block_k):
        st = s[..., k0:k0 + block_k]
        m_new = torch.maximum(m, st.amax(dim=-1))
        corr = torch.exp(m - m_new)
        p = torch.exp(st - m_new[..., None])
        l = l * corr + p.sum(dim=-1)
        pb = p.to(torch.bfloat16).float()
        acc = acc * corr[..., None] + torch.einsum(
            "bhqk,bhkd->bhqd", pb, vv[:, :, k0:k0 + block_k])
        m = m_new
    return (acc / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype)
