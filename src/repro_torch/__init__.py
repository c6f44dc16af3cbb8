"""CacheX on PyTorch and CUDA: the port of the `repro` JAX package.

The package mirrors the JAX package's module names (`repro_torch.core.*`
beside `repro.core.*`, `repro_torch.kernels.*` beside `repro.kernels.*`)
and imports neither JAX nor `repro`.  Machine state lives in torch
tensors on one device; the host logic stays numpy, exactly as in the
reference, so seeded runs are bit-identical.

Entry points run on the CUDA card unless the caller asks for the CPU
(``device="cpu"``), where every kernel wrapper runs its plain PyTorch
version.  The hand-written CUDA sources live in ``csrc/`` and are built
with ``nvcc`` for ``sm_90a`` at first use (`repro_torch._build`).
"""

from __future__ import annotations

import torch


def has_cuda() -> bool:
    """Whether a CUDA card is visible to PyTorch."""
    return torch.cuda.is_available()


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA card; a CUDA device without a card raises
    (there is no silent CPU fallback)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not has_cuda():
        raise RuntimeError(
            "repro_torch: no CUDA device is available; pass device='cpu' "
            "to run the plain PyTorch engine")
    return dev
