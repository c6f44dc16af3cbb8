"""zamba2-2.7b [hybrid]: 54 Mamba2 layers + shared attention blocks.

54L d_model=2560 32H (kv=32) d_ff=10240 vocab=32000 ssm_state=64
[arXiv:2411.15242; hf].  The released model's embedding-concat input to the
shared block and per-use LoRA adapters are simplified to standard residual
reuse (DESIGN.md #4); two alternating shared parameter sets, applied every
6 Mamba2 layers (54 layers -> 9 applications).
"""
from repro_torch.configs.base import ArchConfig, SsmParams

CONFIG = ArchConfig(
    name="zamba2-2.7b", family="hybrid", n_layers=54, d_model=2560,
    n_heads=32, n_kv_heads=32, d_ff=10240, vocab=32000,
    ssm=SsmParams(d_state=64, head_dim=64, expand=2),
    hybrid_every=6, n_shared_blocks=2,
    source="arXiv:2411.15242; hf",
)
