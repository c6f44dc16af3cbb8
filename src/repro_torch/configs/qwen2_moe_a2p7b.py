"""qwen2-moe-a2.7b [moe]: 24L d_model=2048 16H (kv=16) vocab=151936,
60 routed experts (padded to 64 for EP16) top-4, d_ff_expert=1408,
plus a gated shared expert (4x width = 5632) [hf:Qwen/Qwen1.5-MoE-A2.7B]."""
from repro_torch.configs.base import ArchConfig, MoeParams

CONFIG = ArchConfig(
    name="qwen2-moe-a2.7b", family="moe", n_layers=24, d_model=2048,
    n_heads=16, n_kv_heads=16, d_ff=0, vocab=151936, qkv_bias=True,
    moe=MoeParams(n_experts=60, top_k=4, d_ff_expert=1408,
                  d_ff_shared=5632, shared_gated=True),
    source="hf:Qwen/Qwen1.5-MoE-A2.7B; hf",
)
