"""qwen2.5-14b [dense]: 48L d_model=5120 40H (GQA kv=8) d_ff=13824
vocab=152064, QKV bias [hf:Qwen/Qwen2.5-0.5B family; hf].

TP16 padding: 40 query heads -> 48; kv=8 < 16 -> replicated KV projections,
sequence-sharded KV cache (DESIGN.md #3)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2.5-14b", family="dense", n_layers=48, d_model=5120,
    n_heads=40, n_kv_heads=8, d_ff=13824, vocab=152064, qkv_bias=True,
    rope_theta=1e6, source="hf:Qwen/Qwen2.5-14B; hf",
)
