"""qwen1.5-4b [dense]: 40L d_model=2560 20H (kv=20, MHA) d_ff=6912
vocab=151936, QKV bias [hf:Qwen/Qwen1.5-0.5B family; hf].

TP16 padding: 20 heads -> 32 (documented waste, visible in the
MODEL_FLOPS/HLO ratio); kv padded alongside (MHA)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen1.5-4b", family="dense", n_layers=40, d_model=2560,
    n_heads=20, n_kv_heads=20, d_ff=6912, vocab=151936, qkv_bias=True,
    source="hf:Qwen/Qwen1.5-4B; hf",
)
