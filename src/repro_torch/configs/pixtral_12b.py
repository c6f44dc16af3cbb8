"""pixtral-12b [vlm]: pixtral-ViT frontend (STUB: input_specs provides
precomputed patch embeddings, d=1024, 256 patches) + mistral-nemo-style
decoder: 40L d_model=5120 32H (kv=8) d_ff=14336 vocab=131072
[hf:mistralai/Pixtral-12B-2409; unverified].  kv=8 replicated."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="pixtral-12b", family="vlm", n_layers=40, d_model=5120,
    n_heads=32, n_kv_heads=8, d_ff=14336, vocab=131072,
    rope_theta=1e6, d_input_stub=1024, stub_seq=256,
    source="hf:mistralai/Pixtral-12B-2409; unverified",
)
