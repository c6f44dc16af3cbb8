"""llama4-scout-17b-a16e [moe]: 48L d_model=5120 40H (kv=8) vocab=202048,
16 routed experts top-1 + shared expert, d_ff_expert=8192
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified].  Early fusion is the
modality frontend's concern (not exercised; text backbone here).
TP16: 40 q-heads -> 48; kv=8 replicated."""
from repro_torch.configs.base import ArchConfig, MoeParams

CONFIG = ArchConfig(
    name="llama4-scout-17b-a16e", family="moe", n_layers=48, d_model=5120,
    n_heads=40, n_kv_heads=8, d_ff=0, vocab=202048,
    rope_theta=5e5,
    moe=MoeParams(n_experts=16, top_k=1, d_ff_expert=8192,
                  d_ff_shared=8192, shared_gated=False,
                  capacity_factor=1.0),  # Switch-style top-1 capacity
    source="hf:meta-llama/Llama-4-Scout-17B-16E; unverified",
)
