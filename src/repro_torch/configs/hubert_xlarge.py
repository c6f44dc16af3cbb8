"""hubert-xlarge [audio]: encoder-only. 48L d_model=1280 16H (kv=16)
d_ff=5120 vocab=504 [arXiv:2106.07447; unverified].  The conv waveform
frontend is a STUB (input_specs provides precomputed frame embeddings,
d=512).  Encoder-only: decode shapes are skipped (DESIGN.md #4)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="hubert-xlarge", family="encoder", n_layers=48, d_model=1280,
    n_heads=16, n_kv_heads=16, d_ff=5120, vocab=504, causal=False,
    d_input_stub=512, source="arXiv:2106.07447; unverified",
)
