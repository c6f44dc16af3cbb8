"""mamba2-2.7b [ssm]: attention-free SSD stack. 64L d_model=2560
vocab=50280 ssm_state=128 headdim=64 expand=2 [arXiv:2405.21060;
unverified].  Sub-quadratic: runs long_500k."""
from repro_torch.configs.base import ArchConfig, SsmParams

CONFIG = ArchConfig(
    name="mamba2-2.7b", family="ssm", n_layers=64, d_model=2560,
    n_heads=0, n_kv_heads=0, d_ff=0, vocab=50280,
    ssm=SsmParams(d_state=128, head_dim=64, expand=2),
    source="arXiv:2405.21060; unverified",
)
