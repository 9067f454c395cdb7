"""falcon-mamba-7b [ssm] — attention-free Mamba-1 [arXiv:2410.05355]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="falcon-mamba-7b", family="ssm",
    n_layers=64, d_model=4096, n_heads=1, n_kv_heads=1, d_ff=0,
    vocab=65024,
    ssm_state=16, ssm_expand=2, ssm_conv=4, mamba_version=1,
    tie_embeddings=True,
    source="arXiv:2410.05355",
    supports_long_decode=True,
    notes="attention-free: O(1) decode state; long_500k native",
)
