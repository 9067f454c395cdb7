"""mistral-large-123b [dense] — [hf:mistralai/Mistral-Large-Instruct-2407]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mistral-large-123b", family="dense",
    n_layers=88, d_model=12288, n_heads=96, n_kv_heads=8, d_ff=28672,
    vocab=32768, head_dim=128, rope_theta=1e6,
    tie_embeddings=False,
    source="hf:mistralai/Mistral-Large-Instruct-2407",
    supports_long_decode=False,
    notes="pure full attention; long_500k skipped (DESIGN.md §4)",
)
