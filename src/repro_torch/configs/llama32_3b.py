"""llama3.2-3b [dense] — small llama3 [hf:meta-llama/Llama-3.2-1B family]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama3.2-3b", family="dense",
    n_layers=28, d_model=3072, n_heads=24, n_kv_heads=8, d_ff=8192,
    vocab=128256, head_dim=128, rope_theta=5e5,
    tie_embeddings=True,
    source="hf:meta-llama/Llama-3.2-1B (3B variant)",
    supports_long_decode=False,
    notes="pure full attention; long_500k skipped (DESIGN.md §4)",
)
