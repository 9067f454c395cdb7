"""gemma2-9b [dense] — local+global alternating attention, logit softcap
[arXiv:2408.00118].

long_500k runs via sliding-window ring caches; DEVIATION (DESIGN.md §4):
at 500k the global layers also use a windowed (32k) ring cache — the source
model's global-full-attention cache at 500k is the quadratic case this
shape excludes.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma2-9b", family="dense",
    n_layers=42, d_model=3584, n_heads=16, n_kv_heads=8, d_ff=14336,
    vocab=256000, head_dim=256,
    sliding_window=4096, local_global_period=2, softcap=50.0,
    tie_embeddings=True,
    source="arXiv:2408.00118",
    supports_long_decode=True,
)
