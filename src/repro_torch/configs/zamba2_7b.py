"""zamba2-7b [hybrid] — Mamba2 backbone + shared attention blocks
[arXiv:2411.15242].

n_layers=81 counts 54 mamba2 blocks + 27 shared-block applications
(hybrid_attn_period=2: one shared attn+MLP application per 2 mamba blocks,
single weight set).  MHA (kv=32); ssm_state=64.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-7b", family="hybrid",
    n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32, d_ff=14336,
    vocab=32000, head_dim=112,
    ssm_state=64, ssm_expand=2, ssm_head_dim=64, mamba_version=2,
    hybrid_attn_period=2,
    tie_embeddings=True,
    source="arXiv:2411.15242",
    supports_long_decode=True,
    notes="O(1) mamba state; shared-attn caches are the decode memory term",
)
