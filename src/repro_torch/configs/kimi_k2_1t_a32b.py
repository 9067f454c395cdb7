"""kimi-k2-1t-a32b [moe] — trillion-param MoE [arXiv:2501.kimi2].

61 layers, MoE 384 experts top-8 (expert hidden 2048) + 1 shared expert.
Deviation from the source model recorded here: the source's first dense
layer is folded into the uniform MoE stack (one scan body) — at 1/61 of
the FLOPs this is noise for the roofline, and it keeps the HLO constant-size.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="kimi-k2-1t-a32b", family="moe",
    n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8, d_ff=2048,
    vocab=163840, head_dim=112, rope_theta=5e4,
    n_experts=384, top_k=8, d_ff_expert=2048, n_shared_experts=1,
    tie_embeddings=False,
    source="arXiv:2501.kimi2",
    supports_long_decode=False,
    notes="full attention; long_500k skipped (DESIGN.md §4)",
)
