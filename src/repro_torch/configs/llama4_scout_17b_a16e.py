"""llama4-scout-17b-a16e [moe] — [hf:meta-llama/Llama-4-Scout-17B-16E].

MoE 16 experts top-1 + 1 shared expert per layer; chunked local attention
(8192-token chunks) with every 4th layer global — the chunked layers give
this arch a bounded decode cache, so long_500k runs (DESIGN.md §4 notes the
global layers' cache is the dominant term there).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama4-scout-17b-a16e", family="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, d_ff=8192,
    vocab=202048, head_dim=128, rope_theta=5e5,
    n_experts=16, top_k=1, d_ff_expert=8192, n_shared_experts=1,
    attn_chunk=8192, global_period=4,
    tie_embeddings=False,
    source="hf:meta-llama/Llama-4-Scout-17B-16E",
    supports_long_decode=True,
    notes="early fusion: multimodal tokens enter as ordinary vocab tokens",
)
