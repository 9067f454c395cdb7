"""llama-3.2-vision-11b [vlm] — [hf:meta-llama/Llama-3.2-11B-Vision].

40 decoder layers; every 5th layer is gated cross-attention onto the (stub)
vision-encoder patch embeddings.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama-3.2-vision-11b", family="vlm",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=14336,
    vocab=128256, head_dim=128, rope_theta=5e5,
    cross_attn_period=5, n_image_tokens=1601,
    tie_embeddings=True,
    source="hf:meta-llama/Llama-3.2-11B-Vision",
    supports_long_decode=False,
    notes="vision frontend stubbed (patch embeddings via input_specs)",
)
