"""whisper-medium [audio] — [arXiv:2212.04356].

Encoder-decoder; 24 enc + 24 dec layers.  Conv/mel frontend stubbed: frame
embeddings (B, 1500, d_model) supplied by input_specs.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-medium", family="encdec",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16, d_ff=4096,
    vocab=51865, head_dim=64,
    n_enc_layers=24, enc_frames=1500,
    tie_embeddings=True,
    source="arXiv:2212.04356",
    supports_long_decode=False,
    notes="decoder max context 448 in source model; 500k decode not "
          "meaningful — skipped (DESIGN.md §4)",
)
