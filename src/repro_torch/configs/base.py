"""Architecture config schema shared by all 10 assigned architectures.

The port's own copy of the reference's schema, field for field, so that
`configs.get` answers as the reference does; `reduced()` yields the
smoke-test variant (<=2 layers, d_model<=512, <=4 experts).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int | None = None      # default: d_model // n_heads
    rope_theta: float = 10000.0

    # -- attention pattern ---------------------------------------------------
    sliding_window: int | None = None     # gemma2 local layers
    local_global_period: int | None = None  # gemma2: 1 local + 1 global per pair
    attn_chunk: int | None = None         # llama4 chunked local attention
    global_period: int | None = None      # every Nth layer full/global
    softcap: float | None = None          # gemma2 final-logit/attn softcap

    # -- MoE -------------------------------------------------------------
    n_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    n_shared_experts: int = 0
    capacity_factor: float = 1.25

    # -- SSM (mamba) -------------------------------------------------------
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    mamba_version: int = 1
    ssm_head_dim: int = 64               # mamba2 head size P

    # -- hybrid (zamba2): shared attn block every N mamba blocks -----------
    hybrid_attn_period: int = 0

    # -- encoder-decoder (whisper) ------------------------------------------
    n_enc_layers: int = 0
    enc_frames: int = 1500               # stub frontend sequence length

    # -- VLM (llama3.2-vision): cross-attn every Nth layer -------------------
    cross_attn_period: int = 0
    n_image_tokens: int = 1601           # stub vision-encoder output length

    # -- misc ---------------------------------------------------------------
    # The reference's switch between a scanned and an unrolled depth loop
    # (an XLA partitioner workaround).  Kept so that configs compare field
    # for field; the port's models always loop over layers in Python.
    scan_layers: bool = True
    tie_embeddings: bool = True
    dtype: str = "bfloat16"
    source: str = ""                     # citation for the assigned config
    supports_long_decode: bool = False   # may run long_500k (sub-quadratic)
    notes: str = ""

    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)

    def reduced(self) -> "ArchConfig":
        """Smoke-test variant: same family/wiring, tiny dimensions."""
        kw = dict(
            n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, d_ff=256,
            vocab=512, head_dim=32, sliding_window=(16 if self.sliding_window
                                                    else None),
            attn_chunk=(16 if self.attn_chunk else None),
            global_period=(2 if self.global_period else None),
        )
        if self.n_experts:
            kw.update(n_experts=4, top_k=min(self.top_k, 2), d_ff_expert=64)
        if self.ssm_state:
            kw.update(ssm_state=8, ssm_expand=2, ssm_head_dim=16)
        if self.n_enc_layers:
            kw.update(n_enc_layers=2, enc_frames=16)
        if self.cross_attn_period:
            kw.update(cross_attn_period=2, n_image_tokens=8)
        if self.hybrid_attn_period:
            kw.update(hybrid_attn_period=2, n_layers=3)  # 2 mamba + 1 attn
        return self.replace(**kw)


# The four assigned input shapes --------------------------------------------

@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                 # "train" | "prefill" | "decode"


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}
