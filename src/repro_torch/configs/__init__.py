"""Config registry: `get(arch_id)` returns the assigned ArchConfig."""
from repro_torch.configs.base import ArchConfig, InputShape, INPUT_SHAPES  # noqa: F401

from repro_torch.configs.mistral_large_123b import CONFIG as _mistral_large
from repro_torch.configs.llama32_vision_11b import CONFIG as _llama_vision
from repro_torch.configs.whisper_medium import CONFIG as _whisper
from repro_torch.configs.llama32_3b import CONFIG as _llama32_3b
from repro_torch.configs.llama4_scout_17b_a16e import CONFIG as _llama4_scout
from repro_torch.configs.zamba2_7b import CONFIG as _zamba2
from repro_torch.configs.kimi_k2_1t_a32b import CONFIG as _kimi_k2
from repro_torch.configs.falcon_mamba_7b import CONFIG as _falcon_mamba
from repro_torch.configs.gemma2_9b import CONFIG as _gemma2
from repro_torch.configs.phi3_mini_38b import CONFIG as _phi3

REGISTRY = {c.name: c for c in [
    _mistral_large, _llama_vision, _whisper, _llama32_3b, _llama4_scout,
    _zamba2, _kimi_k2, _falcon_mamba, _gemma2, _phi3,
]}


def get(name: str) -> ArchConfig:
    if name not in REGISTRY:
        raise KeyError(f"unknown arch '{name}'; have {sorted(REGISTRY)}")
    return REGISTRY[name]


def shape_applicable(cfg: ArchConfig, shape_name: str) -> bool:
    """long_500k only runs on sub-quadratic-decode archs (DESIGN.md §4)."""
    if shape_name == "long_500k":
        return cfg.supports_long_decode
    return True
