"""Unified model API (the port of `src/repro/models/api.py`): every ported
architecture family exposes the same entry points, dispatched on
`cfg.family`.

    init_params(cfg, seed_or_gen, device)             -> params
    loss(cfg, params, batch)                          -> scalar
    logits(cfg, params, batch)                        -> (B, S, V) f32
    init_cache(cfg, batch_size, cache_len, device=)   -> decode state
    decode_step(cfg, params, cache, tok, pos)         -> (logits, cache)

`batch` is a dict of (B, S) integer `tokens` and `labels`, and for the
encdec family the (B, T_enc, d_model) `frames` (stub frontend embeddings).
Ported: dense, moe (llama4-scout, kimi-k2), ssm (Mamba-1), hybrid (zamba2:
Mamba-2 and a shared attention block) and encdec (whisper: its decode cache
is filled by `encdec.encode` and `encdec.prefill_cross` first).  vlm raises
KeyError until its slice lands.  Entry points that make tensors run on the
CUDA device unless the caller passes `device="cpu"`.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import dense, encdec, hybrid, moe, ssm
from repro_torch.utils.device import resolve_device
from repro_torch.utils.tree_math import tree_map

_FAMILIES = {
    "dense": dense,
    "moe": moe,
    "ssm": ssm,
    "hybrid": hybrid,
    "encdec": encdec,
}
NOT_PORTED = ("vlm",)


def family_module(cfg: ArchConfig):
    if cfg.family not in _FAMILIES:
        if cfg.family in NOT_PORTED:
            raise KeyError(f"family {cfg.family!r} ({cfg.name}) is not ported "
                           f"to repro_torch yet")
        raise KeyError(f"unknown family {cfg.family!r}")
    return _FAMILIES[cfg.family]


def init_params(cfg: ArchConfig, seed_or_gen=0, device=None):
    """Random parameters.  An int seeds a generator on `device`; a
    `torch.Generator` draws on its own device and the result is moved."""
    mod = family_module(cfg)
    dev = resolve_device(device)
    gen = seed_or_gen
    if not isinstance(gen, torch.Generator):
        gen = torch.Generator(device=dev).manual_seed(int(seed_or_gen))
    params = mod.init(cfg, gen)
    return tree_map(lambda x: x.to(dev), params)


def loss(cfg: ArchConfig, params, batch):
    return family_module(cfg).loss_fn(cfg, params, batch)


def logits(cfg: ArchConfig, params, batch):
    mod = family_module(cfg)
    if cfg.family == "encdec":
        return mod.forward(cfg, params, batch["tokens"], batch["frames"])
    return mod.forward(cfg, params, batch["tokens"])


def init_cache(cfg: ArchConfig, batch_size: int, cache_len: int, dtype=None,
               device=None):
    return family_module(cfg).init_cache(cfg, batch_size, cache_len,
                                         dtype=dtype,
                                         device=resolve_device(device))


def decode_step(cfg: ArchConfig, params, cache, tokens, pos):
    return family_module(cfg).decode_step(cfg, params, cache, tokens, pos)


def make_batch(cfg: ArchConfig, gen_or_tokens, batch_size: int, seq_len: int,
               device=None):
    """A batch of random tokens drawn from a `torch.Generator`, or built
    around given (batch_size, seq_len) tokens, whose labels are then the
    next tokens (the last one wraps to the first).  For encdec the
    generator also draws standard normal `frames` (batch_size, enc_frames,
    d_model) in the config's dtype."""
    family_module(cfg)
    dev = resolve_device(device)
    if isinstance(gen_or_tokens, torch.Generator):
        gen = gen_or_tokens
        draw = lambda: torch.randint(0, cfg.vocab, (batch_size, seq_len),  # noqa: E731
                                     generator=gen, device=gen.device)
        tokens, labels = draw(), draw()
        if cfg.family == "encdec":
            frames = torch.randn(
                (batch_size, cfg.enc_frames, cfg.d_model), generator=gen,
                device=gen.device).to(dense.torch_dtype(cfg.dtype))
            return dict(tokens=tokens.to(dev), labels=labels.to(dev),
                        frames=frames.to(dev))
    else:
        tokens = torch.as_tensor(gen_or_tokens, dtype=torch.int64)
        if tuple(tokens.shape) != (batch_size, seq_len):
            raise ValueError(f"tokens {tuple(tokens.shape)}, expected "
                             f"{(batch_size, seq_len)}")
        labels = torch.roll(tokens, -1, dims=1)
    return dict(tokens=tokens.to(dev), labels=labels.to(dev))
