"""LM step functions (the port of `src/repro/launch/train.py`'s prefill and
serve steps).

`make_prefill_step` is the full-sequence forward (`api.logits`): on the
card every attention layer (the hybrid's shared block at each application;
whisper's encoder self-attention and its decoder's self- and
cross-attention; the vlm's self-attention and its gated cross-attention
onto the image embeddings) runs the flash kernel and every Mamba-1
layer's or Mamba-2 block's scan the selective-scan kernel.
`make_serve_step` is the one-token decode against a KV cache or SSM state
(for whisper and the vlm, after `launch/serve.py::prepare_cache` has
filled its cross-attention K/V from the frames or the image embeddings).
The FedNCV train step arrives with the LM training slice.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import api


def make_prefill_step(cfg: ArchConfig):
    @torch.inference_mode()
    def prefill_step(params, batch):
        return api.logits(cfg, params, batch)
    return prefill_step


def make_serve_step(cfg: ArchConfig):
    @torch.inference_mode()
    def serve_step(params, cache, tokens, pos):
        return api.decode_step(cfg, params, cache, tokens, pos)
    return serve_step
