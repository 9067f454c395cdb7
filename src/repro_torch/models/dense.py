"""Dense decoder-only LM family (the port of `src/repro/models/dense.py`).

Covers mistral-large-123b, llama3.2-3b, phi3-mini-3.8b (uniform causal
layers) and gemma2-9b (alternating local/global attention, attention softcap
50, final logit softcap 30, sqrt(d) input scaling).  Its layer pattern,
attention members and caches also carry the moe family (`moe.py`), whose
llama4 has chunked layers (`chunk_ring` caches in decode).

Layers come in *groups*, the repeating attention pattern (1 layer for
uniform models, 2 for gemma2's local/global pair); stacked (L, ...) leaves
are walked layer by layer in a Python loop, and layer l is member l % g of
group l // g.  Prefill attention runs through the flash kernel; decode
attends over per-member KV caches with plain torch.
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L


def torch_dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


# --------------------------------------------------------------------------
# layer pattern
# --------------------------------------------------------------------------

def group_size(cfg: ArchConfig) -> int:
    if cfg.local_global_period:
        return 2
    if cfg.global_period:
        return cfg.global_period
    return 1


def member_kind(cfg: ArchConfig, j: int) -> str:
    """Attention flavor of group member j: 'full' | 'local' | 'chunked'."""
    if cfg.local_global_period:
        return "local" if j % 2 == 0 else "full"
    if cfg.global_period:
        return "full" if j == cfg.global_period - 1 else "chunked"
    return "full"


def _attn_spec(cfg: ArchConfig) -> L.AttnParamsSpec:
    return L.AttnParamsSpec(cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd)


def layer_params(layers, i):
    """Layer i's slice of the stacked (L, ...) leaves (views)."""
    return {k: v[i] for k, v in layers.items()}


# --------------------------------------------------------------------------
# params
# --------------------------------------------------------------------------

def _stacked_layer_params(cfg: ArchConfig, gen, n_layers, dtype, ffn=True):
    """Stacked attention, norm and (with `ffn`) SwiGLU leaves."""
    spec = _attn_spec(cfg)
    shapes = L.attn_param_shapes(spec)
    d, f = cfg.d_model, cfg.d_ff
    names = sorted(shapes) + (["w_gate", "w_up", "w_down"] if ffn else [])
    all_shapes = dict(shapes, w_gate=(d, f), w_up=(d, f), w_down=(f, d))
    out = {n: L.dense_init(gen, (n_layers,) + all_shapes[n], dtype)
           for n in names}
    out["attn_norm"] = torch.zeros((n_layers, d), dtype=dtype,
                                   device=gen.device)
    out["ffn_norm"] = torch.zeros((n_layers, d), dtype=dtype,
                                  device=gen.device)
    return out


def init(cfg: ArchConfig, gen: torch.Generator):
    """Random parameters drawn from `gen`, on its device."""
    dtype = torch_dtype(cfg.dtype)
    params = {
        "embed": L.embed_init(gen, (cfg.vocab, cfg.d_model), dtype),
        "layers": _stacked_layer_params(cfg, gen, cfg.n_layers, dtype),
        "final_norm": torch.zeros((cfg.d_model,), dtype=dtype,
                                  device=gen.device),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = L.dense_init(gen, (cfg.d_model, cfg.vocab), dtype)
    return params


# --------------------------------------------------------------------------
# forward (train / prefill)
# --------------------------------------------------------------------------

def _input_scale(cfg: ArchConfig, dtype, device):
    """gemma's sqrt(d) input scaling, rounded to the activation dtype."""
    return torch.tensor(math.sqrt(cfg.d_model), dtype=torch.float32,
                        device=device).to(dtype)


def _embed(cfg: ArchConfig, params, tokens):
    x = params["embed"][tokens]
    if cfg.softcap is not None:
        x = x * _input_scale(cfg, x.dtype, x.device)
    return x


def _member_attn(cfg: ArchConfig, p, x, positions, j):
    kind = member_kind(cfg, j)
    kw = dict(rope_theta=cfg.rope_theta, softcap=cfg.softcap)
    if kind == "local":
        kw["window"] = cfg.sliding_window
    elif kind == "chunked":
        kw["chunk"] = cfg.attn_chunk
    return L.attention_block(p, x, positions, _attn_spec(cfg), causal=True,
                             **kw)


def swiglu_ffn(cfg: ArchConfig, p_j, h):
    """The dense layer's FFN, as `run_layers` takes it: (y, aux None)."""
    return L.swiglu(p_j, h), None


def run_layers(cfg: ArchConfig, layers, x, attn, ffn=swiglu_ffn):
    """Every layer of the stacked (L, ...) `layers` over the residual
    stream x, group by group: `attn(p_i, h, i)` is layer i's attention
    output from its normed input h, `ffn(cfg, p_i, h)` its FFN's (y, aux).
    Inside a group the norms read the residual adds' f32 sums, the next
    member's attn_norm too; each group starts from the rounded stream
    (`layers.add_norm`).  Returns (x, [aux of each layer])."""
    g = group_size(cfg)
    auxes = []
    for i in range(cfg.n_layers):
        p_i = layer_params(layers, i)
        if i % g == 0:
            h = L.rmsnorm(x, p_i["attn_norm"])
        x, h = L.add_norm(x, attn(p_i, h, i), p_i["ffn_norm"])
        y, aux = ffn(cfg, p_i, h)
        last = i % g == g - 1
        x, h = L.add_norm(x, y, None if last else layers["attn_norm"][i + 1])
        auxes.append(aux)
    return x, auxes


def _logits(cfg: ArchConfig, params, x):
    x = L.rmsnorm(x, params["final_norm"])
    unembed = params.get("unembed")
    if unembed is None:
        unembed = params["embed"].T
    logits = (x @ unembed).float()
    if cfg.softcap is not None:                     # gemma2 final logit softcap
        logits = 30.0 * torch.tanh(logits / 30.0)
    return logits


def forward(cfg: ArchConfig, params, tokens):
    """tokens: (B, S) integer -> logits (B, S, V) f32."""
    b, s = tokens.shape
    x = _embed(cfg, params, tokens)
    positions = torch.arange(s, dtype=torch.int32,
                             device=tokens.device)[None].expand(b, s)
    g = group_size(cfg)
    x, _ = run_layers(cfg, params["layers"], x, lambda p, h, i: _member_attn(
        cfg, p, h, positions, i % g))
    return _logits(cfg, params, x)


def loss_fn(cfg: ArchConfig, params, batch):
    logits = forward(cfg, params, batch["tokens"])
    return L.softmax_xent(logits, batch["labels"])


# --------------------------------------------------------------------------
# decode (one token against a KV cache)
# --------------------------------------------------------------------------

# The reference's documented deviation: at very long decode contexts the
# global layers of sub-quadratic archs (gemma2, llama4; the hybrid's shared
# attention) use a windowed ring cache of this size instead of the full
# cache.
LONG_DECODE_GLOBAL_WINDOW = 32_768


def _member_cache_len(cfg: ArchConfig, j: int, cache_len: int) -> int:
    kind = member_kind(cfg, j)
    if kind == "local":
        return min(cfg.sliding_window, cache_len)
    if kind == "chunked":
        return min(cfg.attn_chunk, cache_len)
    if cfg.supports_long_decode and cache_len > LONG_DECODE_GLOBAL_WINDOW:
        return LONG_DECODE_GLOBAL_WINDOW
    return cache_len


def _member_mode(cfg: ArchConfig, j: int, cache_len: int) -> str:
    kind = member_kind(cfg, j)
    if kind == "local" and cfg.sliding_window < cache_len:
        return "ring"
    if kind == "chunked" and cfg.attn_chunk < cache_len:
        return "chunk_ring"
    if (kind == "full" and cfg.supports_long_decode
            and cache_len > LONG_DECODE_GLOBAL_WINDOW):
        return "ring"
    return "full"


def init_cache(cfg: ArchConfig, batch, cache_len, dtype=None, device=None):
    """Per-group-member cache stacks keyed 'm<j>': (n_groups, B, C_j, KV,
    hd)."""
    dtype = dtype or torch_dtype(cfg.dtype)
    g = group_size(cfg)
    n_groups = cfg.n_layers // g
    return {f"m{j}": L.init_kv_cache(n_groups, batch,
                                     _member_cache_len(cfg, j, cache_len),
                                     cfg.n_kv_heads, cfg.hd, dtype, device)
            for j in range(g)}


def decode_attn(cfg: ArchConfig, cache, pos):
    """`run_layers`' attention for one decode step: layer i attends over
    its member's cache, which it updates in place."""
    g = group_size(cfg)
    spec = _attn_spec(cfg)
    cache_len = max(c["k"].shape[2] for c in cache.values())

    def attn(p_i, h, i):
        j = i % g
        c = cache[f"m{j}"]
        return L.decode_attention_block(
            p_i, h, c["k"][i // g], c["v"][i // g], pos, spec,
            mode=_member_mode(cfg, j, cache_len), softcap=cfg.softcap,
            rope_theta=cfg.rope_theta)[0]
    return attn


def decode_step(cfg: ArchConfig, params, cache, tokens, pos):
    """tokens: (B, 1) integer, pos: int -> (logits (B, 1, V) f32, cache).

    The caches are updated in place and returned."""
    x, _ = run_layers(cfg, params["layers"], _embed(cfg, params, tokens),
                      decode_attn(cfg, cache, pos))
    return _logits(cfg, params, x), cache
