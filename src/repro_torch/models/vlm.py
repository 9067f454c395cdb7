"""Llama-3.2-Vision-style VLM decoder (the port of `src/repro/models/vlm.py`;
hf:meta-llama/Llama-3.2-11B-Vision): a llama dense backbone where every
`cross_attn_period`-th layer is a *gated* cross-attention layer onto the
vision encoder's output.

The ViT and projector frontend are a stub, as in the reference:
`batch["image_embeds"]` carries precomputed patch embeddings (B,
n_image_tokens, d_model).  The language side is real: self-attention
layers, gated cross-attention layers (tanh of an f32 gate a layer, for its
attention and for its own SwiGLU FFN), caches.

Layers come in groups of `period - 1` self-attention layers and one cross
layer.  Prefill runs every attention through the flash kernel: the self
layers causal with RoPE, each cross layer one non-causal call over all of
the image tokens (`layers.attention_block`'s `kv_x`).  Decode is plain
torch: the self layers through their KV caches, each cross layer through
`attend` over the image K/V that `prefill_cross` computes once.  The
reference scans over the groups; the port loops over them in Python.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import dense as D
from repro_torch.models import layers as L


def plan(cfg: ArchConfig):
    """(n_groups, n_self, period): each group is period - 1 self layers and
    one cross layer."""
    period = cfg.cross_attn_period
    n_groups = cfg.n_layers // period
    n_self = n_groups * (period - 1)
    return n_groups, n_self, period


def init(cfg: ArchConfig, gen: torch.Generator):
    """Random parameters drawn from `gen`, on its device: the reference's
    tree, with zero norms and zero f32 gates (so every cross layer starts
    as the identity)."""
    dtype = D.torch_dtype(cfg.dtype)
    n_groups, n_self, _ = plan(cfg)
    d, f, dev = cfg.d_model, cfg.d_ff, gen.device
    shapes = dict(L.attn_param_shapes(D._attn_spec(cfg)), w_gate=(d, f),
                  w_up=(d, f), w_down=(f, d))
    cross = {n: L.dense_init(gen, (n_groups,) + s, dtype)
             for n, s in sorted(shapes.items())}
    for n in ("attn_norm", "ffn_norm"):
        cross[n] = torch.zeros((n_groups, d), dtype=dtype, device=dev)
    for n in ("attn_gate", "ffn_gate"):
        cross[n] = torch.zeros((n_groups,), dtype=torch.float32, device=dev)
    return {
        "embed": L.embed_init(gen, (cfg.vocab, d), dtype),
        "self_layers": D._stacked_layer_params(cfg, gen, n_self, dtype),
        "cross_layers": cross,
        "final_norm": torch.zeros((d,), dtype=dtype, device=dev),
    }


def _gated(gate, y):
    """tanh(gate) * y, the f32 gate's tanh rounded to y's dtype first."""
    return torch.tanh(gate).to(y.dtype) * y


def _group(cfg: ArchConfig, params, x, g, attn, cross_attn):
    """Group g, the reference's scan body: its self-attention layers, whose
    attention output is `attn(p_i, h, i)` for self layer i, then the gated
    cross-attention layer, whose attention output is `cross_attn(p_c, h)`.
    The group starts from the rounded stream; every later norm reads the
    f32 sum of the residual add before it, the cross layer's attn_norm
    too (`layers.add_norm`)."""
    _, _, period = plan(cfg)
    sl = params["self_layers"]
    p_c = D.layer_params(params["cross_layers"], g)
    first, end = g * (period - 1), (g + 1) * (period - 1)
    h = L.rmsnorm(x, sl["attn_norm"][first])
    for i in range(first, end):
        p_i = D.layer_params(sl, i)
        x, h = L.add_norm(x, attn(p_i, h, i), p_i["ffn_norm"])
        nxt = sl["attn_norm"][i + 1] if i + 1 < end else p_c["attn_norm"]
        x, h = L.add_norm(x, L.swiglu(p_i, h), nxt)
    x, h = L.add_norm(x, _gated(p_c["attn_gate"], cross_attn(p_c, h)),
                      p_c["ffn_norm"])
    return L.add_norm(x, _gated(p_c["ffn_gate"], L.swiglu(p_c, h)))[0]


def forward(cfg: ArchConfig, params, tokens, image_embeds):
    """tokens: (B, S) integer, image_embeds: (B, T, D) -> logits (B, S, V)
    f32."""
    b, s = tokens.shape
    n_groups, _, _ = plan(cfg)
    spec = D._attn_spec(cfg)
    positions = torch.arange(s, dtype=torch.int32,
                             device=tokens.device)[None].expand(b, s)

    def attn(p_i, h, i):
        return L.attention_block(p_i, h, positions, spec, causal=True,
                                 rope_theta=cfg.rope_theta)

    def cross_attn(p_c, h):
        return L.attention_block(p_c, h, positions, spec, kv_x=image_embeds,
                                 use_rope=False)

    x = params["embed"][tokens]
    for g in range(n_groups):
        x = _group(cfg, params, x, g, attn, cross_attn)
    return D._logits(cfg, params, x)


def loss_fn(cfg: ArchConfig, params, batch):
    logits = forward(cfg, params, batch["tokens"], batch["image_embeds"])
    return L.softmax_xent(logits, batch["labels"])


def init_cache(cfg: ArchConfig, batch, cache_len, dtype=None, device=None):
    """The self layers' KV cache (n_self, B, C, KV, hd) and the cross
    layers' image K/V, (n_groups, B, n_image_tokens, KV, hd), which
    `prefill_cross` fills."""
    dtype = dtype or D.torch_dtype(cfg.dtype)
    n_groups, n_self, _ = plan(cfg)
    kv, hd = cfg.n_kv_heads, cfg.hd
    shape = (n_groups, batch, cfg.n_image_tokens, kv, hd)
    return dict(
        self=L.init_kv_cache(n_self, batch, cache_len, kv, hd, dtype, device),
        cross_k=torch.zeros(shape, dtype=dtype, device=device),
        cross_v=torch.zeros(shape, dtype=dtype, device=device),
    )


def prefill_cross(cfg: ArchConfig, params, cache, image_embeds):
    """Each cross layer's K/V from the (stub) image embeddings (plain
    products); returns the cache with them in place of its own."""
    b, t, _ = image_embeds.shape
    kv, hd = cfg.n_kv_heads, cfg.hd
    cross = params["cross_layers"]
    ks = torch.stack([(image_embeds @ w).reshape(b, t, kv, hd)
                      for w in cross["wk"]])
    vs = torch.stack([(image_embeds @ w).reshape(b, t, kv, hd)
                      for w in cross["wv"]])
    return dict(cache, cross_k=ks, cross_v=vs)


def decode_step(cfg: ArchConfig, params, cache, tokens, pos):
    """tokens: (B, 1) integer, pos: int -> (logits (B, 1, V) f32, cache).

    The self-attention caches are updated in place and returned."""
    pos = int(pos)
    b = tokens.shape[0]
    n_groups, _, _ = plan(cfg)
    spec = D._attn_spec(cfg)
    ck, cv = cache["self"]["k"], cache["self"]["v"]
    xk, xv = cache["cross_k"], cache["cross_v"]
    memory = torch.ones((1, xk.shape[2]), dtype=torch.bool,
                        device=tokens.device)

    def attn(p_i, h, i):
        return L.decode_attention_block(p_i, h, ck[i], cv[i], pos, spec,
                                        rope_theta=cfg.rope_theta)[0]

    x = params["embed"][tokens]
    for g in range(n_groups):
        def cross_attn(p_c, h):
            q = (h @ p_c["wq"]).reshape(b, 1, cfg.n_heads, cfg.hd)
            out = L.attend(q, xk[g], xv[g], memory)
            return out.reshape(b, 1, -1) @ p_c["wo"]

        x = _group(cfg, params, x, g, attn, cross_attn)
    return D._logits(cfg, params, x), cache
