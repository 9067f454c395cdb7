"""Whisper-style encoder-decoder transformer (the port of
`src/repro/models/encdec.py`; arXiv:2212.04356).

The mel-spectrogram and conv frontend are a stub, as in the reference:
`batch["frames"]` carries precomputed frame embeddings (B, T_enc, d_model).
A bidirectional encoder over the frames, a causal decoder with
cross-attention onto the encoder states, decode KV caches.  The reference's
deviations stand: RMSNorm without biases (not Whisper's LayerNorm),
sinusoidal positions on both sides.

Prefill runs three flash-kernel calls a decoder layer and one an encoder
layer: the encoder's non-causal self-attention, the decoder's causal
self-attention, and its cross-attention, whose keys are the T_enc encoder
states.  Decode is plain torch: the self-attention through its KV cache,
the cross-attention over the per-layer K/V that `prefill_cross` computes
once from the encoder states.  The reference scans over the stacked
layers; the port loops over them in Python.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L
from repro_torch.models.dense import layer_params, torch_dtype


def _attn_spec(cfg: ArchConfig) -> L.AttnParamsSpec:
    return L.AttnParamsSpec(cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd)


def _stacked_block(cfg: ArchConfig, gen, n_layers, dtype, cross: bool):
    """The reference's stacked leaves: attention (and, with `cross`, its
    `x_`-prefixed twin), the GELU FFN's weights, zero norms and biases."""
    shapes = dict(L.attn_param_shapes(_attn_spec(cfg)))
    if cross:
        shapes.update({f"x_{n}": s for n, s in list(shapes.items())})
    d, f = cfg.d_model, cfg.d_ff
    shapes.update(w_in=(d, f), w_out=(f, d))
    out = {n: L.dense_init(gen, (n_layers,) + shapes[n], dtype)
           for n in sorted(shapes)}
    zeros = lambda n: torch.zeros((n_layers, n), dtype=dtype,  # noqa: E731
                                  device=gen.device)
    out.update(attn_norm=zeros(d), ffn_norm=zeros(d), b_in=zeros(f),
               b_out=zeros(d))
    if cross:
        out["cross_norm"] = zeros(d)
    return out


def init(cfg: ArchConfig, gen: torch.Generator):
    """Random parameters drawn from `gen`, on its device."""
    dtype = torch_dtype(cfg.dtype)
    zeros = lambda: torch.zeros((cfg.d_model,), dtype=dtype,  # noqa: E731
                                device=gen.device)
    return {
        "embed": L.embed_init(gen, (cfg.vocab, cfg.d_model), dtype),
        "encoder": _stacked_block(cfg, gen, cfg.n_enc_layers, dtype,
                                  cross=False),
        "decoder": _stacked_block(cfg, gen, cfg.n_layers, dtype, cross=True),
        "enc_final_norm": zeros(),
        "final_norm": zeros(),
    }


def _add_norm(x, a, weight):
    """(x + a, rmsnorm(x + a)) in the activation dtype.  XLA computes the
    reference's bf16 residual add in f32 and hands the norm that reads it
    the f32 sum, while the next residual add reads the sum rounded to
    bf16; so does this (rounding the sum for the norm too parts most of a
    bf16 layer's outputs from the reference by a bf16 step).  In f32 it
    is the plain sum and norm."""
    s = x.float() + a.float()
    return s.to(x.dtype), L.rmsnorm(s, weight).to(x.dtype)


def _positions(b, s, device):
    return torch.arange(s, dtype=torch.int32, device=device)[None].expand(
        b, s)


def encoder_layer(cfg: ArchConfig, p_l, x, positions):
    """One bidirectional encoder layer (the reference's scan body)."""
    h = L.rmsnorm(x, p_l["attn_norm"])
    x, h = _add_norm(x, L.attention_block(p_l, h, positions, _attn_spec(cfg),
                                          causal=False, use_rope=False),
                     p_l["ffn_norm"])
    return x + L.gelu_mlp(p_l, h)


def encode(cfg: ArchConfig, params, frames):
    """frames: (B, T_enc, D) stub frontend embeddings -> encoder states."""
    b, t, d = frames.shape
    x = frames + L.sinusoidal_positions(t, d, frames.device)[None].to(
        frames.dtype)
    positions = _positions(b, t, frames.device)
    for i in range(cfg.n_enc_layers):
        x = encoder_layer(cfg, layer_params(params["encoder"], i), x,
                          positions)
    return L.rmsnorm(x, params["enc_final_norm"])


def _cross_params(p_l):
    return {k: p_l[f"x_{k}"] for k in ("wq", "wk", "wv", "wo")}


def decoder_layer(cfg: ArchConfig, p_l, x, positions, enc_out):
    """One decoder layer: causal self-attention, cross-attention onto
    `enc_out`, the GELU FFN (the reference's scan body)."""
    spec = _attn_spec(cfg)
    h = L.rmsnorm(x, p_l["attn_norm"])
    x, h = _add_norm(x, L.attention_block(p_l, h, positions, spec,
                                          causal=True, use_rope=False),
                     p_l["cross_norm"])
    x, h = _add_norm(x, L.attention_block(_cross_params(p_l), h, positions,
                                          spec, use_rope=False, kv_x=enc_out),
                     p_l["ffn_norm"])
    return x + L.gelu_mlp(p_l, h)


def _logits(params, x):
    x = L.rmsnorm(x, params["final_norm"])
    return (x @ params["embed"].T).float()


def decode_train(cfg: ArchConfig, params, tokens, enc_out):
    """tokens: (B, S) integer, enc_out: (B, T_enc, D) -> logits (B, S, V)
    f32."""
    b, s = tokens.shape
    embed = params["embed"]
    x = embed[tokens] + L.sinusoidal_positions(
        s, cfg.d_model, tokens.device)[None].to(embed.dtype)
    positions = _positions(b, s, tokens.device)
    for i in range(cfg.n_layers):
        x = decoder_layer(cfg, layer_params(params["decoder"], i), x,
                          positions, enc_out)
    return _logits(params, x)


def forward(cfg: ArchConfig, params, tokens, frames):
    return decode_train(cfg, params, tokens, encode(cfg, params, frames))


def loss_fn(cfg: ArchConfig, params, batch):
    logits = forward(cfg, params, batch["tokens"], batch["frames"])
    return L.softmax_xent(logits, batch["labels"])


def init_cache(cfg: ArchConfig, batch, cache_len, dtype=None, device=None):
    """The self-attention KV cache and the cross-attention K/V, (L, B,
    T_enc, KV, hd), which `prefill_cross` fills from the encoder states."""
    dtype = dtype or torch_dtype(cfg.dtype)
    nl, kv, hd = cfg.n_layers, cfg.n_kv_heads, cfg.hd
    shape = (nl, batch, cfg.enc_frames, kv, hd)
    return dict(
        self=L.init_kv_cache(nl, batch, cache_len, kv, hd, dtype, device),
        cross_k=torch.zeros(shape, dtype=dtype, device=device),
        cross_v=torch.zeros(shape, dtype=dtype, device=device),
    )


def prefill_cross(cfg: ArchConfig, params, cache, enc_out):
    """Each decoder layer's cross-attention K/V from the encoder states
    (plain products); returns the cache with them in place of its own."""
    b, t, _ = enc_out.shape
    kv, hd = cfg.n_kv_heads, cfg.hd
    dec = params["decoder"]
    ks = torch.stack([(enc_out @ w).reshape(b, t, kv, hd)
                      for w in dec["x_wk"]])
    vs = torch.stack([(enc_out @ w).reshape(b, t, kv, hd)
                      for w in dec["x_wv"]])
    return dict(cache, cross_k=ks, cross_v=vs)


def decode_step(cfg: ArchConfig, params, cache, tokens, pos):
    """tokens: (B, 1) integer, pos: int -> (logits (B, 1, V) f32, cache).

    The self-attention caches are updated in place and returned."""
    pos = int(pos)
    b = tokens.shape[0]
    spec = _attn_spec(cfg)
    x = params["embed"][tokens]
    # the sinusoidal position embedding at `pos`, computed directly
    angle = L.sinusoidal_angles(torch.tensor(
        [pos], dtype=torch.float32, device=x.device), cfg.d_model)
    x = x + L.interleave_sin_cos(angle)[None].to(x.dtype)
    ck, cv = cache["self"]["k"], cache["self"]["v"]
    xk, xv = cache["cross_k"], cache["cross_v"]
    memory = torch.ones((1, xk.shape[2]), dtype=torch.bool, device=x.device)
    for i in range(cfg.n_layers):
        p_l = layer_params(params["decoder"], i)
        h = L.rmsnorm(x, p_l["attn_norm"])
        out, _, _ = L.decode_attention_block(p_l, h, ck[i], cv[i], pos, spec,
                                             use_rope=False)
        x, h = _add_norm(x, out, p_l["cross_norm"])
        q = (h @ p_l["x_wq"]).reshape(b, 1, cfg.n_heads, cfg.hd)
        xattn = L.attend(q, xk[i], xv[i], memory)
        x, h = _add_norm(x, xattn.reshape(b, 1, -1) @ p_l["x_wo"],
                         p_l["ffn_norm"])
        x = x + L.gelu_mlp(p_l, h)
    return _logits(params, x), cache
