"""Shared transformer building blocks: norms, RoPE, GQA attention (full and
sliding-window, optional logit softcap), SwiGLU, KV caches, the loss.

The port of `src/repro/models/layers.py`, in its conventions:
* weights live in the config's dtype (bf16 by default); norms, softmax and
  statistics accumulate in f32;
* layer weights are stacked along a leading layer axis; the models loop
  over it in Python;
* activations (B, S, D); q/k/v (B, S, H, hd); dense weights (in, out).

Full-sequence self-attention goes through the flash kernel
(`kernels/flash_attention`) at every length: its CUDA kernel on the card,
its plain version on the CPU.  Single-token decode attends over the cache
with `attend` (plain torch).  Chunked attention (llama4) and cross-attention
(whisper, the VLM) arrive with their families.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention.flash_attention import \
    flash_attention

# ---------------------------------------------------------------------------
# init helpers (draws on the generator's device)
# ---------------------------------------------------------------------------


def dense_init(gen: torch.Generator, shape, dtype, scale=1.0):
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    std = scale / math.sqrt(fan_in)
    w = torch.randn(shape, generator=gen, dtype=torch.float32,
                    device=gen.device)
    return w.mul_(std).to(dtype)


def embed_init(gen: torch.Generator, shape, dtype):
    w = torch.randn(shape, generator=gen, dtype=torch.float32,
                    device=gen.device)
    return w.mul_(0.02).to(dtype)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rmsnorm(x, weight, eps=1e-6):
    x32 = x.float()
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps)
    return (out * (1.0 + weight.float())).to(x.dtype)


# ---------------------------------------------------------------------------
# rotary position embeddings
# ---------------------------------------------------------------------------

def rope_freqs(head_dim, theta=10000.0, device=None):
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32,
                             device=device) / head_dim
    return 1.0 / (theta ** exponents)  # (hd/2,)


def apply_rope(x, positions, theta=10000.0):
    """x: (B, S, H, hd); positions: (B, S) integer."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)
    angles = positions[..., None].float() * freqs       # (B, S, hd/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def _make_mask(q_len, kv_len, *, causal, window=None, chunk=None,
               q_offset=0, device=None):
    """Boolean (q_len, kv_len) mask; True = attend."""
    qi = torch.arange(q_len, device=device)[:, None] + q_offset
    kj = torch.arange(kv_len, device=device)[None, :]
    mask = torch.ones((q_len, kv_len), dtype=torch.bool, device=device)
    if causal:
        mask &= kj <= qi
    if window is not None:
        mask &= (qi - kj) < window
    if chunk is not None:
        mask &= (qi // chunk) == (kj // chunk)
    return mask


def attend(q, k, v, mask, *, softcap=None, scale=None):
    """Core masked attention. q: (B,Sq,H,hd), k/v: (B,Skv,KV,hd) with
    H % KV == 0; mask broadcastable to (B, H, Sq, Skv) (or (Sq, Skv))."""
    b, sq, h, hd = q.shape
    kv = k.shape[2]
    rep = h // kv
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    qh = q.reshape(b, sq, kv, rep, hd)
    logits = torch.einsum("bqkrh,bskh->bkrqs", qh.float() * scale, k.float())
    if softcap is not None:
        logits = softcap * torch.tanh(logits / softcap)
    if mask.dim() == 2:
        mask_b = mask[None, None, None]
    elif mask.dim() == 4:
        mask_b = mask.reshape(b, kv, rep, *mask.shape[-2:])
    else:
        mask_b = mask
    logits = logits.masked_fill(~mask_b, -1e30)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bkrqs,bskh->bqkrh", probs, v)
    return out.reshape(b, sq, h, hd)


@dataclasses.dataclass(frozen=True)
class AttnParamsSpec:
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int


def attn_param_shapes(spec: AttnParamsSpec):
    d, h, kv, hd = spec.d_model, spec.n_heads, spec.n_kv_heads, spec.head_dim
    return dict(
        wq=(d, h * hd), wk=(d, kv * hd), wv=(d, kv * hd), wo=(h * hd, d))


def init_attn(gen: torch.Generator, spec: AttnParamsSpec, dtype):
    return {name: dense_init(gen, shp, dtype)
            for name, shp in sorted(attn_param_shapes(spec).items())}


def attention_block(params, x, positions, spec: AttnParamsSpec, *,
                    causal=True, window=None, chunk=None, softcap=None,
                    rope_theta=10000.0, use_rope=True, kv_x=None,
                    q_scale=None):
    """Full-sequence self-attention (prefill) through the flash kernel."""
    if kv_x is not None:
        raise NotImplementedError("cross-attention (kv_x) is not ported "
                                  "yet; it arrives with whisper and the VLM")
    if chunk is not None:
        raise NotImplementedError("chunked attention is not ported yet; it "
                                  "arrives with llama4")
    if q_scale is not None:
        raise NotImplementedError("q_scale is not ported yet: the flash "
                                  "kernel keeps the 1/sqrt(hd) temperature")
    b, s, _ = x.shape
    h, kvh, hd = spec.n_heads, spec.n_kv_heads, spec.head_dim
    q = (x @ params["wq"]).reshape(b, s, h, hd)
    k = (x @ params["wk"]).reshape(b, s, kvh, hd)
    v = (x @ params["wv"]).reshape(b, s, kvh, hd)
    if use_rope:
        q = apply_rope(q, positions, rope_theta)
        k = apply_rope(k, positions, rope_theta)
    out = flash_attention(q, k, v, causal=causal, window=window,
                          softcap=softcap)
    return out.reshape(b, s, h * hd) @ params["wo"]


# ---------------------------------------------------------------------------
# KV caches (full and ring/sliding-window)
# ---------------------------------------------------------------------------

def init_kv_cache(n_layers, batch, cache_len, n_kv, head_dim, dtype,
                  device=None):
    shape = (n_layers, batch, cache_len, n_kv, head_dim)
    return dict(k=torch.zeros(shape, dtype=dtype, device=device),
                v=torch.zeros(shape, dtype=dtype, device=device))


def cache_update_layer(cache_k, cache_v, k_new, v_new, pos, *, ring=False):
    """Insert one token's k/v at position `pos` for one layer, in place.

    cache_k/v: (B, C, KV, hd); k_new/v_new: (B, 1, KV, hd).  ring=True wraps
    pos modulo the cache length (sliding-window ring buffer).  The reference
    returns updated copies; the port writes into the cache it is given
    (and returns it), so a decode step allocates no second cache.
    """
    c = cache_k.shape[1]
    idx = pos % c if ring else pos
    cache_k[:, idx] = k_new[:, 0]
    cache_v[:, idx] = v_new[:, 0]
    return cache_k, cache_v


def decode_attention_block(params, x, cache_k, cache_v, pos,
                           spec: AttnParamsSpec, *, mode="full", softcap=None,
                           rope_theta=10000.0, use_rope=True, q_scale=None):
    """Single-token decode. x: (B,1,D); cache: (B,C,KV,hd); pos: int.

    mode:
      "full" — cache holds positions [0, C); valid slots <= pos.
      "ring" — sliding-window ring buffer of the last C tokens.
    ("chunk_ring", llama4's chunked cache, arrives with that family.)
    Returns (out (B,1,D), cache_k, cache_v), the caches updated in place.
    """
    if mode not in ("full", "ring"):
        raise NotImplementedError(f"decode mode {mode!r} is not ported yet")
    pos = int(pos)
    b = x.shape[0]
    h, kvh, hd = spec.n_heads, spec.n_kv_heads, spec.head_dim
    c = cache_k.shape[1]
    q = (x @ params["wq"]).reshape(b, 1, h, hd)
    k = (x @ params["wk"]).reshape(b, 1, kvh, hd)
    v = (x @ params["wv"]).reshape(b, 1, kvh, hd)
    if use_rope:
        posb = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
        q = apply_rope(q, posb, rope_theta)
        k = apply_rope(k, posb, rope_theta)
    cache_k, cache_v = cache_update_layer(cache_k, cache_v, k, v, pos,
                                          ring=mode == "ring")
    slots = torch.arange(c, device=x.device)
    if mode == "ring":
        valid = slots < min(pos + 1, c)           # last C tokens, any order
    else:
        valid = slots <= pos
    out = attend(q, cache_k, cache_v, valid[None, :], softcap=softcap,
                 scale=q_scale)
    return out.reshape(b, 1, h * hd) @ params["wo"], cache_k, cache_v


# ---------------------------------------------------------------------------
# FFNs
# ---------------------------------------------------------------------------

def init_swiglu(gen: torch.Generator, d_model, d_ff, dtype):
    return dict(w_gate=dense_init(gen, (d_model, d_ff), dtype),
                w_up=dense_init(gen, (d_model, d_ff), dtype),
                w_down=dense_init(gen, (d_ff, d_model), dtype))


def swiglu(params, x):
    gate = F.silu((x @ params["w_gate"]).float())
    up = (x @ params["w_up"]).float()
    return (gate * up).to(x.dtype) @ params["w_down"]


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

def softmax_xent(logits, labels, mask=None):
    """Mean cross entropy of (..., V) logits, accumulated in f32."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = logz - gold
    if mask is not None:
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)
