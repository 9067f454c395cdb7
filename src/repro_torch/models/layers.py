"""Shared transformer building blocks: norms, RoPE and sinusoidal
positions, GQA attention (full, sliding-window and chunked self-attention,
cross-attention; optional logit softcap), SwiGLU and GELU FFNs, KV caches,
the loss.

The port of `src/repro/models/layers.py`, in its conventions:
* weights live in the config's dtype (bf16 by default); norms, softmax and
  statistics accumulate in f32;
* layer weights are stacked along a leading layer axis; the models loop
  over it in Python;
* activations (B, S, D); q/k/v (B, S, H, hd); dense weights (in, out).

Full-sequence attention goes through the flash kernel
(`kernels/flash_attention`) at every length: its CUDA kernel on the card,
its plain version on the CPU.  Chunked attention (llama4) folds each whole
chunk into the batch axis of one flash call, plus one call for a ragged
tail; cross-attention (whisper) is one non-causal call whose keys are the
memory's, of their own length.  Single-token decode attends over the cache
with `attend` (plain torch).
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
# products
# ---------------------------------------------------------------------------

def mm_f32(a, b):
    """a @ b with an f32 result: exact products of the operands (bf16
    products are exact in f32) summed in f32, never rounded to the
    activation dtype.  Where the reference writes (a @ b).astype(f32), XLA
    folds that cast into the product (the moe family's router and experts,
    Mamba-1's decode), so this is what it computes.  a (..., m, k) with b
    (k, n), or a (E, m, k) with b (E, k, n)."""
    if a.dtype == torch.float32:
        return a @ b
    if a.device.type == "cpu":
        return a.float() @ b.float()
    if b.dim() == 3:
        return torch.bmm(a, b, out_dtype=torch.float32)
    out = torch.mm(a.reshape(-1, a.shape[-1]), b, out_dtype=torch.float32)
    return out.reshape(*a.shape[:-1], b.shape[-1])


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rmsnorm(x, weight, eps=1e-6):
    x32 = x.float()
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps)
    return (out * (1.0 + weight.float())).to(x.dtype)


def layernorm(x, weight, bias, eps=1e-5):
    x32 = x.float()
    mean = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x32 - mean), dim=-1, keepdim=True)
    out = (x32 - mean) * torch.rsqrt(var + eps)
    return (out * weight.float() + bias.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# rotary and sinusoidal position embeddings
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


def sinusoidal_angles(positions, d_model):
    """pos / 10000^(2i / d) for the (...) f32 `positions`, (..., d / 2)."""
    dim = torch.arange(0, d_model, 2, dtype=torch.float32,
                       device=positions.device)
    return positions[..., None] / torch.pow(10000.0, dim / d_model)


def interleave_sin_cos(angle):
    """(..., d / 2) angles -> (..., d) f32: sin at even columns, cos at odd
    ones (not in two halves)."""
    return torch.stack([torch.sin(angle), torch.cos(angle)],
                       dim=-1).flatten(-2)


def sinusoidal_positions(seq_len, d_model, device=None):
    """(seq_len, d_model) f32 table of sinusoidal position embeddings."""
    pos = torch.arange(seq_len, dtype=torch.float32, device=device)
    return interleave_sin_cos(sinusoidal_angles(pos, d_model))


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


def chunked_flash_attention(q, k, v, chunk, *, causal=True, window=None,
                            softcap=None):
    """The reference's chunked mask, (qi // chunk) == (kj // chunk) with
    the causal and window terms, through the flash kernel.  Positions start
    at 0, so the mask is block-diagonal over chunks [0, chunk), [chunk,
    2 chunk), ...: the n = S // chunk whole chunks fold into the batch axis
    of one call (B n, chunk, H, hd), a tail of S mod chunk tokens takes a
    second call, and S <= chunk is one plain call.  Each call sees only its
    own chunk's keys, so no masked-out tile is visited."""
    kw = dict(causal=causal, window=window, softcap=softcap)
    b, s, h, hd = q.shape
    n, r = divmod(s, chunk)
    if n == 0:
        return flash_attention(q, k, v, **kw)
    m = n * chunk

    def fold(t):
        # a copy only where B > 1 and a tail leaves the head rows strided
        return t[:, :m].contiguous().reshape(b * n, chunk, *t.shape[2:])

    out = flash_attention(fold(q), fold(k), fold(v), **kw).reshape(
        b, m, h, hd)
    if r == 0:
        return out
    # for B = 1 the tail is a view m rows in: hd % 8 == 0 keeps it on a
    # 16-byte boundary, as the bf16 kernel's tensor maps want
    tail = flash_attention(*(t[:, m:].contiguous() for t in (q, k, v)),
                           **kw)
    return torch.cat([out, tail], dim=1)


def attention_block(params, x, positions, spec: AttnParamsSpec, *,
                    causal=True, window=None, chunk=None, softcap=None,
                    rope_theta=10000.0, use_rope=True, kv_x=None,
                    q_scale=None):
    """Full-sequence attention (prefill) through the flash kernel; `chunk`
    (llama4) through `chunked_flash_attention`.  With `kv_x` (B, S_kv, D),
    cross-attention: q from x, k and v from kv_x, no RoPE, and every query
    attends to all of memory (one non-causal flash call, as the
    reference's all-True mask)."""
    if q_scale is not None:
        raise NotImplementedError("q_scale is not ported yet: the flash "
                                  "kernel keeps the 1/sqrt(hd) temperature")
    b, s, _ = x.shape
    h, kvh, hd = spec.n_heads, spec.n_kv_heads, spec.head_dim
    src = x if kv_x is None else kv_x
    s_kv = src.shape[1]
    q = (x @ params["wq"]).reshape(b, s, h, hd)
    k = (src @ params["wk"]).reshape(b, s_kv, kvh, hd)
    v = (src @ params["wv"]).reshape(b, s_kv, kvh, hd)
    if kv_x is not None:
        out = flash_attention(q, k, v, causal=False, softcap=softcap)
        return out.reshape(b, s, h * hd) @ params["wo"]
    if use_rope:
        q = apply_rope(q, positions, rope_theta)
        k = apply_rope(k, positions, rope_theta)
    if chunk is None:
        out = flash_attention(q, k, v, causal=causal, window=window,
                              softcap=softcap)
    else:
        out = chunked_flash_attention(q, k, v, chunk, causal=causal,
                                      window=window, softcap=softcap)
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
      "full"       — cache holds positions [0, C); valid slots <= pos.
      "ring"       — sliding-window ring buffer of the last C tokens.
      "chunk_ring" — llama4 chunked attention: ring of size C == chunk,
                     valid slots are the current chunk's prefix.
    Returns (out (B,1,D), cache_k, cache_v), the caches updated in place.
    """
    if mode not in ("full", "ring", "chunk_ring"):
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
    cache_k, cache_v = cache_update_layer(
        cache_k, cache_v, k, v, pos, ring=mode in ("ring", "chunk_ring"))
    slots = torch.arange(c, device=x.device)
    if mode == "ring":
        valid = slots < min(pos + 1, c)           # last C tokens, any order
    elif mode == "chunk_ring":
        valid = slots <= pos % c                  # current chunk's prefix
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


def init_gelu_mlp(gen: torch.Generator, d_model, d_ff, dtype):
    zeros = lambda n: torch.zeros((n,), dtype=dtype,  # noqa: E731
                                  device=gen.device)
    return dict(w_in=dense_init(gen, (d_model, d_ff), dtype),
                b_in=zeros(d_ff),
                w_out=dense_init(gen, (d_ff, d_model), dtype),
                b_out=zeros(d_model))


def gelu_mlp(params, x):
    """GELU (tanh form, `jax.nn.gelu`'s default) FFN with biases.  The
    bias add before the GELU is the last op before the reference's
    `.astype(f32)`, which XLA computes in f32 without rounding the sum to
    the activation dtype; so does this, from the product in that dtype."""
    h = F.gelu((x @ params["w_in"]).float() + params["b_in"].float(),
               approximate="tanh")
    return h.to(x.dtype) @ params["w_out"] + params["b_out"]


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
