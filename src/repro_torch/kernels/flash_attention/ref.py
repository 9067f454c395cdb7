"""Plain PyTorch version of the flash attention kernel (the port of
`src/repro/kernels/flash_attention/ref.py::flash_attention_ref`).

The CPU path of `flash_attention.flash_attention`, and the oracle the CUDA
kernel is held to on the card.  It materialises the (B, H, S, S) f32 logits.
"""
import math

import torch


def flash_attention_ref(q, k, v, *, causal=True, window=None, softcap=None):
    """q (B, S, H, hd), k/v (B, S_kv, KV, hd), H % KV == 0 -> (B, S, H, hd)
    in q's dtype; f32 logits, softmax and P·V."""
    b, s, h, hd = q.shape
    s_kv, kv = k.shape[1], k.shape[2]
    rep = h // kv
    scale = 1.0 / math.sqrt(hd)
    # query head h reads KV head h // rep, as jnp.repeat over heads gives
    kh = k[:, :, :, None].expand(b, s_kv, kv, rep, hd).reshape(b, s_kv, h, hd)
    vh = v[:, :, :, None].expand(b, s_kv, kv, rep, hd).reshape(b, s_kv, h, hd)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float() * scale, kh.float())
    if softcap is not None:
        logits = softcap * torch.tanh(logits / softcap)
    qi = torch.arange(s, device=q.device)[:, None]
    kj = torch.arange(s_kv, device=q.device)[None, :]
    mask = torch.ones((s, s_kv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kj <= qi
    if window is not None:
        mask &= (qi - kj) < window
    logits = logits.masked_fill(~mask[None, None], -1e30)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, vh.float())
    return out.to(q.dtype)
