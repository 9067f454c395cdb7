"""Zamba2-style hybrid (the port of `src/repro/models/hybrid.py`): a Mamba-2
backbone with a *shared* attention + SwiGLU block applied after every
`hybrid_attn_period` mamba blocks (arXiv:2411.15242).

Layer accounting: `n_layers` counts both mamba blocks and shared-block
applications, n_layers = n_mamba + n_mamba / period.  The shared block has
ONE weight set (not stacked) but a *per-application* KV cache at decode
time.  Prefill runs each Mamba-2 block's scan through the selective-scan
kernel and each shared application's attention through the flash kernel;
decode is plain torch.  The reference scans over the (n_apps, period)
grouped mamba stack; the port loops over it in Python.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import dense as D
from repro_torch.models import layers as L
from repro_torch.models import ssm


def plan(cfg: ArchConfig):
    period = cfg.hybrid_attn_period
    n_mamba = cfg.n_layers * period // (period + 1)
    n_apps = n_mamba // period
    assert n_mamba + n_apps == cfg.n_layers, (cfg.n_layers, n_mamba, n_apps)
    return n_mamba, n_apps, period


def init(cfg: ArchConfig, gen: torch.Generator):
    """Random parameters drawn from `gen`, on its device."""
    dtype = D.torch_dtype(cfg.dtype)
    n_mamba, _, _ = plan(cfg)
    dev = gen.device
    embed = L.embed_init(gen, (cfg.vocab, cfg.d_model), dtype)
    mamba = ssm.init_mamba2(gen, cfg, n_mamba, dtype)
    shared = dict(L.init_attn(gen, D._attn_spec(cfg), dtype),
                  **L.init_swiglu(gen, cfg.d_model, cfg.d_ff, dtype),
                  attn_norm=torch.zeros((cfg.d_model,), dtype=dtype,
                                        device=dev),
                  ffn_norm=torch.zeros((cfg.d_model,), dtype=dtype,
                                       device=dev))
    return {
        "embed": embed,
        "mamba": mamba,
        "shared": shared,
        "final_norm": torch.zeros((cfg.d_model,), dtype=dtype, device=dev),
    }


def _superblock(cfg: ArchConfig, params, x, app, mamba, attn):
    """Application `app`: its `period` Mamba-2 blocks, `mamba(p_j, h, j)`,
    then the shared block, whose attention is `attn(h)` (the reference's
    scan body).  The first norm reads the rounded stream, every later one
    the f32 sum of the residual add before it (`layers.add_norm`)."""
    _, _, period = plan(cfg)
    shared = params["shared"]
    h = L.rmsnorm(x, params["mamba"]["norm"][app * period])
    for j in range(period):
        p_j = D.layer_params(params["mamba"], app * period + j)
        nxt = (params["mamba"]["norm"][app * period + j + 1]
               if j + 1 < period else shared["attn_norm"])
        x, h = L.add_norm(x, mamba(p_j, h, j), nxt)
    # the shared attention + MLP block: one weight set for every app
    x, h = L.add_norm(x, attn(h), shared["ffn_norm"])
    return x + L.swiglu(shared, h)


def forward(cfg: ArchConfig, params, tokens):
    """tokens: (B, S) integer -> logits (B, S, V) f32."""
    b, s = tokens.shape
    _, n_apps, period = plan(cfg)
    x = params["embed"][tokens]
    positions = torch.arange(s, dtype=torch.int32,
                             device=tokens.device)[None].expand(b, s)
    shared = params["shared"]
    spec = D._attn_spec(cfg)

    def mamba(p_j, h, j):
        return ssm.mamba2_block(p_j, cfg, h)

    def attn(h):
        return L.attention_block(shared, h, positions, spec, causal=True,
                                 rope_theta=cfg.rope_theta)

    for app in range(n_apps):
        x = _superblock(cfg, params, x, app, mamba, attn)
    return D._logits(cfg, params, x)


def loss_fn(cfg: ArchConfig, params, batch):
    return L.softmax_xent(forward(cfg, params, batch["tokens"]),
                          batch["labels"])


def _attn_cache_len(cache_len: int) -> int:
    """Shared-attn cache; windowed at long decode contexts (the reference's
    LONG_DECODE_GLOBAL_WINDOW deviation, as gemma2's global layers)."""
    return min(cache_len, D.LONG_DECODE_GLOBAL_WINDOW)


def init_cache(cfg: ArchConfig, batch, cache_len, dtype=None, device=None):
    """conv (n_apps, period, B, K-1, conv_dim), h (n_apps, period, B, H, N,
    P) f32, and one (B, C, KV, hd) KV cache per shared application."""
    dtype = dtype or D.torch_dtype(cfg.dtype)
    _, n_apps, period = plan(cfg)
    s = ssm.mamba2_shapes(cfg)
    conv_dim = s["d_inner"] + 2 * s["n"]
    return dict(
        conv=torch.zeros((n_apps, period, batch, cfg.ssm_conv - 1, conv_dim),
                         dtype=dtype, device=device),
        h=torch.zeros((n_apps, period, batch, s["n_heads"], s["n"], s["p"]),
                      dtype=torch.float32, device=device),
        attn=L.init_kv_cache(n_apps, batch, _attn_cache_len(cache_len),
                             cfg.n_kv_heads, cfg.hd, dtype, device),
    )


def decode_step(cfg: ArchConfig, params, cache, tokens, pos):
    """tokens: (B, 1) integer, pos: int -> (logits (B, 1, V) f32, cache).

    The states and caches are updated in place and returned."""
    _, n_apps, period = plan(cfg)
    x = params["embed"][tokens]
    shared = params["shared"]
    spec = D._attn_spec(cfg)
    ck, cv = cache["attn"]["k"], cache["attn"]["v"]
    for app in range(n_apps):
        def mamba(p_j, hin, j):
            y, conv, h = ssm.mamba2_decode(p_j, cfg, hin,
                                           cache["conv"][app, j],
                                           cache["h"][app, j])
            cache["conv"][app, j].copy_(conv)
            cache["h"][app, j].copy_(h)
            return y

        # ring == full while pos < cache_len and wraps (windowed) beyond it
        x = _superblock(cfg, params, x, app, mamba,
                        lambda hin: L.decode_attention_block(
                            shared, hin, ck[app], cv[app], pos, spec,
                            mode="ring", rope_theta=cfg.rope_theta)[0])
    return D._logits(cfg, params, x), cache
