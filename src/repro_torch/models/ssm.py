"""Selective state-space models, Mamba-1 half (the port of
`src/repro/models/ssm.py`): the Mamba-1 block and the falcon-mamba-7b LM.
The Mamba-2 block arrives with the hybrid (zamba2) family.

Prefill runs the recurrence h_t = a_t h_{t-1} + b_t over the whole
(B, S, d_inner, N) state through the selective-scan kernel
(`kernels/selective_scan`): its CUDA kernel on the card, its plain version
on the CPU.  Decode is the O(1) recurrent update, one state FMA per token.
The batch axis that the reference vmaps over is written out.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.selective_scan.ops import scan_states
from repro_torch.models import layers as L
from repro_torch.models.dense import layer_params, torch_dtype


def causal_conv1d(x, w, bias=None):
    """Depthwise causal conv. x: (B, S, C); w: (K, C). Returns (B, S, C)."""
    k, s = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, k - 1, 0))
    out = xp[:, 0:s] * w[0]
    for i in range(1, k):
        out = out + xp[:, i:i + s] * w[i]
    if bias is not None:
        out = out + bias
    return out


# --------------------------------------------------------------------------
# Mamba-1 block
# --------------------------------------------------------------------------

def mamba1_shapes(cfg: ArchConfig):
    d, n = cfg.d_model, cfg.ssm_state
    di = cfg.ssm_expand * d
    dt_rank = math.ceil(d / 16)
    return dict(d_inner=di, dt_rank=dt_rank, n=n)


def init_mamba1(gen: torch.Generator, cfg: ArchConfig, n_layers, dtype):
    s = mamba1_shapes(cfg)
    d, di, r, n = cfg.d_model, s["d_inner"], s["dt_rank"], s["n"]
    dev = gen.device
    A = torch.arange(1, n + 1, dtype=torch.float32, device=dev)[None]
    A = A.expand(di, n)
    return dict(
        in_proj=L.dense_init(gen, (n_layers, d, 2 * di), dtype),
        conv_w=L.dense_init(gen, (n_layers, cfg.ssm_conv, di), dtype),
        conv_b=torch.zeros((n_layers, di), dtype=dtype, device=dev),
        x_proj=L.dense_init(gen, (n_layers, di, r + 2 * n), dtype),
        dt_proj=L.dense_init(gen, (n_layers, r, di), dtype),
        dt_bias=torch.full((n_layers, di), -4.0, dtype=torch.float32,
                           device=dev),
        A_log=torch.log(A)[None].repeat(n_layers, 1, 1),      # (L, di, N)
        D=torch.ones((n_layers, di), dtype=torch.float32, device=dev),
        out_proj=L.dense_init(gen, (n_layers, di, d), dtype),
        norm=torch.zeros((n_layers, d), dtype=dtype, device=dev),
    )


def _ssm_inputs(p, cfg: ArchConfig, xi, dtype):
    """The selective parameters of the (..., di) conv outputs xi (f32):
    (a, b, c_mat) with a, b (..., di, N) and c_mat (..., N)."""
    s_info = mamba1_shapes(cfg)
    r, n = s_info["dt_rank"], s_info["n"]
    proj = (xi.to(dtype) @ p["x_proj"]).float()
    dt_raw, b_mat, c_mat = torch.split(proj, [r, n, n], dim=-1)
    dt = F.softplus(dt_raw @ p["dt_proj"].float() + p["dt_bias"])  # (..., di)
    A = -torch.exp(p["A_log"])                                      # (di, N)
    a = torch.exp(dt[..., None] * A)                                # (..., di, N)
    b = (dt * xi)[..., None] * b_mat[..., None, :]                  # (..., di, N)
    return a, b, c_mat


def mamba1_block(p, cfg: ArchConfig, x):
    """x: (B, S, D) -> (B, S, D); one scan launch for the whole batch."""
    xz = x @ p["in_proj"]
    xi, z = torch.chunk(xz, 2, dim=-1)                  # (B, S, di)
    xi = causal_conv1d(xi, p["conv_w"], p["conv_b"])
    xi = F.silu(xi.float())
    a, b, c_mat = _ssm_inputs(p, cfg, xi, x.dtype)      # (B, S, di, N)
    h = scan_states(a, b)
    del a, b
    y = torch.einsum("bsdn,bsn->bsd", h, c_mat) + p["D"] * xi
    y = y * F.silu(z.float())
    return y.to(x.dtype) @ p["out_proj"]


def mamba1_decode(p, cfg: ArchConfig, x, conv_state, h_state):
    """One-token recurrent update.

    x: (B, 1, D); conv_state: (B, K-1, di); h_state: (B, di, N) f32.
    Returns (y (B,1,D), conv_state, h_state), new tensors.
    """
    xz = x[:, 0] @ p["in_proj"]
    xi, z = torch.chunk(xz, 2, dim=-1)                  # (B, di)
    win = torch.cat([conv_state, xi[:, None]], dim=1)   # (B, K, di)
    conv_state = win[:, 1:]
    xi = torch.einsum("bkd,kd->bd", win, p["conv_w"]) + p["conv_b"]
    xi = F.silu(xi.float())
    a, b, c_mat = _ssm_inputs(p, cfg, xi, x.dtype)      # (B, di, N)
    h_state = a * h_state + b
    y = torch.einsum("bdn,bn->bd", h_state, c_mat) + p["D"] * xi
    y = y * F.silu(z.float())
    return (y.to(x.dtype) @ p["out_proj"])[:, None], conv_state, h_state


# --------------------------------------------------------------------------
# falcon-mamba-7b: pure Mamba-1 LM
# --------------------------------------------------------------------------

def init(cfg: ArchConfig, gen: torch.Generator):
    """Random parameters drawn from `gen`, on its device."""
    dtype = torch_dtype(cfg.dtype)
    return {
        "embed": L.embed_init(gen, (cfg.vocab, cfg.d_model), dtype),
        "layers": init_mamba1(gen, cfg, cfg.n_layers, dtype),
        "final_norm": torch.zeros((cfg.d_model,), dtype=dtype,
                                  device=gen.device),
    }


def _logits(params, x):
    x = L.rmsnorm(x, params["final_norm"])
    return (x @ params["embed"].T).float()


def forward(cfg: ArchConfig, params, tokens):
    """tokens: (B, S) integer -> logits (B, S, V) f32."""
    x = params["embed"][tokens]
    for i in range(cfg.n_layers):
        p_l = layer_params(params["layers"], i)
        x = x + mamba1_block(p_l, cfg, L.rmsnorm(x, p_l["norm"]))
    return _logits(params, x)


def loss_fn(cfg: ArchConfig, params, batch):
    return L.softmax_xent(forward(cfg, params, batch["tokens"]),
                          batch["labels"])


def init_cache(cfg: ArchConfig, batch, cache_len, dtype=None, device=None):
    """SSM 'cache' = recurrent state; cache_len is irrelevant (O(1) state)."""
    dtype = dtype or torch_dtype(cfg.dtype)
    s = mamba1_shapes(cfg)
    nl = cfg.n_layers
    return dict(
        conv=torch.zeros((nl, batch, cfg.ssm_conv - 1, s["d_inner"]),
                         dtype=dtype, device=device),
        h=torch.zeros((nl, batch, s["d_inner"], s["n"]), dtype=torch.float32,
                      device=device),
    )


def decode_step(cfg: ArchConfig, params, cache, tokens, pos):
    """tokens: (B, 1) integer -> (logits (B, 1, V) f32, cache); the state is
    updated in place and returned.  Position-free."""
    del pos
    x = params["embed"][tokens]
    for i in range(cfg.n_layers):
        p_l = layer_params(params["layers"], i)
        y, conv, h = mamba1_decode(p_l, cfg, L.rmsnorm(x, p_l["norm"]),
                                   cache["conv"][i], cache["h"][i])
        cache["conv"][i].copy_(conv)
        cache["h"][i].copy_(h)
        x = x + y
    return _logits(params, x), cache
