"""Selective state-space models (the port of `src/repro/models/ssm.py`):
Mamba-1 blocks and the falcon-mamba-7b LM, and Mamba-2 blocks (scalar A
per head, B and C shared across heads), which the hybrid (zamba2) family
stacks.

Prefill runs the recurrence h_t = a_t h_{t-1} + b_t over the whole
(B, S, d_inner, N) or (B, S, H, N, P) state through the selective-scan
kernel (`kernels/selective_scan`), one launch a block: its CUDA kernel on
the card, its plain version on the CPU.  Decode is the O(1) recurrent
update, one state FMA per token.  The batch axis that the reference vmaps
over is written out.
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


def _conv_silu(conv, bias):
    """silu(conv + bias) in f32, from the conv's sum of products in the
    activation dtype.  The reference as XLA compiles it computes the bias
    add, the last op before its `.astype(f32)`, in f32 and never rounds it
    to bf16; so does this.  In f32 it is the plain sum."""
    return F.silu(conv.float() + bias.float())


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


def _ssm_inputs(p, cfg: ArchConfig, xi, proj):
    """The selective parameters of the (..., di) conv outputs xi (f32) and
    their x_proj product `proj` (f32): (a, b, c_mat) with a, b (..., di, N)
    and c_mat (..., N)."""
    s_info = mamba1_shapes(cfg)
    r, n = s_info["dt_rank"], s_info["n"]
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
    xi = _conv_silu(causal_conv1d(xi, p["conv_w"]), p["conv_b"])
    proj = (xi.to(x.dtype) @ p["x_proj"]).float()
    a, b, c_mat = _ssm_inputs(p, cfg, xi, proj)         # (B, S, di, N)
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
    xi = _conv_silu(torch.einsum("bkd,kd->bd", win, p["conv_w"]), p["conv_b"])
    # XLA folds the reference's cast into this unbatched product (not into
    # the prefill's vmapped one): an f32 result, never rounded
    proj = L.mm_f32(xi.to(x.dtype), p["x_proj"])
    a, b, c_mat = _ssm_inputs(p, cfg, xi, proj)         # (B, di, N)
    h_state = a * h_state + b
    y = torch.einsum("bdn,bn->bd", h_state, c_mat) + p["D"] * xi
    y = y * F.silu(z.float())
    return (y.to(x.dtype) @ p["out_proj"])[:, None], conv_state, h_state


# --------------------------------------------------------------------------
# Mamba-2 block (scalar A per head, shared B/C across heads)
# --------------------------------------------------------------------------

def mamba2_shapes(cfg: ArchConfig):
    d = cfg.d_model
    di = cfg.ssm_expand * d
    p_head = cfg.ssm_head_dim
    nh = di // p_head
    return dict(d_inner=di, n_heads=nh, p=p_head, n=cfg.ssm_state)


def init_mamba2(gen: torch.Generator, cfg: ArchConfig, n_layers, dtype):
    s = mamba2_shapes(cfg)
    d, di, nh, n = cfg.d_model, s["d_inner"], s["n_heads"], s["n"]
    conv_dim = di + 2 * n
    dev = gen.device
    return dict(
        in_proj=L.dense_init(gen, (n_layers, d, 2 * di + 2 * n + nh), dtype),
        conv_w=L.dense_init(gen, (n_layers, cfg.ssm_conv, conv_dim), dtype),
        conv_b=torch.zeros((n_layers, conv_dim), dtype=dtype, device=dev),
        dt_bias=torch.full((n_layers, nh), -4.0, dtype=torch.float32,
                           device=dev),
        A_log=torch.zeros((n_layers, nh), dtype=torch.float32, device=dev),
        D=torch.ones((n_layers, nh), dtype=torch.float32, device=dev),
        ssm_norm=torch.zeros((n_layers, di), dtype=dtype, device=dev),
        out_proj=L.dense_init(gen, (n_layers, di, d), dtype),
        norm=torch.zeros((n_layers, d), dtype=dtype, device=dev),
    )


def _mamba2_inputs(p, cfg: ArchConfig, xbc, dt_raw):
    """The selective parameters of the (..., conv_dim) conv outputs xbc
    (f32) and the (..., H) dt_raw: (a, xh, b, c_mat) with a (..., H), xh
    (..., H, P), b (..., H, N, P), c_mat (..., N)."""
    s_info = mamba2_shapes(cfg)
    di, nh, ph, n = (s_info["d_inner"], s_info["n_heads"], s_info["p"],
                     s_info["n"])
    xi, b_mat, c_mat = torch.split(xbc, [di, n, n], dim=-1)
    dt = F.softplus(dt_raw.float() + p["dt_bias"])              # (..., H)
    a = torch.exp(dt * -torch.exp(p["A_log"]))                  # (..., H)
    xh = xi.reshape(*xi.shape[:-1], nh, ph)                     # (..., H, P)
    # the reference's dt (B x) as B (dt x): one pass over the (H, N, P)
    # product instead of two, at most an ulp apart
    b = b_mat[..., None, :, None] * (dt[..., None] * xh)[..., :, None, :]
    return a, xh, b, c_mat


def _mamba2_out(p, cfg: ArchConfig, h, c_mat, xh, z, dtype):
    """y = (C h + D x) * silu(z), normed and projected; h (..., H, N, P)."""
    di = mamba2_shapes(cfg)["d_inner"]
    # sum over N as a batched (1, N) @ (N, P) product: no copy of h
    y = torch.matmul(c_mat[..., None, None, :], h)[..., 0, :]  # (..., H, P)
    y = y + p["D"][:, None] * xh
    y = y.reshape(*y.shape[:-2], di) * F.silu(z.float())
    return L.rmsnorm(y.to(dtype), p["ssm_norm"]) @ p["out_proj"]


def mamba2_block(p, cfg: ArchConfig, x):
    """x: (B, S, D) -> (B, S, D); one scan launch for the whole batch, over
    the (B, S, H, N, P) state with a broadcast over (N, P) as the
    reference's `a[..., None, None] * jnp.ones_like(b)`."""
    s_info = mamba2_shapes(cfg)
    di, n = s_info["d_inner"], s_info["n"]
    proj = x @ p["in_proj"]
    z, xbc, dt_raw = torch.split(proj, [di, di + 2 * n, s_info["n_heads"]],
                                 dim=-1)
    xbc = _conv_silu(causal_conv1d(xbc, p["conv_w"]), p["conv_b"])
    a, xh, b, c_mat = _mamba2_inputs(p, cfg, xbc, dt_raw)
    h = scan_states(a[..., None, None], b)              # (B, S, H, N, P)
    del a, b
    return _mamba2_out(p, cfg, h, c_mat, xh, z, x.dtype)


def mamba2_decode(p, cfg: ArchConfig, x, conv_state, h_state):
    """x: (B, 1, D); conv_state: (B, K-1, conv_dim); h_state: (B, H, N, P)
    f32.  Returns (y (B,1,D), conv_state, h_state), new tensors."""
    s_info = mamba2_shapes(cfg)
    di, n = s_info["d_inner"], s_info["n"]
    proj = x[:, 0] @ p["in_proj"]
    z, xbc, dt_raw = torch.split(proj, [di, di + 2 * n, s_info["n_heads"]],
                                 dim=-1)
    win = torch.cat([conv_state, xbc[:, None]], dim=1)  # (B, K, conv_dim)
    conv_state = win[:, 1:]
    xbc = _conv_silu(torch.einsum("bkd,kd->bd", win, p["conv_w"]),
                     p["conv_b"])
    a, xh, b, c_mat = _mamba2_inputs(p, cfg, xbc, dt_raw)
    h_state = a[..., None, None] * h_state + b
    return (_mamba2_out(p, cfg, h_state, c_mat, xh, z, x.dtype)[:, None],
            conv_state, h_state)


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
