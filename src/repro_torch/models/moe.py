"""Mixture-of-Experts decoder family (the port of `src/repro/models/moe.py`):
llama4-scout-17b-a16e and kimi-k2-1t-a32b.

Switch-style capacity routing, as the reference computes it: tokens go in
fixed-size groups; within a group each token picks its top-k experts, takes
the next free slot of each expert's capacity in (token, slot) order, and is
dropped from an expert whose slots are full.  Written in PyTorch's idiom
rather than the reference's one-hot einsums:

* dispatch gathers token rows into an (E, groups * cap, d) buffer (zeros in
  the free slots); at kimi's width the reference's (g, k, E, cap) f32
  dispatch tensor would be 403 MB a group, and this never builds it;
* the three expert products are batched matmuls over the stacked expert
  weights (the reference computes them outside any Pallas kernel too);
* the combine gathers each token's k kept outputs and sums them over j =
  0..k-1 in that order in f32; no float scatter-add, so a call is
  deterministic.

Positions in an expert are counted in int32, and top-k is a stable
descending sort, so ties pick the lower expert index first as
`jax.lax.top_k` does.  The rounding points are the reference's as XLA
compiles it: the router logits and the experts' gate and up products
keep an f32 result (`layers.mm_f32`), h and the down product are rounded to
the activation dtype, the gates are rounded to it before the combine,
and the shared expert, whose products are rounded as the dense FFN's, is
added after the routed sum.  The attention pattern and the caches are the dense
family's (`dense.member_kind`): llama4 has chunked layers with every
`global_period`-th layer global, kimi uniform full attention.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models import dense as D
from repro_torch.models import layers as L

MOE_GROUP = 1024          # tokens per dispatch group
AUX_LOSS_WEIGHT = 0.01    # Switch-style load-balance loss weight


def _capacity(cfg: ArchConfig, group: int) -> int:
    c = math.ceil(group * cfg.top_k * cfg.capacity_factor / cfg.n_experts)
    return max(8, int(2 ** math.ceil(math.log2(c))))   # pow2, >= 8


def _swiglu(w_gate, w_up, w_down, x):
    """The reference's SwiGLU as XLA compiles it: the gate and up products
    in f32 (`layers.mm_f32`), h rounded to the activation dtype, the down
    product in the activation dtype."""
    h = F.silu(L.mm_f32(x, w_gate)) * L.mm_f32(x, w_up)
    return torch.matmul(h.to(x.dtype), w_down)


def route(cfg: ArchConfig, router, xg, cap: int):
    """Routing of G groups at once.  xg (G, g, d) and router (d, E) in the
    activation dtype -> dict of probs (G, g, E) f32, gates (G, g, k) f32
    (renormalised, not after drops), idx (G, g, k) int64, pos (G, g k)
    int32 (the slot in its expert, (token, slot) order, token-major) and
    keep (G, g k) bool (pos < cap)."""
    e, k = cfg.n_experts, cfg.top_k
    n_groups, g = xg.shape[:2]
    probs = torch.softmax(L.mm_f32(xg, router), dim=-1)
    top, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = top[..., :k], order[..., :k]
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    flat = idx.reshape(n_groups, g * k)
    one = F.one_hot(flat, e).to(torch.int32)                # (G, g k, E)
    before = torch.cumsum(one, dim=1, dtype=torch.int32) - one
    pos = torch.gather(before, 2, flat[..., None])[..., 0]
    return dict(probs=probs, gates=gates, idx=idx, pos=pos, keep=pos < cap)


def _aux(cfg: ArchConfig, r):
    """Switch load-balance loss per group, E sum_e f_e P_e: (G,) f32."""
    e = cfg.n_experts
    f_e = F.one_hot(r["idx"][..., 0], e).float().mean(dim=1)
    return e * torch.sum(f_e * r["probs"].mean(dim=1), dim=-1)


def _grouped(cfg: ArchConfig, p, xg, cap: int):
    """xg (G, g, d) -> (y (G, g, d), aux (G,) f32); each group routed,
    computed and combined on its own, the G groups in one pass."""
    e, k = cfg.n_experts, cfg.top_k
    n_groups, g, d = xg.shape
    t, slots = n_groups * g, n_groups * cap
    r = route(cfg, p["router"], xg, cap)
    flat, keep = r["idx"].reshape(n_groups, g * k), r["keep"]
    # the (E, G cap) buffer row of each (token, slot): expert-major, then
    # group, then position in the expert
    dst = (flat * slots + torch.arange(n_groups, device=xg.device)[:, None]
           * cap + r["pos"])
    tok = torch.arange(t, device=xg.device).reshape(n_groups, g, 1).expand(
        n_groups, g, k).reshape(n_groups, g * k)
    # integer scatter of token ids; every dropped slot writes the one spare
    # row past the end, which is cut off
    src = torch.full((e * slots + 1,), t, dtype=torch.int64,
                     device=xg.device)
    src.scatter_(0, torch.where(keep, dst, e * slots).reshape(-1),
                 tok.reshape(-1))
    rows = torch.cat([xg.reshape(t, d), xg.new_zeros(1, d)])
    x_disp = rows[src[:-1]].reshape(e, slots, d)            # exact gather
    out = _swiglu(p["w_gate"], p["w_up"], p["w_down"], x_disp).reshape(
        e * slots, d)
    # the combine: the gates in the activation dtype, as the reference's
    # comb.astype(out.dtype), a dropped slot's gate 0
    comb = torch.where(keep.reshape(n_groups, g, k), r["gates"], 0.0).to(
        xg.dtype).float()
    at = torch.where(keep, dst, 0).reshape(n_groups, g, k)
    y = comb[..., 0, None] * out[at[..., 0]].float()
    for j in range(1, k):
        y = y + comb[..., j, None] * out[at[..., j]].float()
    return y.to(xg.dtype), _aux(cfg, r)


def moe_ffn(cfg: ArchConfig, p, x):
    """Routed expert FFN.  x (T, D) -> (y (T, D), aux f32 scalar), in
    groups of min(1024, T) tokens.

    p: router (D, E); w_gate/w_up (E, D, F); w_down (E, F, D)."""
    t, d = x.shape
    group = min(MOE_GROUP, t)
    assert t % group == 0, (t, group)
    n_groups = t // group
    y, aux = _grouped(cfg, p, x.reshape(n_groups, group, d),
                      _capacity(cfg, group))
    return y.reshape(t, d), aux.sum() / n_groups


def moe_ffn_chunked(cfg: ArchConfig, p, x, gc: int):
    """The reference's sharding-aware layout of the same math: (T, d) ->
    (gc, n_chunks group, d) -> chunks of gc groups, group = min(1024,
    T // gc); falls back to `moe_ffn` when T is not a whole number of
    chunks.  The reference pins the group axis to the client shards and the
    expert axis to the model axis (`_shard_e`, `ctx.shard_moe_dispatch`,
    `shard_batch`); on one card those hooks have no counterpart, so this
    is the layout alone."""
    t, d = x.shape
    group = min(MOE_GROUP, t // gc) if t >= gc else t
    n_chunks = t // (gc * group)
    if n_chunks == 0 or t % (gc * group) != 0:
        return moe_ffn(cfg, p, x)
    xg = x.reshape(gc, n_chunks, group, d).transpose(0, 1)
    y, aux = _grouped(cfg, p, xg.reshape(n_chunks * gc, group, d),
                      _capacity(cfg, group))
    y = y.reshape(n_chunks, gc, group, d).transpose(0, 1)
    return y.reshape(t, d), aux.reshape(n_chunks, gc).mean(1).sum() / n_chunks


def _routed_ffn(cfg: ArchConfig, p_j, h2d, shards: int = 1):
    """The chunked layout only for a shard count > 1, which one card never
    has (the reference's `moe_chunk_shards()` without a mesh)."""
    if shards > 1 and h2d.shape[0] % shards == 0:
        return moe_ffn_chunked(cfg, p_j, h2d, shards)
    return moe_ffn(cfg, p_j, h2d)


# --------------------------------------------------------------------------
# params
# --------------------------------------------------------------------------

def init(cfg: ArchConfig, gen: torch.Generator):
    """Random parameters drawn from `gen`, on its device: the dense
    family's stacked attention and norms, the expert stacks (n, E, d, f) /
    (n, E, f, d), the router (n, d, E) and, with shared experts, ws_gate /
    ws_up / ws_down."""
    dtype = D.torch_dtype(cfg.dtype)
    n, d, e, f = cfg.n_layers, cfg.d_model, cfg.n_experts, cfg.d_ff_expert
    params = {"embed": L.embed_init(gen, (cfg.vocab, d), dtype)}
    layers = D._stacked_layer_params(cfg, gen, n, dtype, ffn=False)
    if cfg.n_shared_experts:
        fs = cfg.d_ff * cfg.n_shared_experts
        layers["ws_gate"] = L.dense_init(gen, (n, d, fs), dtype)
        layers["ws_up"] = L.dense_init(gen, (n, d, fs), dtype)
        layers["ws_down"] = L.dense_init(gen, (n, fs, d), dtype)
    layers["router"] = L.dense_init(gen, (n, d, e), dtype)
    layers["w_gate"] = L.dense_init(gen, (n, e, d, f), dtype)
    layers["w_up"] = L.dense_init(gen, (n, e, d, f), dtype)
    layers["w_down"] = L.dense_init(gen, (n, e, f, d), dtype)
    params["layers"] = layers
    params["final_norm"] = torch.zeros((d,), dtype=dtype, device=gen.device)
    if not cfg.tie_embeddings:
        params["unembed"] = L.dense_init(gen, (d, cfg.vocab), dtype)
    return params


# --------------------------------------------------------------------------
# forward
# --------------------------------------------------------------------------

def _ffn(cfg: ArchConfig, p_j, h):
    """The routed experts (all tokens of h routed together) plus the
    shared expert, added after the routed sum; (y like h, aux)."""
    y, aux = _routed_ffn(cfg, p_j, h.reshape(-1, h.shape[-1]))
    y = y.reshape(h.shape)
    if cfg.n_shared_experts:
        # the dense FFN's roundings: XLA folds the reference's f32 cast
        # into the router's and the experts' products, not into this one
        # over the (B, S, D) h, whose gate and up products it rounds
        y = y + L.swiglu(dict(w_gate=p_j["ws_gate"], w_up=p_j["ws_up"],
                              w_down=p_j["ws_down"]), h)
    return y, aux


def _layer_body(cfg: ArchConfig, p_j, x, positions, j):
    """One layer alone, group member j, from the rounded stream to the
    rounded stream (the reference's `_layer_body` compiled by itself):
    (x (B, S, D), aux)."""
    h = L.rmsnorm(x, p_j["attn_norm"])
    x, h = L.add_norm(x, D._member_attn(cfg, p_j, h, positions, j),
                      p_j["ffn_norm"])
    y, aux = _ffn(cfg, p_j, h)
    return x + y, aux


def forward_with_aux(cfg: ArchConfig, params, tokens):
    """tokens (B, S) -> (logits (B, S, V) f32, aux averaged over layers)."""
    b, s = tokens.shape
    positions = torch.arange(s, dtype=torch.int32,
                             device=tokens.device)[None].expand(b, s)
    g = D.group_size(cfg)
    x, auxes = D.run_layers(
        cfg, params["layers"], D._embed(cfg, params, tokens),
        lambda p, h, i: D._member_attn(cfg, p, h, positions, i % g), _ffn)
    aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
    for aux_i in auxes:
        aux = aux + aux_i
    return D._logits(cfg, params, x), aux / cfg.n_layers


def forward(cfg: ArchConfig, params, tokens):
    return forward_with_aux(cfg, params, tokens)[0]


def loss_fn(cfg: ArchConfig, params, batch):
    logits, aux = forward_with_aux(cfg, params, batch["tokens"])
    return L.softmax_xent(logits, batch["labels"]) + AUX_LOSS_WEIGHT * aux


# --------------------------------------------------------------------------
# decode
# --------------------------------------------------------------------------

init_cache = D.init_cache   # the same attention cache layout


def decode_step(cfg: ArchConfig, params, cache, tokens, pos):
    """tokens (B, 1) integer, pos int -> (logits (B, 1, V) f32, cache); the
    step's B tokens route as one group (capacity >= 8).  The caches are
    updated in place and returned."""
    x, _ = D.run_layers(cfg, params["layers"], D._embed(cfg, params, tokens),
                        D.decode_attn(cfg, cache, pos), _ffn)
    return D._logits(cfg, params, x), cache
