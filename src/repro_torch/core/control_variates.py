"""RLOO control-variate primitives — the mathematical core of FedNCV.

Equation numbers refer to the source paper (arxiv 2310.17200): Eq. 8-9
are the client-level RLOO reshape over the K microbatch gradients,
Eq. 10-12 the server-level networked aggregation over the sampled cohort,
Algorithm 1 line 12 the per-client alpha adaptation.

Two implementations of every quantity, as in the reference
(`src/repro/core/control_variates.py`): the tree forms, which materialize
the leave-one-out baselines as written (`loo_baselines`, `rloo_reshape`,
`server_loo_baselines`) or reduce them over a tree or a list of client
trees (`client_stats_from_stack`, `client_message`,
`server_loo_from_mean`, `networked_aggregate`,
`networked_aggregate_stacked`), plain tensor code that the tests and the
variance studies use; and the reduced forms over the flat substrate that
run on the main path
(`client_pass_flat` -> the `rloo_combine` kernel,
`networked_aggregate_flat` -> the `ncv_weighted_sum` kernel), using

    c_{D\\i} = (K gbar - g_i) / (K - 1),   mean_i g'_i = (1 - alpha) gbar,

with S1 = ||gbar||^2 and S2 = sum_i ||g_i||^2.

The client pass takes the whole cohort at once: leaves (C, K, ...) with
alpha (C,); a single client is leaves (K, ...) with a scalar alpha.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels.rloo.rloo import ncv_aggregate, rloo_combine
from repro_torch.utils.tree_math import (ravel_stack, tree_leaves, tree_map,
                                         tree_mean, tree_norm_sq, tree_scale,
                                         unravel, unravel_stack)


# ---------------------------------------------------------------------------
# Client level: RLOO over K microbatch gradients
# ---------------------------------------------------------------------------

def loo_baselines(g_stack):
    """Naive leave-one-out baselines c_{D\\i} = mean_{j != i} g_j (Eq. 8-9).

    g_stack: tree whose leaves are stacked along axis 0 with K entries."""
    def per_leaf(x):
        k = x.shape[0]
        return (torch.sum(x, dim=0, keepdim=True) - x) / (k - 1)
    return tree_map(per_leaf, g_stack)


def rloo_reshape(g_stack, alpha):
    """g'_i = g_i - alpha * c_{D\\i} (Eq. 9), naive form."""
    c = loo_baselines(g_stack)
    return tree_map(lambda g, ci: g - alpha * ci, g_stack, c)


class ClientCVStats(NamedTuple):
    """Sufficient statistics of a client's RLOO pass.

    mean_grad    : gbar_u (tree) — the only tensor communicated.
    k            : number of RLOO units (microbatches).
    mean_norm_sq : S1 = ||gbar_u||^2.
    sum_norm_sq  : S2 = sum_i ||g_u^i||^2.
    """
    mean_grad: object
    k: torch.Tensor
    mean_norm_sq: torch.Tensor
    sum_norm_sq: torch.Tensor


def client_stats_from_stack(g_stack) -> ClientCVStats:
    """ClientCVStats of one client by one pass over its stacked gradients
    (leaves (K, ...))."""
    gbar = tree_mean(g_stack, axis=0)
    leaves = tree_leaves(g_stack)
    s2 = torch.sum(torch.stack([torch.sum(x.float() ** 2) for x in leaves]))
    return ClientCVStats(gbar, torch.tensor(float(leaves[0].shape[0])),
                         tree_norm_sq(gbar), s2)


def client_message(stats: ClientCVStats, alpha):
    """The upload mean_i (g_i - alpha c_{D\\i}) = (1 - alpha) gbar."""
    return tree_scale(stats.mean_grad, 1.0 - alpha)


def client_pass_flat(g_stack, alpha, *, want_reshaped: bool = False):
    """Client-side RLOO pass of a cohort over the flat substrate.

    g_stack: tree with leaves (C, K, ...) and alpha (C,), or leaves (K, ...)
    and a scalar alpha.  Ravels into one (C, K, N) f32 buffer, runs the
    fused `rloo_combine` (the CUDA kernel for CUDA tensors), and returns

        (message tree, ClientCVStats, reshaped tree | None)

    with message == (1 - alpha) * gbar (Eq. 9 collapsed) and the reshaped
    units g'_i only when `want_reshaped`."""
    device = tree_leaves(g_stack)[0].device
    alpha = torch.as_tensor(alpha, dtype=torch.float32, device=device)
    single = alpha.dim() == 0
    flat, spec = ravel_stack(g_stack, lead=1 if single else 2)
    if single:
        flat, alpha = flat[None], alpha[None]
    c, k, _ = flat.shape
    mean, gp, s2 = rloo_combine(flat.contiguous(), alpha.contiguous())
    s1 = torch.sum(mean * mean, dim=1)
    kk = torch.full((c,), float(k), dtype=torch.float32, device=flat.device)
    msg_flat = (1.0 - alpha)[:, None] * mean
    if single:
        mean, gp, s2, s1, kk, msg_flat = (mean[0], gp[0], s2[0], s1[0],
                                          kk[0], msg_flat[0])
    stats = ClientCVStats(unravel(mean, spec), kk, s1, s2)
    reshaped = unravel_stack(gp, spec) if want_reshaped else None
    return unravel(msg_flat, spec), stats, reshaped


def rloo_scalar_moments(stats: ClientCVStats):
    """Closed-form (E[g_i c_i], E[c_i^2]) of the RLOO pair from S1, S2."""
    k, s1, s2 = stats.k, stats.mean_norm_sq, stats.sum_norm_sq
    e_gc = (k * k * s1 - s2) / (k * (k - 1.0))
    e_cc = (k * k * (k - 2.0) * s1 + s2) / (k * (k - 1.0) ** 2)
    return e_gc, e_cc


def optimal_alpha_single(stats: ClientCVStats):
    """Variance-optimal alpha* = E[g c] / E[c^2] (paper Eq. 7 optimum)."""
    e_gc, e_cc = rloo_scalar_moments(stats)
    return e_gc / torch.clamp(e_cc, min=1e-20)


def alpha_sqnorm_grad(stats: ClientCVStats, alpha):
    """d ||(1 - alpha) gbar_u||^2 / d alpha = -2 (1 - alpha) ||gbar_u||^2."""
    return -2.0 * (1.0 - alpha) * stats.mean_norm_sq


def alpha_descent_update(alpha, stats: ClientCVStats, lr, alpha_max=1.0):
    """Algorithm 1 line 12, clamped to [0, alpha_max]."""
    new = alpha - lr * alpha_sqnorm_grad(stats, alpha)
    return torch.clamp(new, 0.0, alpha_max)


# ---------------------------------------------------------------------------
# Server level: RLOO over the participating clients (Eq. 10-12)
# ---------------------------------------------------------------------------

def server_loo_baselines(client_grads, n_samples):
    """Naive c_{V\\u} = sum_{v != u} n_v / (n - n_u) g_v (Eq. 10) for a
    list of client trees; returns a list of trees."""
    n_samples = torch.as_tensor(n_samples, dtype=torch.float32)
    n = torch.sum(n_samples)
    out = []
    for u in range(len(client_grads)):
        acc = None
        for v, g_v in enumerate(client_grads):
            if v == u:
                continue
            term = tree_scale(g_v, n_samples[v] / (n - n_samples[u]))
            acc = term if acc is None else tree_map(torch.add, acc, term)
        out.append(acc)
    return out


def server_loo_from_mean(gbar_w, g_u, n_u, n):
    """Reduced c_{V\\u} = (n gbar_w - n_u g_u) / (n - n_u), with gbar_w =
    sum_v (n_v / n) g_v the one weighted reduction."""
    scale = 1.0 / (n - n_u)
    return tree_map(lambda m, g: (n * m - n_u * g) * scale, gbar_w, g_u)


def networked_aggregate(client_grads, n_samples, beta=1.0):
    """Eq. 10-12 over a list of client trees:
    g = sum_u p_u (g_u - beta c_{V\\u}), p_u = n_u / n."""
    n_samples = torch.as_tensor(n_samples, dtype=torch.float32)
    n = torch.sum(n_samples)
    p = n_samples / n
    gbar_w = None
    for w, g in zip(p, client_grads):
        term = tree_scale(g, w)
        gbar_w = term if gbar_w is None else tree_map(torch.add, gbar_w, term)
    agg = None
    for u, g_u in enumerate(client_grads):
        c_u = server_loo_from_mean(gbar_w, g_u, n_samples[u], n)
        term = tree_scale(tree_map(lambda g, c: g - beta * c, g_u, c_u), p[u])
        agg = term if agg is None else tree_map(torch.add, agg, term)
    return agg


def networked_aggregate_stacked(g_stack, n_samples, beta=1.0):
    """g = sum_u p_u (g_u - beta c_{V\\u}) over leaves stacked on axis 0,
    with c_{V\\u} = (n gbar_w - n_u g_u) / (n - n_u)."""
    n_samples = torch.as_tensor(n_samples, dtype=torch.float32)
    n = torch.sum(n_samples)
    p = n_samples / n

    def per_leaf(x):
        bshape = (-1,) + (1,) * (x.dim() - 1)
        pw = p.reshape(bshape)
        nu = n_samples.reshape(bshape)
        gbar_w = torch.sum(pw * x, dim=0, keepdim=True)
        c = (n * gbar_w - nu * x) / (n - nu)
        return torch.sum(pw * (x - beta * c), dim=0)

    return tree_map(per_leaf, g_stack)


def networked_aggregate_flat(g_stack, n_samples, beta=1.0):
    """FedNCV server step (Eq. 10-12) over the flat (cohort, N) substrate.

    g_stack: tree with leaves (M, ...).  Ravels into one (M, N) buffer and
    runs `ncv_aggregate` (the `ncv_weighted_sum` kernel for CUDA tensors).
    Returns (aggregate tree, ||agg||^2)."""
    flat, spec = ravel_stack(g_stack)
    agg, nrm = ncv_aggregate(flat.contiguous(), n_samples, beta)
    return unravel(agg, spec), nrm
