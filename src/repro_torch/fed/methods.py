"""Client/server building blocks of the federated methods: FedNCV (the
paper, Algorithm 1), the six comparison baselines of Table 1 (FedAvg,
FedProx, SCAFFOLD, FedRep, FedPer, pFedSim) and the beyond-paper FedNCV+
(stale per-client control variates at the server).

The reference (`src/repro/fed/methods.py`) writes one client's pass and
vmaps it over the cohort.  Here the cohort axis is written out: `batches`
is a tree whose leaves are (C, K, micro_batch, ...) — C clients, K RLOO
units each — per-client state leaves are (C, ...), and a client function
returns uploads with leaves (C, ...).  That lets the RLOO pass of the whole
cohort run as one `rloo_combine` launch over a (C, K, N) stack.  The
personalization clients overlay the cohort's (C, ...) personal heads onto
the shared body expanded to one copy per client (`_split_update`).  The
typed strategy objects that bind these into runnable methods live in
`fed/api.py`.
"""
from __future__ import annotations

import dataclasses
import typing as tp

import torch
from torch.func import grad, vmap

from repro_torch import comm
from repro_torch.core import control_variates as cv
from repro_torch.utils.tree_math import (tree_axpy, tree_leaves, tree_map,
                                         tree_mean, tree_norm_sq, tree_scale,
                                         tree_sub, tree_zeros_like, unravel)


@dataclasses.dataclass(frozen=True)
class Task:
    """Binds a model to the FL runtime."""
    loss: tp.Callable            # (params, batch) -> scalar
    head_keys: tuple = ()        # top-level param keys that stay personal
    accuracy: tp.Callable | None = None


@dataclasses.dataclass(frozen=True)
class MethodConfig:
    name: str
    local_lr: float = 0.05
    local_epochs: int = 1
    prox_mu: float = 0.1         # FedProx
    ncv_alpha0: float = 0.5      # FedNCV initial alpha_u
    ncv_alpha_lr: float = 1e-3   # Algorithm 1 line 12 step size
    ncv_beta: float = 1.0        # server-side CV coefficient (paper: 1)
    ncv_alpha_mode: str = "descent"   # "descent" (Alg.1) | "optimal" (Prop.2)
    head_local_steps: int = 3    # FedRep: head-only steps before body pass
    glomo_beta_global: float = 0.9   # FedGLOMO: server momentum coefficient
    glomo_beta_local: float = 0.5    # FedGLOMO: client heavy-ball coefficient


class ClientOut(tp.NamedTuple):
    grad: tp.Any                 # uploaded gradient-like tree, leaves (C, ...)
    cstate: tp.Any               # new per-client state
    aux: tp.Any                  # scalar diagnostics dict, leaves (C,)


def _aggregate(grads_stacked, n_samples, beta, codec=None, spec=None):
    """Cohort aggregation: the dense flat path (identity wire, `codec`
    None), or straight off the codec's stacked wire."""
    if codec is None:
        return cv.networked_aggregate_flat(grads_stacked, n_samples,
                                           beta=beta)
    agg_vec, agg_norm = comm.aggregate_wire(codec, grads_stacked, n_samples,
                                            beta=beta)
    return unravel(agg_vec, spec), agg_norm


def _body_mask(task: Task, params):
    """1.0 for body (aggregated) leaves, 0.0 for personal-head leaves."""
    return {k: tree_map(lambda x: (torch.zeros_like if k in task.head_keys
                                   else torch.ones_like)(
                            x, dtype=torch.float32), v)
            for k, v in params.items()}


def _microbatch_grads(task: Task, params, batches, per_client=False):
    """Per-microbatch gradients of every client: leaves (C, K, ...).

    `params` is the shared model (leaves (...)) or, with `per_client`, one
    model per client (leaves (C, ...))."""
    per_unit = vmap(grad(task.loss), in_dims=(None, 0))
    return vmap(per_unit, in_dims=(0 if per_client else None, 0))(params,
                                                                  batches)


def _sgd_epoch(task: Task, params, batches, lr, grad_tx=None):
    """One pass of sequential SGD over the K microbatches, every client at
    once; `params` leaves are (C, ...).  `grad_tx(params, g)` transforms
    each step's gradients (leaves (C, ...)) before the step."""
    step_grad = vmap(grad(task.loss), in_dims=(0, 0))
    for k in range(_k_of(batches)):
        mb = tree_map(lambda x: x[:, k], batches)
        g = step_grad(params, mb)
        if grad_tx is not None:
            g = grad_tx(params, g)
        params = tree_map(lambda pi, gi: pi - lr * gi, params, g)
    return params


def _k_of(batches) -> int:
    return tree_leaves(batches)[0].shape[1]


def _c_of(batches) -> int:
    return tree_leaves(batches)[0].shape[0]


def _per_client(params, c: int):
    """The shared model broadcast to one copy per client (no copy made)."""
    return tree_map(lambda x: x.expand((c,) + tuple(x.shape)), params)


def _local_sgd(mc, task, start, batches, grad_tx=None):
    """local_epochs passes of `_sgd_epoch` from `start` (leaves (C, ...));
    returns (the final params, the upload (start - final) / (lr * epochs *
    K), the cumulative gradient)."""
    p = start
    for _ in range(mc.local_epochs):
        p = _sgd_epoch(task, p, batches, mc.local_lr, grad_tx=grad_tx)
    denom = mc.local_lr * mc.local_epochs * _k_of(batches)
    return p, tree_map(lambda a, b: (a - b) / denom, start, p)


# ---------------------------------------------------------------------------
# FedAvg
# ---------------------------------------------------------------------------

def fedavg_client(mc: MethodConfig, task: Task, params, cstate, batches,
                  key=None):
    """local_epochs == 1 is the paper's Eq. (2): one mean gradient at
    theta_t.  local_epochs > 1 is multi-step local SGD (cumulative gradient
    upload)."""
    del key
    if mc.local_epochs == 1:
        g = _microbatch_grads(task, params, batches)
        return ClientOut(tree_mean(g, axis=1), cstate, dict())
    _, g = _local_sgd(mc, task, _per_client(params, _c_of(batches)), batches)
    return ClientOut(g, cstate, dict())


# ---------------------------------------------------------------------------
# FedProx: proximal term mu/2 ||p - p_t||^2 in the local objective
# ---------------------------------------------------------------------------

def fedprox_client(mc: MethodConfig, task: Task, params, cstate, batches,
                   key=None):
    del key

    def prox_grad(p, g):
        return tree_map(lambda gi, pi, ai: gi + mc.prox_mu * (pi - ai),
                        g, p, params)

    _, g = _local_sgd(mc, task, _per_client(params, _c_of(batches)), batches,
                      grad_tx=prox_grad)
    return ClientOut(g, cstate, dict())


# ---------------------------------------------------------------------------
# SCAFFOLD: local gradients corrected by (c - c_u); client keeps c_u
# ---------------------------------------------------------------------------

def scaffold_client(mc: MethodConfig, task: Task, params, cstate, batches,
                    key=None):
    del key
    c_global, c_u = cstate["c_global"], cstate["c_u"]

    def corr(p, g):
        return tree_map(lambda gi, cg, cu: gi - cu + cg, g, c_global, c_u)

    _, g = _local_sgd(mc, task, _per_client(params, _c_of(batches)), batches,
                      grad_tx=corr)
    # c_u+ = c_u - c + (1/(steps*lr)) (x - y_local)  (SCAFFOLD option II)
    c_u_new = tree_map(lambda cu, cg, gi: cu - cg + gi, c_u, c_global, g)
    return ClientOut(g, dict(cstate, c_u=c_u_new),
                     dict(delta_c=tree_sub(c_u_new, c_u)))


# ---------------------------------------------------------------------------
# FedNCV (the paper, Algorithm 1)
# ---------------------------------------------------------------------------

def fedncv_client(mc: MethodConfig, task: Task, params, cstate, batches,
                  key=None):
    """Client side of Algorithm 1 (lines 3-8) for the whole cohort.

    Per-microbatch gradients (the RLOO units) are reshaped with the
    leave-one-out baseline scaled by alpha_u (one `rloo_combine` over the
    (C, K, N) stack), optionally used for local SGD steps, and the
    expectation gradient is uploaded with the two sufficient statistics the
    server needs to adapt alpha_u."""
    del key
    alpha = cstate["alpha"]                                    # (C,)
    g_stack = _microbatch_grads(task, params, batches)

    if mc.local_epochs > 1:
        # multi-step variant: apply the RLOO-reshaped gradients in sequence
        _, stats, reshaped = cv.client_pass_flat(g_stack, alpha,
                                                 want_reshaped=True)
        k = _k_of(batches)
        p_local = _per_client(params, alpha.shape[0])
        for _ in range(mc.local_epochs - 1):
            for i in range(k):
                p_local = tree_map(lambda pi, gi: pi - mc.local_lr * gi[:, i],
                                   p_local, reshaped)
            g_stack = _microbatch_grads(task, p_local, batches,
                                        per_client=True)
            msg, stats, reshaped = cv.client_pass_flat(g_stack, alpha,
                                                       want_reshaped=True)
        base = tree_map(
            lambda a, b: (a - b) / (mc.local_lr * (mc.local_epochs - 1) * k),
            params, p_local)
        grad_ = tree_axpy(1.0, msg, base)
        grad_ = tree_scale(grad_, 0.5)   # average drift + final reshaped grad
    else:
        # single fused pass: message == mean_i (g_i - a c_i) = (1-a) gbar
        grad_, stats, _ = cv.client_pass_flat(g_stack, alpha)

    aux = dict(mean_norm_sq=stats.mean_norm_sq, sum_norm_sq=stats.sum_norm_sq,
               k=stats.k, alpha=alpha)
    return ClientOut(grad_, cstate, aux)


# ---------------------------------------------------------------------------
# FedNCV+ (beyond the paper): stale per-client control variates at the
# server, the SAGA-style g = mean_all(h) + mean_cohort(g_u - h_u)
# ---------------------------------------------------------------------------

def fedncv_plus_server(mc, task, params, grads_stacked, n_samples, idx,
                       sstate, lr, m_total, invp=None, alive=None):
    """mean_all(h) comes from the running sum `h_sum` kept in `sstate` and
    updated at the cohort's rows, so a round costs O(cohort * N), not a
    reduction over all m_total stale gradients.

    `invp` ((cohort,) or None): inverse-probability factors 1 / (M q_u) of
    a non-uniform sampler; the correction term is then Horvitz-Thompson
    weighted, (1/C) sum_u invp_u (g_u - h_u).  None is the plain cohort
    mean.  `alive` ((cohort,) 0/1 or None): a client that dropped keeps its
    h row and adds no delta to h_sum.  The h bookkeeping always uses the
    raw deltas."""
    del mc, task, n_samples
    h_all, h_sum = sstate["h"], sstate["h_sum"]   # (M_total, ...), (...)
    h_mean = tree_scale(h_sum, 1.0 / m_total)
    h_cohort = tree_map(lambda h: h[idx], h_all)
    delta = tree_sub(grads_stacked, h_cohort)     # leaves (cohort, ...)

    def rows(v, x):
        return v.reshape((-1,) + (1,) * (x.dim() - 1))

    if invp is None:
        corr = tree_mean(delta, axis=0)
    else:
        corr = tree_map(lambda d: torch.mean(d * rows(invp, d), dim=0), delta)
    agg = tree_map(torch.add, h_mean, corr)
    params = tree_map(lambda p, g: p - lr * g.to(p.dtype), params, agg)
    if alive is not None:
        grads_stacked = tree_map(
            lambda g, h: torch.where(rows(alive, g) > 0, g, h),
            grads_stacked, h_cohort)
        delta = tree_map(lambda d: d * rows(alive, d), delta)

    def put(h, g):
        h = h.clone()
        h[idx] = g
        return h

    h_all = tree_map(put, h_all, grads_stacked)
    h_sum = tree_map(lambda s, d: s + torch.sum(d, dim=0), h_sum, delta)
    return params, dict(sstate, h=h_all, h_sum=h_sum), \
        dict(agg_norm=tree_norm_sq(agg))


# ---------------------------------------------------------------------------
# Personalization baselines: FedRep / FedPer / pFedSim
# ---------------------------------------------------------------------------

def _split_update(task, params, personal):
    """The shared `params` expanded to one copy per client, with the
    cohort's personal head leaves (leaves (C, ...)) overlaid."""
    c = tree_leaves(personal)[0].shape[0]
    return {k: (personal[k] if k in task.head_keys else _per_client(v, c))
            for k, v in params.items()}


def _body_only(task, g):
    """`g` with zeros for the personal-head leaves."""
    return {k: (tree_zeros_like(v) if k in task.head_keys else v)
            for k, v in g.items()}


def fedper_client(mc: MethodConfig, task: Task, params, cstate, batches,
                  key=None):
    """FedPer: train body + head locally; upload the body delta; keep the
    head."""
    del key
    p_local, g = _local_sgd(mc, task,
                            _split_update(task, params, cstate["personal"]),
                            batches)
    personal = {k: p_local[k] for k in task.head_keys}
    return ClientOut(_body_only(task, g), dict(cstate, personal=personal),
                     dict())


def fedrep_client(mc: MethodConfig, task: Task, params, cstate, batches,
                  key=None):
    """FedRep: first fit the personal head (body frozen), then the body."""
    del key
    p_local = _split_update(task, params, cstate["personal"])

    def head_only(p, g):
        return {k: (v if k in task.head_keys else tree_zeros_like(v))
                for k, v in g.items()}

    for _ in range(mc.head_local_steps):
        p_local = _sgd_epoch(task, p_local, batches, mc.local_lr,
                             grad_tx=head_only)
    p_local, g = _local_sgd(mc, task, p_local, batches,
                            grad_tx=lambda p, g: _body_only(task, g))
    personal = {k: p_local[k] for k in task.head_keys}
    return ClientOut(_body_only(task, g), dict(cstate, personal=personal),
                     dict())


def pfedsim_client(mc: MethodConfig, task: Task, params, cstate, batches,
                   key=None):
    """pFedSim (simplified): FedPer's client, uploading also the personal
    head it started from, flattened in `task.head_keys` order, (C, d); the
    similarity-weighted mixing of the heads runs at the server."""
    out = fedper_client(mc, task, params, cstate, batches, key)
    c = _c_of(batches)
    head = torch.cat([cstate["personal"][k].reshape(c, -1)
                      for k in task.head_keys], dim=1)
    return out._replace(aux=dict(head=head))


def pfedsim_server_mix(heads, personals, temp=5.0):
    """Similarity-aware mixing of personal heads (pFedSim's model-similarity
    aggregation, on the classifier only).  heads: (M, d) flattened;
    personals: leaves (M, ...)."""
    norm = heads / (torch.linalg.norm(heads, dim=1, keepdim=True) + 1e-8)
    w = torch.softmax(temp * (norm @ norm.T), dim=1)      # row-stochastic
    return tree_map(lambda ph: torch.tensordot(w, ph, dims=1), personals)
