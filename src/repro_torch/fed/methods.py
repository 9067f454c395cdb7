"""Client/server building blocks of the federated methods ported so far:
FedAvg and FedNCV (the paper, Algorithm 1).

The reference (`src/repro/fed/methods.py`) writes one client's pass and
vmaps it over the cohort.  Here the cohort axis is written out: `batches`
is a tree whose leaves are (C, K, micro_batch, ...) — C clients, K RLOO
units each — per-client state leaves are (C, ...), and a client function
returns uploads with leaves (C, ...).  That lets the RLOO pass of the whole
cohort run as one `rloo_combine` launch over a (C, K, N) stack.
"""
from __future__ import annotations

import dataclasses
import typing as tp

import torch
from torch.func import grad, vmap

from repro_torch import comm
from repro_torch.core import control_variates as cv
from repro_torch.utils.tree_math import (tree_axpy, tree_leaves, tree_map,
                                         tree_mean, tree_scale, unravel)


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
    ncv_alpha0: float = 0.5      # FedNCV initial alpha_u
    ncv_alpha_lr: float = 1e-3   # Algorithm 1 line 12 step size
    ncv_beta: float = 1.0        # server-side CV coefficient (paper: 1)
    ncv_alpha_mode: str = "descent"   # "descent" (Alg.1) | "optimal" (Prop.2)


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


def _microbatch_grads(task: Task, params, batches, per_client=False):
    """Per-microbatch gradients of every client: leaves (C, K, ...).

    `params` is the shared model (leaves (...)) or, with `per_client`, one
    model per client (leaves (C, ...))."""
    per_unit = vmap(grad(task.loss), in_dims=(None, 0))
    return vmap(per_unit, in_dims=(0 if per_client else None, 0))(params,
                                                                  batches)


def _sgd_epoch(task: Task, params, batches, lr):
    """One pass of sequential SGD over the K microbatches, every client at
    once; `params` leaves are (C, ...)."""
    step_grad = vmap(grad(task.loss), in_dims=(0, 0))
    for k in range(_k_of(batches)):
        mb = tree_map(lambda x: x[:, k], batches)
        g = step_grad(params, mb)
        params = tree_map(lambda pi, gi: pi - lr * gi, params, g)
    return params


def _k_of(batches) -> int:
    return tree_leaves(batches)[0].shape[1]


def _per_client(params, c: int):
    """The shared model broadcast to one copy per client (no copy made)."""
    return tree_map(lambda x: x.expand((c,) + tuple(x.shape)), params)


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
    c = tree_leaves(batches)[0].shape[0]
    p_local = _per_client(params, c)
    for _ in range(mc.local_epochs):
        p_local = _sgd_epoch(task, p_local, batches, mc.local_lr)
    denom = mc.local_lr * mc.local_epochs * _k_of(batches)
    g = tree_map(lambda a, b: (a - b) / denom, params, p_local)
    return ClientOut(g, cstate, dict())


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
