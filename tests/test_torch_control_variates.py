"""The port's tree-form RLOO estimator against the reference's, on the CPU.

Mirrors tests/test_control_variates.py for `client_stats_from_stack`,
`client_message`, `server_loo_baselines`, `server_loo_from_mean` and
`networked_aggregate`: each identity the reference pins is checked on the
port, and the port's value is held to the reference's on the same numpy
inputs.  Then the MLP's logits against the reference's from the same
weights.

Tolerances: the identities keep the reference's own (2e-5 to 1e-4: the
two sides of an identity sum in different orders); port vs reference on
the same inputs rtol 1e-5 / atol 1e-6 at the client level (one pass of
f32 arithmetic, no cancellation), and at the server level the
reference's own rtol 1e-4 / atol 1e-5 (n gbar_w - n_u g_u cancels, and
XLA may fuse it into one FMA); the MLP's logits rtol = atol = 1e-5, as
LeNet's (tests/test_torch_lenet.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch
from hypothesis import given, settings, strategies as st

from repro.core import control_variates as jcv
from repro.models import lenet as jlenet
from repro_torch.core import control_variates as cv
from repro_torch.models import lenet as tlenet
from repro_torch.utils.tree_math import (tree_dot, tree_map, tree_mean,
                                         tree_norm_sq, tree_sub)
from repro_torch.weights import params_from_jax

SAME = dict(rtol=1e-5, atol=1e-6)
SERVER = dict(rtol=1e-4, atol=1e-5)


def _rand_stack(rng, k, shapes=((3, 4), (7,))):
    """A stacked gradient tree with K entries, as numpy arrays."""
    return {f"w{j}": rng.standard_normal((k,) + s).astype(np.float32)
            for j, s in enumerate(shapes)}


def _t(tree):
    return tree_map(torch.from_numpy, tree)


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


def _close(port, ref, **tol):
    """Port tree vs reference tree (or scalar), leaf by leaf."""
    if isinstance(ref, dict):
        assert sorted(port) == sorted(ref)
        for k in ref:
            _close(port[k], ref[k], **tol)
    else:
        np.testing.assert_allclose(np.asarray(port), np.asarray(ref), **tol)


def _clients(rng, m, shape=(3,)):
    return [{"w": rng.standard_normal(shape).astype(np.float32)}
            for _ in range(m)]


# ----------------------------- client level --------------------------------

@given(k=st.integers(2, 8), alpha=st.floats(-1.0, 2.0),
       seed=st.integers(0, 2**31 - 1))
@settings(max_examples=10, deadline=None)
def test_client_message_collapse(k, alpha, seed):
    """mean_i (g_i - alpha c_i) == (1 - alpha) gbar, and the reference's."""
    g = _rand_stack(np.random.default_rng(seed), k)
    msg_naive = tree_mean(cv.rloo_reshape(_t(g), alpha), axis=0)
    stats = cv.client_stats_from_stack(_t(g))
    msg = cv.client_message(stats, alpha)
    _close(msg, msg_naive, rtol=3e-5, atol=3e-6)
    _close(msg, jcv.client_message(jcv.client_stats_from_stack(_j(g)),
                                   alpha), **SAME)


@given(k=st.integers(3, 10), seed=st.integers(0, 2**31 - 1))
@settings(max_examples=10, deadline=None)
def test_stats_and_scalar_moments_match_reference(k, seed):
    """ClientCVStats and the closed-form E[g c], E[c^2] against the naive
    computation and the reference's."""
    g = _rand_stack(np.random.default_rng(seed), k)
    stats = cv.client_stats_from_stack(_t(g))
    jstats = jcv.client_stats_from_stack(_j(g))
    _close(stats.mean_grad, jstats.mean_grad, **SAME)
    for a, b in ((stats.k, jstats.k),
                 (stats.mean_norm_sq, jstats.mean_norm_sq),
                 (stats.sum_norm_sq, jstats.sum_norm_sq)):
        np.testing.assert_allclose(float(a), float(b), **SAME)
    e_gc, e_cc = cv.rloo_scalar_moments(stats)
    c = cv.loo_baselines(_t(g))
    gi = [tree_map(lambda x: x[i], _t(g)) for i in range(k)]
    ci = [tree_map(lambda x: x[i], c) for i in range(k)]
    np.testing.assert_allclose(
        float(e_gc), np.mean([float(tree_dot(a, b)) for a, b in zip(gi, ci)]),
        rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(
        float(e_cc), np.mean([float(tree_norm_sq(b)) for b in ci]),
        rtol=1e-4, atol=1e-5)


def test_optimal_alpha_minimizes_second_moment():
    """Prop. 2: alpha* = E[gc]/E[cc] from the tree-form stats minimizes the
    second moment of the reshaped estimator, as in the reference."""
    rng = np.random.default_rng(0)
    g = {"w": (rng.standard_normal((64, 1)) + 3.0).astype(np.float32)}
    stats = cv.client_stats_from_stack(_t(g))
    a_star = float(cv.optimal_alpha_single(stats))
    np.testing.assert_allclose(
        a_star, float(jcv.optimal_alpha_single(
            jcv.client_stats_from_stack(_j(g)))), rtol=1e-5)

    def second_moment(alpha):
        return float(torch.mean(cv.rloo_reshape(_t(g), alpha)["w"] ** 2))

    for other in (a_star + 0.2, a_star - 0.2, 0.0):
        assert second_moment(a_star) <= second_moment(other) + 1e-9


def test_alpha_descent_moves_toward_one():
    """Algorithm 1 line 12 from the tree-form stats drives alpha up, within
    the clamp, as the reference's does."""
    g = _rand_stack(np.random.default_rng(1), 4)
    stats = cv.client_stats_from_stack(_t(g))
    jstats = jcv.client_stats_from_stack(_j(g))
    a = torch.tensor(0.1)
    for _ in range(5):
        a_new = cv.alpha_descent_update(a, stats, lr=1e-3)
        np.testing.assert_allclose(
            float(a_new), float(jcv.alpha_descent_update(
                jnp.float32(float(a)), jstats, lr=1e-3)), **SAME)
        assert float(a_new) >= float(a)
        a = a_new
    assert float(cv.alpha_descent_update(torch.tensor(0.9), stats,
                                         lr=1e3)) <= 1.0


# ----------------------------- server level --------------------------------

@given(m=st.integers(2, 6), seed=st.integers(0, 2**31 - 1))
@settings(max_examples=10, deadline=None)
def test_server_loo_reduced_identity(m, seed):
    """Naive Eq. 10 baseline == weighted mean + rank correction, and both
    equal the reference's."""
    rng = np.random.default_rng(seed)
    grads = _clients(rng, m)
    n_u = rng.integers(1, 50, size=m).astype(np.float32)
    tn = torch.from_numpy(n_u)
    n, p = torch.sum(tn), tn / torch.sum(tn)
    tg = [_t(g) for g in grads]
    gbar_w = {"w": sum(w * g["w"] for w, g in zip(p, tg))}
    naive = cv.server_loo_baselines(tg, tn)
    jnaive = jcv.server_loo_baselines([_j(g) for g in grads],
                                      jnp.asarray(n_u))
    jn = jnp.sum(jnp.asarray(n_u))
    jgbar = {"w": np.asarray(gbar_w["w"])}
    for u in range(m):
        red = cv.server_loo_from_mean(gbar_w, tg[u], tn[u], n)
        _close(red, naive[u], **SERVER)
        _close(naive[u], jnaive[u], **SERVER)
        _close(red, jcv.server_loo_from_mean(
            _j(jgbar), _j(grads[u]), jnp.float32(n_u[u]), jn), **SERVER)


def test_full_participation_equal_weight_degeneracy():
    """beta = 1 and equal weights: the aggregate is exactly 0."""
    grads = _clients(np.random.default_rng(2), 4, (5,))
    agg = cv.networked_aggregate([_t(g) for g in grads],
                                 torch.full((4,), 10.0), beta=1.0)
    np.testing.assert_allclose(agg["w"].numpy(), 0.0, atol=1e-5)


def test_beta_zero_is_fedavg():
    grads = _clients(np.random.default_rng(3), 4, (5,))
    n_u = np.float32([1.0, 2.0, 3.0, 4.0])
    agg = cv.networked_aggregate([_t(g) for g in grads], n_u, beta=0.0)
    p = n_u / n_u.sum()
    expected = sum(pi * g["w"] for pi, g in zip(p, grads))
    np.testing.assert_allclose(agg["w"].numpy(), expected, rtol=1e-5,
                               atol=1e-6)


@given(m=st.integers(2, 6), beta=st.floats(0.0, 1.0),
       seed=st.integers(0, 2**31 - 1))
@settings(max_examples=10, deadline=None)
def test_aggregate_matches_stacked_and_reference(m, beta, seed):
    """The list form == the stacked form == the reference's list form."""
    rng = np.random.default_rng(seed)
    grads = _clients(rng, m, (4,))
    n_u = rng.integers(1, 30, size=m).astype(np.float32)
    a = cv.networked_aggregate([_t(g) for g in grads], n_u, beta=beta)
    b = cv.networked_aggregate_stacked(
        {"w": torch.from_numpy(np.stack([g["w"] for g in grads]))}, n_u,
        beta=beta)
    _close(a, b, **SERVER)
    _close(a, jcv.networked_aggregate([_j(g) for g in grads],
                                      jnp.asarray(n_u), beta=beta), **SERVER)


def test_server_loo_correction_is_drift_direction():
    """Equal weights: g_u - c_{V\\u} == M/(M-1) (g_u - gbar)."""
    m = 6
    grads = [_t(g) for g in _clients(np.random.default_rng(4), m, (5,))]
    gbar = {"w": sum(g["w"] for g in grads) / m}
    baselines = cv.server_loo_baselines(grads, torch.full((m,), 8.0))
    for u in range(m):
        _close(tree_sub(grads[u], baselines[u]),
               {"w": (m / (m - 1)) * (grads[u]["w"] - gbar["w"])},
               rtol=1e-4, atol=1e-5)


# ----------------------------- the MLP --------------------------------------

def test_mlp_logits_and_loss_match_reference():
    jcfg, tcfg = jlenet.MLPConfig(), tlenet.MLPConfig()
    jp = jlenet.init_mlp(jcfg, jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp))
    own = tlenet.init_mlp(tcfg, torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in own.items()} == \
        {k: v.shape for k, v in jp.items()}
    rng = np.random.default_rng(0)
    x = rng.standard_normal((8, jcfg.in_dim)).astype(np.float32)
    y = rng.integers(0, jcfg.n_classes, 8)
    np.testing.assert_allclose(
        tlenet.forward_mlp(tcfg, tp, torch.from_numpy(x)).numpy(),
        np.asarray(jlenet.forward_mlp(jcfg, jp, jnp.asarray(x))),
        rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        float(tlenet.loss_mlp(tcfg, tp, dict(images=torch.from_numpy(x),
                                             labels=torch.from_numpy(y)))),
        float(jlenet.loss_mlp(jcfg, jp, dict(images=jnp.asarray(x),
                                             labels=jnp.asarray(y)))),
        rtol=1e-5, atol=1e-5)
