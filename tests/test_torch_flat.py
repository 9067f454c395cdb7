"""The port's flat substrate and estimator math against the JAX reference.

Inputs are made from a seed with numpy and handed to both packages.
Tolerances are `tests/test_flat_path.py`'s (rtol 1e-5, atol 1e-6): the two
packages sum f32 values in different orders.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import control_variates as jcv
from repro.kernels.rloo import rloo as jrloo
from repro.models import lenet as jlenet
from repro.utils import tree_math as jtm
from repro_torch.core import control_variates as tcv
from repro_torch.kernels.rloo import rloo as trloo
from repro_torch.utils import tree_math as ttm
from repro_torch.weights import params_from_jax

RTOL, ATOL = 1e-5, 1e-6

SHAPE_SETS = [
    {"w": (3, 4), "a": (7,)},
    {"z": (5, 5, 2), "b": (1,), "m": {"y": (13,), "c": (2, 3)}},
    {"k": (129,), "j": (2, 3)},
]


def _np_stack(rng, lead, shapes):
    if isinstance(shapes, dict):
        return {k: _np_stack(rng, lead, v) for k, v in shapes.items()}
    return rng.standard_normal(lead + shapes).astype(np.float32)


def _to_torch(tree):
    return params_from_jax(tree)


def _close(a, b, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("si", range(len(SHAPE_SETS)))
@pytest.mark.parametrize("k", [2, 5])
def test_ravel_unravel_roundtrip_and_layout(si, k):
    rng = np.random.default_rng(si * 10 + k)
    tree = _np_stack(rng, (k,), SHAPE_SETS[si])
    flat, spec = ttm.ravel_stack(_to_torch(tree))
    jflat, jspec = jtm.ravel_stack(jax.tree.map(jnp.asarray, tree))
    # sorted-key leaf order: the same (K, N) buffer, bit for bit
    np.testing.assert_array_equal(flat.numpy(), np.asarray(jflat))
    assert spec.n == jspec.n and spec.offsets == jspec.offsets
    back = ttm.unravel_stack(flat, spec)
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(a, b.numpy()),
                 tree, back)


def test_lenet_flat_vector_is_bitwise_the_reference():
    jp = jlenet.init(jlenet.LeNetConfig(), jax.random.PRNGKey(3))
    tp = params_from_jax(jax.tree.map(np.asarray, jp))
    vec, spec = ttm.ravel(tp)
    jvec, jspec = jtm.ravel(jp)
    assert spec.n == jspec.n == 62006
    assert [p[0] for p in spec.paths] == sorted(jp)
    assert spec.paths[0] == ("b1",)
    np.testing.assert_array_equal(vec.numpy(), np.asarray(jvec))
    back = ttm.unravel(vec, spec)
    for k in jp:
        np.testing.assert_array_equal(back[k].numpy(), np.asarray(jp[k]))


@pytest.mark.parametrize("case", ["plain", "padded", "lone", "uneven"])
@pytest.mark.parametrize("beta", [0.0, 0.5, 1.0])
def test_ncv_coefficients_match_reference(case, beta):
    rng = np.random.default_rng(7)
    n = {"plain": rng.integers(5, 50, 6).astype(np.float32),
         "padded": np.array([12, 30, 0, 7, 0], np.float32),
         "lone": np.array([0, 25, 0, 0], np.float32),
         "uneven": np.array([1, 1000, 3], np.float32)}[case]
    got = trloo.ncv_coefficients(torch.from_numpy(n), beta)
    want = jrloo.ncv_coefficients(jnp.asarray(n), beta)
    assert np.all(np.isfinite(got.numpy()))
    _close(got, want, rtol=1e-6, atol=0)
    if case == "padded":
        assert np.all(got.numpy()[n == 0] == 0.0)


@pytest.mark.parametrize("k", [2, 3, 8])
@pytest.mark.parametrize("si", range(len(SHAPE_SETS)))
def test_client_pass_flat_matches_reference(k, si):
    """The cohort pass (leaves (C, K, ...), alpha (C,)) against the
    reference's per-client pass."""
    rng = np.random.default_rng(100 * k + si)
    c = 3
    g = _np_stack(rng, (c, k), SHAPE_SETS[si])
    alpha = rng.uniform(-0.5, 1.5, c).astype(np.float32)
    msg, stats, gp = tcv.client_pass_flat(_to_torch(g),
                                          torch.from_numpy(alpha),
                                          want_reshaped=True)
    for u in range(c):
        gu = jax.tree.map(lambda x: jnp.asarray(x[u]), g)
        jmsg, jstats, jgp = jcv.client_pass_flat(gu, alpha[u],
                                                 want_reshaped=True)
        jax.tree.map(lambda a, b: _close(a[u], b), msg, jmsg)
        jax.tree.map(lambda a, b: _close(a[u], b), gp, jgp)
        jax.tree.map(lambda a, b: _close(a[u], b), stats.mean_grad,
                     jstats.mean_grad)
        _close(stats.mean_norm_sq[u], jstats.mean_norm_sq)
        _close(stats.sum_norm_sq[u], jstats.sum_norm_sq)
        assert float(stats.k[u]) == float(jstats.k) == k


def test_client_pass_flat_single_client_form():
    rng = np.random.default_rng(5)
    g = _np_stack(rng, (4,), SHAPE_SETS[1])
    msg, stats, _ = tcv.client_pass_flat(_to_torch(g), 0.3)
    jmsg, jstats, _ = jcv.client_pass_flat(jax.tree.map(jnp.asarray, g), 0.3)
    jax.tree.map(lambda a, b: _close(a, b), msg, jmsg)
    _close(stats.sum_norm_sq, jstats.sum_norm_sq)
    assert stats.k.dim() == 0


@pytest.mark.parametrize("beta", [0.0, 0.5, 1.0])
@pytest.mark.parametrize("si", range(len(SHAPE_SETS)))
def test_networked_aggregate_flat_matches_reference(beta, si):
    rng = np.random.default_rng(si + 31)
    m = 5
    g = _np_stack(rng, (m,), SHAPE_SETS[si])
    n = rng.integers(3, 40, m).astype(np.float32)
    agg, nrm = tcv.networked_aggregate_flat(_to_torch(g), torch.from_numpy(n),
                                            beta)
    jagg, jnrm = jcv.networked_aggregate_flat(
        jax.tree.map(jnp.asarray, g), jnp.asarray(n), beta)
    jax.tree.map(lambda a, b: _close(a, b), agg, jagg)
    _close(nrm, jnrm, rtol=1e-4)
    # the naive stacked oracle agrees with both
    naive = tcv.networked_aggregate_stacked(_to_torch(g), torch.from_numpy(n),
                                            beta)
    jax.tree.map(lambda a, b: _close(a, b, atol=1e-5), naive, jagg)


def test_naive_rloo_oracles_match_reference():
    rng = np.random.default_rng(9)
    g = _np_stack(rng, (4,), SHAPE_SETS[0])
    jg = jax.tree.map(jnp.asarray, g)
    jax.tree.map(lambda a, b: _close(a, b),
                 tcv.loo_baselines(_to_torch(g)), jcv.loo_baselines(jg))
    jax.tree.map(lambda a, b: _close(a, b),
                 tcv.rloo_reshape(_to_torch(g), 0.7),
                 jcv.rloo_reshape(jg, 0.7))


def test_alpha_updates_match_reference():
    rng = np.random.default_rng(11)
    c = 6
    k = np.full(c, 4.0, np.float32)
    s1 = rng.uniform(0.01, 2.0, c).astype(np.float32)
    s2 = (s1 * 4 + rng.uniform(0.1, 3.0, c)).astype(np.float32)
    alpha = rng.uniform(0, 1, c).astype(np.float32)
    tstats = tcv.ClientCVStats(None, *(torch.from_numpy(x)
                                      for x in (k, s1, s2)))
    for u in range(c):
        jstats = jcv.ClientCVStats(None, jnp.float32(k[u]), jnp.float32(s1[u]),
                                   jnp.float32(s2[u]))
        _close(tcv.alpha_descent_update(torch.from_numpy(alpha), tstats,
                                        0.05)[u],
               jcv.alpha_descent_update(jnp.float32(alpha[u]), jstats, 0.05))
        _close(tcv.optimal_alpha_single(tstats)[u],
               jcv.optimal_alpha_single(jstats))
        for a, b in zip(tcv.rloo_scalar_moments(tstats),
                        jcv.rloo_scalar_moments(jstats)):
            _close(a[u], b)
