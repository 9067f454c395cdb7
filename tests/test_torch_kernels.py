"""The port's kernel wrappers on the CPU (their plain versions) against the
reference's Pallas kernels run in interpret mode, as `tests/test_kernels.py`
runs them; and the wrappers' input checks and launch counts.

Tolerances are `tests/test_kernels.py`'s: rtol 1e-5 / atol 1e-5 for the
vectors, rtol 1e-4 for the sums of squares (f32 sums in another order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rloo import rloo as jrloo
from repro_torch.kernels.rloo import rloo as K
from repro_torch.kernels.rloo.ref import ncv_aggregate_ref


def _g(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("k", [2, 4, 8])
@pytest.mark.parametrize("n", [1000, 4096])
def test_rloo_combine_matches_pallas_interpret(k, n):
    c = 2
    g = _g(k * n, c, k, n)
    alpha = np.array([0.65, -0.2], np.float32)
    launches = K.rloo_combine.launches
    mean, gp, s2 = K.rloo_combine(torch.from_numpy(g), torch.from_numpy(alpha))
    assert K.rloo_combine.launches == launches      # CPU: plain version
    for u in range(c):
        jm, jgp, js2 = jrloo.rloo_combine(jnp.asarray(g[u]),
                                          jnp.float32(alpha[u]),
                                          interpret=True)
        np.testing.assert_allclose(mean[u].numpy(), np.asarray(jm),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(gp[u].numpy(), np.asarray(jgp),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(float(s2[u]), float(js2), rtol=1e-4)


@pytest.mark.parametrize("m", [1, 3, 10])
@pytest.mark.parametrize("n", [1000, 4096])
def test_ncv_weighted_sum_matches_pallas_interpret(m, n):
    g = _g(m * n + 1, m, n)
    w = np.random.default_rng(m).uniform(-0.5, 1.0, m).astype(np.float32)
    agg, nrm = K.ncv_weighted_sum(torch.from_numpy(g), torch.from_numpy(w))
    jagg, jnrm = jrloo.ncv_weighted_sum(jnp.asarray(g), jnp.asarray(w),
                                        interpret=True)
    np.testing.assert_allclose(agg.numpy(), np.asarray(jagg), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(float(nrm), float(jnrm), rtol=1e-4)


@pytest.mark.parametrize("beta", [0.0, 1.0])
def test_ncv_aggregate_matches_pallas_interpret_and_oracle(beta):
    g = _g(5, 6, 1500)
    n_samples = np.array([10, 3, 0, 25, 7, 1], np.float32)
    agg, nrm = K.ncv_aggregate(torch.from_numpy(g),
                               torch.from_numpy(n_samples), beta)
    jagg, jnrm = jrloo.ncv_aggregate(jnp.asarray(g), jnp.asarray(n_samples),
                                     beta, interpret=True)
    np.testing.assert_allclose(agg.numpy(), np.asarray(jagg), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(float(nrm), float(jnrm), rtol=1e-4)
    oagg, onrm = ncv_aggregate_ref(torch.from_numpy(g),
                                   torch.from_numpy(n_samples), beta)
    np.testing.assert_allclose(agg.numpy(), oagg.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_wrappers_reject_what_the_kernels_do_not_take():
    g = torch.zeros(3, 4, 100)
    alpha = torch.zeros(3)
    with pytest.raises(ValueError, match="K >= 2"):
        K.rloo_combine(g[:, :1], alpha)
    with pytest.raises(TypeError):
        K.rloo_combine(g.double(), alpha)
    with pytest.raises(ValueError):
        K.rloo_combine(g[0], alpha)
    with pytest.raises(ValueError):
        K.rloo_combine(g, torch.zeros(2))
    with pytest.raises(ValueError):
        K.ncv_weighted_sum(g[:, 0], torch.zeros(4))


def test_non_cpu_tensors_never_take_the_plain_version():
    """Only a CPU tensor takes the plain version: any other device goes to
    the kernel path, which refuses what it cannot launch."""
    g = torch.zeros(3, 4, 100, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        K.rloo_combine(g, torch.zeros(3, device="meta"))
    with pytest.raises(ValueError, match="CUDA"):
        K.ncv_weighted_sum(g[:, 0], torch.zeros(3, device="meta"))
