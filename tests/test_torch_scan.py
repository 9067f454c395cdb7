"""The port's selective scan against the JAX package's, on the CPU.

The plain scan (`repro_torch.kernels.selective_scan.ref`, the CPU path of
the kernel wrapper) against the reference's oracle `selective_scan_ref` and
the Pallas kernel in interpret mode, on the reference's sweep shapes plus a
batch axis and a ragged S; `scan_states` against the model's associative
scan; the Mamba causal convolution.  Inputs are made with numpy from a seed.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.selective_scan.ref import selective_scan_ref
from repro.kernels.selective_scan.selective_scan import \
    selective_scan as jax_kernel
from repro.models import ssm as jssm
from repro_torch.kernels.selective_scan import selective_scan as SS
from repro_torch.kernels.selective_scan.ops import scan_states
from repro_torch.models import ssm as tssm

# jitted once per shape: eager associative scans take seconds each
jax_ref = jax.jit(selective_scan_ref)
model_scan = jax.jit(jssm.selective_scan)
# the reference kernel tests' tolerance (a doubling scan against an
# associative scan: f32 products in another order)
TOL = 2e-4
# tests/test_kernels.py::test_selective_scan_sweep of the reference
SWEEP = [(128, 64, 128), (256, 256, 128), (512, 100, 64), (1024, 32, 256)]


def _ab(seed, shape):
    rng = np.random.default_rng(seed)
    # a in (0, 1) like exp(dt * A) with A < 0
    a = 1.0 / (1.0 + np.exp(-rng.standard_normal(shape)))
    return a.astype(np.float32), rng.standard_normal(shape).astype(np.float32)


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("s,c,chunk", SWEEP)
def test_plain_scan_matches_reference_and_pallas(s, c, chunk):
    a, b = _ab(s + c, (s, c))
    got = SS.selective_scan(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.float32
    _close(got, jax_ref(jnp.asarray(a), jnp.asarray(b)))
    _close(got, jax_kernel(jnp.asarray(a), jnp.asarray(b), chunk=chunk,
                           interpret=True))


@pytest.mark.parametrize("shape", [(3, 100, 40), (2, 77, 33), (1, 1, 5)])
def test_plain_scan_batch_axis_and_ragged_length(shape):
    """(B, S, C): each batch row is the reference's (S, C) scan; any S."""
    a, b = _ab(sum(shape), shape)
    got = SS.selective_scan(torch.from_numpy(a), torch.from_numpy(b))
    for i in range(shape[0]):
        _close(got[i], jax_ref(jnp.asarray(a[i]), jnp.asarray(b[i])))


def test_plain_scan_takes_bf16():
    a, b = _ab(9, (64, 16))
    a16 = torch.from_numpy(a).bfloat16()
    got = SS.selective_scan(a16, torch.from_numpy(b))
    want = jax_ref(jnp.asarray(a).astype(jnp.bfloat16), jnp.asarray(b))
    assert got.dtype == torch.float32
    _close(got, want)


@pytest.mark.parametrize("batch", [1, 2])
def test_scan_states_matches_model_scan(batch):
    """(B, S, di, N): each batch row is the model's (S, di, N) scan."""
    s, di, n = 64, 16, 8
    a, b = _ab(5 + batch, (batch, s, di, n))
    got = scan_states(torch.from_numpy(a), torch.from_numpy(b))
    assert got.shape == b.shape
    for i in range(batch):
        want = model_scan(jnp.asarray(a[i]), jnp.asarray(b[i]))
        _close(got[i], want)


def test_scan_states_broadcasts_a():
    """Mamba-2 style: one a per (S, H) broadcast over the state axes."""
    a, b = _ab(6, (32, 4, 8, 3))
    a1 = a[:, :, :1, :1]
    got = scan_states(torch.from_numpy(a1)[None], torch.from_numpy(b)[None])
    want = model_scan(jnp.asarray(a1) * jnp.ones_like(b), jnp.asarray(b))
    _close(got[0], want)


def test_scan_wrapper_checks_shapes():
    a, b = _ab(0, (8, 4))
    with pytest.raises(ValueError):
        SS.selective_scan(torch.from_numpy(a), torch.from_numpy(b[:, :2]))
    with pytest.raises(ValueError):
        SS.selective_scan(torch.from_numpy(a)[None, None],
                          torch.from_numpy(b)[None, None])
    with pytest.raises(TypeError):
        SS.selective_scan(torch.zeros(8, 4, dtype=torch.int32),
                          torch.from_numpy(b))


@pytest.mark.parametrize("with_bias", [False, True])
def test_causal_conv1d_matches_reference(with_bias):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 10, 6)).astype(np.float32)
    w = rng.standard_normal((4, 6)).astype(np.float32)
    bias = rng.standard_normal((6,)).astype(np.float32) if with_bias else None
    got = tssm.causal_conv1d(torch.from_numpy(x), torch.from_numpy(w),
                             None if bias is None else torch.from_numpy(bias))
    for i in range(2):
        want = jssm.causal_conv1d(jnp.asarray(x[i]), jnp.asarray(w),
                                  None if bias is None else jnp.asarray(bias))
        _close(got[i], want, 1e-6)
