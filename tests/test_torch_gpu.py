"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Imports no JAX, so it runs on a machine with the card and PyTorch only:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Without a card every test skips (decided in the `cuda` fixture, never at
import, so every pytest-xdist worker collects the same tests).
"""
import numpy as np
import pytest
import torch

from repro_torch.data import federated_splits
from repro_torch.fed import FLConfig, Simulator, Task
from repro_torch.kernels.rloo import rloo as K
from repro_torch.kernels.rloo.ref import (ncv_weighted_sum_q4_ref,
                                          ncv_weighted_sum_q_ref,
                                          ncv_weighted_sum_ref,
                                          rloo_combine_ref)
from repro_torch.kernels.robust import robust as R
from repro_torch.kernels.robust.ref import rank_band_mean_ref
from repro_torch.models import lenet

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    # LeNet's convolutions would otherwise run in TF32 through cuDNN
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _randn(seed, *shape):
    return torch.from_numpy(
        np.random.default_rng(seed).standard_normal(shape).astype(np.float32))


@pytest.mark.parametrize("c,k,n", [(10, 4, 62006), (10, 2, 62006),
                                   (3, 3, 1000), (1, 8, 4097)])
def test_rloo_combine_kernel_matches_plain(cuda, c, k, n):
    g = _randn(c * k + n, c, k, n).to(cuda)
    alpha = torch.linspace(0.0, 0.9, c).to(cuda)
    got = K.rloo_combine(g, alpha)
    want = rloo_combine_ref(g, alpha)
    torch.cuda.synchronize()
    # f32 sums over K in another order: the reference kernel tests' tolerances
    torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(got[1], want[1], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(got[2], want[2], rtol=1e-4, atol=0.0)


@pytest.mark.parametrize("m,n", [(10, 62006), (2, 62006), (7, 1000),
                                 (1, 300)])
def test_ncv_weighted_sum_kernel_matches_plain(cuda, m, n):
    g = _randn(m + n, m, n).to(cuda)
    w = torch.linspace(0.1, 1.0, m).to(cuda)
    agg, nrm = K.ncv_weighted_sum(g, w)
    agg_r, nrm_r = ncv_weighted_sum_ref(g, w)
    torch.cuda.synchronize()
    torch.testing.assert_close(agg, agg_r, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(nrm, nrm_r, rtol=1e-4, atol=0.0)


def test_kernels_are_deterministic(cuda):
    g = _randn(1, 10, 4, 62006).to(cuda)
    alpha = torch.full((10,), 0.3, device=cuda)
    a, b = K.rloo_combine(g, alpha), K.rloo_combine(g, alpha)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    w = torch.linspace(0.1, 1.0, 10).to(cuda)
    g2 = g[:, 0].contiguous()
    a, b = K.ncv_weighted_sum(g2, w), K.ncv_weighted_sum(g2, w)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    g = torch.zeros(3, 4, 100, device=cuda)
    alpha = torch.zeros(3, device=cuda)
    with pytest.raises(ValueError):
        K.rloo_combine(g.transpose(1, 2).contiguous().transpose(1, 2), alpha)
    with pytest.raises(TypeError):
        K.rloo_combine(g.double(), alpha)
    with pytest.raises(ValueError):
        K.rloo_combine(g[:, :1].contiguous(), alpha)
    with pytest.raises(ValueError):
        K.rloo_combine(g, alpha.cpu())
    with pytest.raises(ValueError):
        K.ncv_weighted_sum(g[:, 0], torch.zeros(4, device=cuda))


def test_fedncv_round_launches_kernels_and_matches_cpu(cuda):
    spec, train, test = federated_splits("cifar10", n_clients=6, alpha=0.1,
                                         seed=0, scale=0.02)
    cfg = lenet.LeNetConfig()
    task = Task(loss=lambda p, b: lenet.loss_fn(cfg, p, b),
                accuracy=lambda p, b: lenet.accuracy(cfg, p, b))
    fl = FLConfig.make(method="fedncv", n_clients=6, cohort=3, k_micro=3,
                       micro_batch=4, server_lr=0.5, local_lr=0.05,
                       local_epochs=2, ncv_alpha0=0.3, ncv_alpha_lr=1e-2,
                       ncv_beta=1.0)
    params = lenet.init(cfg, torch.Generator().manual_seed(0))
    sim = Simulator(task, params, train, fl, seed=0)
    assert sim.device.type == "cuda"
    draws = [sim._draw_cohort_sel() for _ in range(2)]
    r0, w0 = K.rloo_combine.launches, K.ncv_weighted_sum.launches
    diags = sim.run_rounds(2, draws=draws)
    assert K.rloo_combine.launches - r0 == 4
    assert K.ncv_weighted_sum.launches - w0 == 2
    cpu = Simulator(task, params, train, fl, seed=0, device="cpu")
    cdiags = cpu.run_rounds(2, draws=draws)
    # f32 convolutions and reductions in another order on the card
    for k, v in sim.params.items():
        torch.testing.assert_close(v.cpu(), cpu.params[k], rtol=1e-4,
                                   atol=1e-5)
    np.testing.assert_allclose(diags["agg_norm"], cdiags["agg_norm"],
                               rtol=1e-4)
    assert abs(sim.evaluate(test) - cpu.evaluate(test)) <= 1e-2


def _wire(seed, m, n_chunks, chunk, int4):
    rng = np.random.default_rng(seed)
    if int4:
        q = rng.integers(0, 256, (m, n_chunks * chunk // 2), dtype=np.uint8)
    else:
        q = rng.integers(-127, 128, (m, n_chunks * chunk), dtype=np.int8)
    s = rng.uniform(1e-4, 1e-2, (m, n_chunks)).astype(np.float32)
    w = rng.uniform(-0.2, 1.0, m).astype(np.float32)
    return torch.from_numpy(q), torch.from_numpy(s), torch.from_numpy(w)


def _close_scaled(got, want):
    # f32 sums of M terms in another order: atol scaled to the output
    scale = float(want.abs().max()) or 1.0
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * scale)


@pytest.mark.parametrize("int4", [False, True])
@pytest.mark.parametrize("m,n_chunks,chunk", [(10, 122, 512), (12, 122, 512),
                                              (2, 3, 512), (40, 7, 100)])
def test_quantized_weighted_sum_kernels_match_plain(cuda, int4, m, n_chunks,
                                                    chunk):
    q, s, w = (t.to(cuda) for t in _wire(m * n_chunks, m, n_chunks, chunk,
                                         int4))
    kern, plain = ((K.ncv_weighted_sum_q4, ncv_weighted_sum_q4_ref) if int4
                   else (K.ncv_weighted_sum_q, ncv_weighted_sum_q_ref))
    before = kern.launches
    agg, nrm = kern(q, s, w, chunk=chunk)
    agg_r, nrm_r = plain(q, s, w, chunk=chunk)
    torch.cuda.synchronize()
    assert kern.launches == before + 1
    _close_scaled(agg, agg_r)
    torch.testing.assert_close(nrm, nrm_r, rtol=1e-4, atol=0.0)
    again = kern(q, s, w, chunk=chunk)
    assert torch.equal(agg, again[0]) and torch.equal(nrm, again[1])


def _stack_with_ties(seed, m, n):
    rng = np.random.default_rng(seed)
    # a coarse grid makes ties common
    g = np.round(rng.standard_normal((m, n)) * 4.0) / 4.0
    return torch.from_numpy(g.astype(np.float32))


@pytest.mark.parametrize("m,n", [(10, 62006), (12, 62006), (2, 1000),
                                 (256, 777), (33, 4099)])
def test_rank_band_mean_kernel_matches_plain(cuda, m, n):
    g = _stack_with_ties(m + n, m, n).to(cuda)
    alive = torch.ones(m)
    alive[::4] = 0.0                      # dead rows
    alive = alive.to(cuda)
    m_v = float(alive.sum())
    k, mid = min(1.0, np.floor((m_v - 1) / 2)), np.floor((m_v - 1) / 2)
    # the trimmed mean's, the median's and the full band
    for lo, hi in ((k, m_v - 1 - k), (mid, m_v - 1 - mid), (0.0, m_v - 1)):
        lo_t = torch.tensor(lo, dtype=torch.float32, device=cuda)
        hi_t = torch.tensor(hi, dtype=torch.float32, device=cuda)
        before = R.rank_band_mean.launches
        agg, nrm = R.rank_band_mean(g, alive, lo_t, hi_t)
        agg_r, nrm_r = rank_band_mean_ref(g, alive, lo_t, hi_t)
        torch.cuda.synchronize()
        assert R.rank_band_mean.launches == before + 1
        _close_scaled(agg, agg_r)
        torch.testing.assert_close(nrm, nrm_r, rtol=1e-4, atol=1e-6)
        again = R.rank_band_mean(g, alive, lo_t, hi_t)
        assert torch.equal(agg, again[0]) and torch.equal(nrm, again[1])


def test_rank_band_mean_refuses_rows_beyond_shared_memory(cuda):
    g = torch.zeros(R.MAX_ROWS + 1, 64, device=cuda)
    with pytest.raises(ValueError, match=str(R.MAX_ROWS)):
        R.rank_band_mean(g, torch.ones(R.MAX_ROWS + 1, device=cuda), 0.0,
                         0.0)


@pytest.mark.parametrize("kw,kernel", [
    (dict(codec="int8"), "q8"), (dict(codec="int4"), "q4"),
    (dict(codec="bf16"), "wsum"),
    (dict(aggregator="median", codec="int8", ncv_beta=0.0), "band"),
    (dict(aggregator="norm_clip", ncv_beta=0.0), "wsum"),
])
def test_wire_and_robust_rounds_launch_their_kernels(cuda, kw, kernel):
    spec, train, test = federated_splits("cifar10", n_clients=6, alpha=0.1,
                                         seed=0, scale=0.02)
    cfg = lenet.LeNetConfig()
    task = Task(loss=lambda p, b: lenet.loss_fn(cfg, p, b),
                accuracy=lambda p, b: lenet.accuracy(cfg, p, b))
    fl = FLConfig.make(method="fedncv", n_clients=6, cohort=4, k_micro=3,
                       micro_batch=4, server_lr=0.5, local_lr=0.05,
                       local_epochs=2, ncv_alpha0=0.3, **kw)
    params = lenet.init(cfg, torch.Generator().manual_seed(0))
    sim = Simulator(task, params, train, fl, seed=0)
    fns = dict(q8=K.ncv_weighted_sum_q, q4=K.ncv_weighted_sum_q4,
               wsum=K.ncv_weighted_sum, band=R.rank_band_mean)
    before = fns[kernel].launches
    diags = sim.run_rounds(2)
    assert fns[kernel].launches - before == 2
    assert np.isfinite(diags["agg_norm"]).all()
    assert all(bool(torch.isfinite(v).all()) for v in sim.params.values())
