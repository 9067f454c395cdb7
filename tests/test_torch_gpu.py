"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Imports no JAX, so it runs on a machine with the card and PyTorch only:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Without a card every test skips (decided in the `cuda` fixture, never at
import, so every pytest-xdist worker collects the same tests).
"""
import numpy as np
import pytest
import torch

from repro_torch import comm, configs
from repro_torch.data import federated_splits
from repro_torch.fed import FLConfig, Simulator, Task
from repro_torch.kernels import reduction
from repro_torch.kernels.flash_attention import flash_attention as FA
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.kernels.rloo import rloo as K
from repro_torch.kernels.rloo.ref import (ncv_weighted_sum_q4_ref,
                                          ncv_weighted_sum_q_ref,
                                          ncv_weighted_sum_ref,
                                          rloo_combine_ref)
from repro_torch.kernels.robust import robust as R
from repro_torch.kernels.robust.ref import (rank_band_mean_ref,
                                            rank_band_mean_rowwise)
from repro_torch.kernels.selective_scan import selective_scan as SS
from repro_torch.kernels.selective_scan.ops import scan_states
from repro_torch.kernels.selective_scan.ref import selective_scan_ref
from repro_torch.launch.train import make_prefill_step
from repro_torch.models import api as lm_api
from repro_torch.models import lenet
from repro_torch.utils.tree_math import flat_spec, tree_leaves, tree_map

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
                                 (1, 300), (3, 4097), (5, 1003), (40, 4096)])
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


def _offset(q, offset, device):
    """q's codes on `device`, `offset` bytes past an aligned allocation."""
    flat = torch.empty(q.numel() + offset, dtype=q.dtype, device=device)
    out = flat[offset:].view(q.shape)
    out.copy_(q)
    return out


@pytest.mark.parametrize("int4", [False, True])
@pytest.mark.parametrize("m,n_chunks,chunk,offset", [
    (10, 122, 512, 0), (12, 122, 512, 0), (2, 3, 512, 0), (40, 7, 100, 0),
    (10, 122, 512, 1), (10, 122, 512, 8), (3, 2125, 4096, 0)])
def test_quantized_weighted_sum_kernels_match_plain(cuda, int4, m, n_chunks,
                                                    chunk, offset):
    q, s, w = _wire(m * n_chunks, m, n_chunks, chunk, int4)
    q, s, w = _offset(q, offset, cuda), s.to(cuda), w.to(cuda)
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


def test_rank_band_mean_takes_cohorts_beyond_the_old_row_cap(cuda):
    # the panel path: shared memory does not grow with M
    m, n = 2000, 777
    g = _stack_with_ties(m + n, m, n).to(cuda)
    alive = torch.ones(m)
    alive[::7] = 0.0
    alive = alive.to(cuda)
    m_v = float(alive.sum())
    for lo, hi in ((250.0, m_v - 251.0), (np.floor((m_v - 1) / 2),
                                          np.ceil((m_v - 1) / 2))):
        agg, nrm = R.rank_band_mean(g, alive, lo, hi)
        agg_r, nrm_r = rank_band_mean_ref(g, alive, lo, hi)
        torch.cuda.synchronize()
        _close_scaled(agg, agg_r)
        torch.testing.assert_close(nrm, nrm_r, rtol=1e-4, atol=1e-6)
        assert torch.equal(agg, rank_band_mean_rowwise(g, alive, lo, hi)[0])


@pytest.mark.parametrize("m,n", [(10, 62006), (7, 4097), (32, 1000),
                                 (33, 4099), (256, 777)])
@pytest.mark.parametrize("ranks_on_card", [True, False])
def test_rank_band_mean_kernel_equals_row_order_bitwise(cuda, m, n,
                                                        ranks_on_card):
    g = _stack_with_ties(m * n, m, n).to(cuda)
    alive = torch.ones(m)
    alive[1::5] = 0.0
    alive = alive.to(cuda)
    m_v = float(alive.sum())
    lo = min(1.0, np.floor((m_v - 1) / 2))
    hi = m_v - 1 - lo
    if ranks_on_card:
        lo, hi = (torch.tensor(x, dtype=torch.float32, device=cuda)
                  for x in (lo, hi))
    agg, _ = R.rank_band_mean(g, alive, lo, hi)
    assert torch.equal(agg, rank_band_mean_rowwise(g, alive, lo, hi)[0])


def _device_ops(fn):
    """Names of the device operations one call of `fn` runs, and whether any
    of them copies (torch.profiler's CUDA-side events)."""
    from torch.profiler import ProfilerActivity, profile
    # every library built before any trace: a trace taken after an nvcc
    # subprocess started in between reported no device events on the card
    K._lib(), K._qlib(), R._lib()
    fn()                                      # build, load, first launch
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def _wire_call(case, seed, device):
    """A wire kernel's call on the slice's (10, 122 chunks of 512) wire."""
    int4 = case == "wire-int4"
    q, s, w = (t.to(device) for t in _wire(seed, 10, 122, 512, int4))
    kern = K.ncv_weighted_sum_q4 if int4 else K.ncv_weighted_sum_q
    return (lambda qq: kern(qq, s, w)), q, ("wsum_q4_u8" if int4 else
                                            "wsum_q_i8")


@pytest.mark.parametrize("case", ["wsum", "band-tensors", "band-floats",
                                  "band-panels", "wire-int8", "wire-int4"])
def test_one_call_is_one_kernel_and_no_copy(cuda, case):
    m = 40 if case == "band-panels" else 10
    g = _randn(3, m, 62006).to(cuda)
    alive = torch.ones(m, device=cuda)
    if case == "wsum":
        w = torch.linspace(0.1, 1.0, m).to(cuda)
        fn, name = (lambda: K.ncv_weighted_sum(g, w)), "ncv_weighted_sum"
    elif case.startswith("wire"):
        call, q, name = _wire_call(case, 3, cuda)
        fn = lambda: call(q)                            # noqa: E731
    else:
        lo, hi = 2.0, m - 3.0
        if case != "band-floats":
            lo, hi = (torch.tensor(x, device=cuda) for x in (lo, hi))
        fn, name = (lambda: R.rank_band_mean(g, alive, lo, hi)), "rank_band"
    ops = _device_ops(fn)
    assert len(ops) == 1 and name in ops[0], ops
    assert not any("Memcpy" in o or "Memset" in o for o in ops), ops


@pytest.mark.parametrize("case", ["wsum", "band", "band-panels",
                                  "wire-int8", "wire-int4"])
def test_graph_replays_and_two_streams_are_bitwise_equal(cuda, case):
    if case.startswith("wire"):
        call, q0, _ = _wire_call(case, 10, cuda)
        q1 = _wire_call(case, 11, cuda)[1]
        reduction.check_replays(call, [q0, q1], replays=20)
        return
    m = 40 if case == "band-panels" else 10
    gs = [_randn(10 + i, m, 62006).to(cuda) for i in range(2)]
    w = torch.linspace(0.1, 1.0, m).to(cuda)
    alive = torch.ones(m, device=cuda)
    lo = torch.tensor(2.0, device=cuda)
    hi = torch.tensor(m - 3.0, device=cuda)

    def call(g):
        if case == "wsum":
            return K.ncv_weighted_sum(g, w)
        return R.rank_band_mean(g, alive, lo, hi)

    reduction.check_replays(call, gs, replays=20)


@pytest.mark.parametrize("int4", [False, True])
def test_wire_entries_reject_plans_they_do_not_take(cuda, int4):
    q, s, w = (t.to(cuda) for t in _wire(5, 4, 3, 512, int4))
    fn = K._qlib()["q4" if int4 else "q8"]
    agg = torch.empty(3 * 512, device=cuda)
    nrm = torch.empty((), device=cuda)
    parts = torch.empty(8, device=cuda)
    stream = torch.cuda.current_stream().cuda_stream
    ok = dict(vec=16, blocks=1, slot=0, ptr=q.data_ptr(), chunk=512)
    bad = [dict(vec=3), dict(vec=32), dict(blocks=0), dict(slot=-1),
           dict(slot=reduction.TICKET_SLOTS), dict(ptr=q.data_ptr() + 1),
           dict(chunk=24, vec=16)]
    for change in bad:
        a = dict(ok, **change)
        rc = fn(a["ptr"], s.data_ptr(), w.data_ptr(), agg.data_ptr(),
                parts.data_ptr(), nrm.data_ptr(), 4, 3, a["chunk"], a["vec"],
                a["blocks"], a["slot"], stream)
        assert rc != 0, change
    torch.cuda.synchronize()


def test_rank_band_mean_rejects_ranks_it_cannot_read(cuda):
    g = torch.zeros(4, 100, device=cuda)
    alive = torch.ones(4, device=cuda)
    with pytest.raises(TypeError):
        R.rank_band_mean(g, alive, torch.tensor(1.0, dtype=torch.float64,
                                                device=cuda), 2.0)
    with pytest.raises(TypeError):
        R.rank_band_mean(g, alive, 1.0, torch.ones(2, device=cuda))


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


def _topk_rows(seed, m, n, ties):
    """Rows with (ties) magnitudes from a small set and random signs, or
    (not ties) normals."""
    rng = np.random.default_rng(seed)
    if not ties:
        return torch.from_numpy(rng.standard_normal((m, n)).astype(np.float32))
    vals = rng.choice(np.float32([0.0, 0.5, 1.0, 2.0]), size=(m, n))
    return torch.from_numpy((vals * rng.choice(np.float32([-1.0, 1.0]),
                                               size=(m, n))).astype(np.float32))


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("n,ratio", [(62006, 0.1), (62006, 0.16),
                                     (70000, 0.01), (513, 0.25)])
def test_topk_encode_on_the_card_is_the_cpu_bitwise(cuda, n, ratio, ties):
    """The stable descending sort keeps the lower index first among equal
    magnitudes on the card too: wire, index dtype, residual and decode
    bitwise the CPU's, ties and +-x pairs included."""
    codec = comm.get_codec("topk", n=n, ratio=ratio)
    x, state = _topk_rows(n, 10, n, ties), 0.5 * _topk_rows(n + 1, 10, n,
                                                             ties)
    w_cpu, r_cpu = codec.encode(x, state)
    w_gpu, r_gpu = codec.encode(x.to(cuda), state.to(cuda))
    for k in ("v", "i"):
        assert w_gpu[k].dtype == w_cpu[k].dtype
        assert torch.equal(w_gpu[k].cpu(), w_cpu[k]), k
    assert torch.equal(r_gpu.cpu(), r_cpu)
    assert torch.equal(codec.decode(w_gpu).cpu(), codec.decode(w_cpu))


def test_lowrank_encode_on_the_card_matches_cpu(cuda):
    """LeNet-5's upload at rank 8, two rounds from the starting bases:
    wire, state and decode within rtol 1e-4, atol 1e-5 of the CPU's."""
    params = lenet.init(lenet.LeNetConfig(), torch.Generator().manual_seed(0))
    spec = flat_spec(params, lead=0)
    codec = comm.get_codec("lowrank", n=spec.n, spec=spec, rank=8)
    x = 0.01 * _randn(3, 10, spec.n)
    one = codec.init_state()
    state = tree_map(lambda t: t.expand((10,) + tuple(t.shape)).clone(), one)
    cpu, gpu = state, tree_map(lambda t: t.to(cuda), state)
    for _ in range(2):
        w_cpu, cpu = codec.encode(x, cpu)
        w_gpu, gpu = codec.encode(x.to(cuda), gpu)
        for k in ("u", "v", "d"):
            torch.testing.assert_close(w_gpu[k].cpu(), w_cpu[k], rtol=1e-4,
                                       atol=1e-5)
        for k in ("r", "v"):
            torch.testing.assert_close(gpu[k].cpu(), cpu[k], rtol=1e-4,
                                       atol=1e-5)
        torch.testing.assert_close(codec.decode(w_gpu).cpu(),
                                   codec.decode(w_cpu), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("codec,opts,wsum", [("topk", dict(ratio=0.1), 1),
                                             ("lowrank", dict(rank=8), 0)])
def test_codec_rounds_launch_their_kernels(cuda, codec, opts, wsum):
    """A fedncv round over topk decodes into one `ncv_weighted_sum`;
    lowrank sums its factors and launches none; both run the client's two
    `rloo_combine`; the error feedback is on the card and finite."""
    spec, train, test = federated_splits("cifar10", n_clients=6, alpha=0.1,
                                         seed=0, scale=0.02)
    cfg = lenet.LeNetConfig()
    task = Task(loss=lambda p, b: lenet.loss_fn(cfg, p, b),
                accuracy=lambda p, b: lenet.accuracy(cfg, p, b))
    fl = FLConfig.make(method="fedncv", n_clients=6, cohort=3, k_micro=3,
                       micro_batch=4, server_lr=0.5, local_lr=0.05,
                       local_epochs=2, ncv_alpha0=0.3, ncv_beta=0.0,
                       codec=codec, **opts)
    params = lenet.init(cfg, torch.Generator().manual_seed(0))
    sim = Simulator(task, params, train, fl, seed=0)
    r0, w0 = K.rloo_combine.launches, K.ncv_weighted_sum.launches
    diags = sim.run_rounds(2)
    assert K.rloo_combine.launches - r0 == 4
    assert K.ncv_weighted_sum.launches - w0 == 2 * wsum
    assert np.isfinite(diags["agg_norm"]).all()
    for t in tree_leaves(sim.ef):
        assert t.is_cuda and bool(torch.isfinite(t).all())


@pytest.mark.parametrize("k", [0, 1])
def test_served_tracked_rounds_launch_their_kernels(cuda, k):
    """A served, tracked FedNCV run (beta = 1, track_variance) on the
    card: one row per round, 2 `rloo_combine` + 1 `ncv_weighted_sum` a
    round (the bubble and the drain included), and params and state
    bitwise an untracked run's on the same tables."""
    from repro_torch import serve, track
    spec, train, test = federated_splits("cifar10", n_clients=6, alpha=0.1,
                                         seed=0, scale=0.02)
    cfg = lenet.LeNetConfig()
    task = Task(loss=lambda p, b: lenet.loss_fn(cfg, p, b),
                accuracy=lambda p, b: lenet.accuracy(cfg, p, b))
    params = lenet.init(cfg, torch.Generator().manual_seed(0))

    def coordinator(tracker):
        fl = serve.make_serve_config(
            method="fedncv", n_clients=6, cohort=3, k_micro=3,
            micro_batch=4, server_lr=0.5, local_lr=0.05, local_epochs=2,
            ncv_alpha0=0.3, ncv_beta=1.0, staleness=k,
            track_variance=tracker is not None)
        sim = Simulator(task, params, train, fl, seed=0, tracker=tracker)
        queue = serve.ClientQueue(6, avail="markov", checkin_rate=0.9,
                                  seed=0)
        return serve.Coordinator(sim, queue, policy="fixed", deadline_s=2.0)

    mem = track.MemoryTracker()
    a, b = coordinator(mem), coordinator(None)
    r0, w0 = K.rloo_combine.launches, K.ncv_weighted_sum.launches
    rows = [a.step() for _ in range(3)] + a.drain()
    assert K.rloo_combine.launches - r0 == 2 * (3 + k)
    assert K.ncv_weighted_sum.launches - w0 == 3 + k
    for _ in range(3):
        b.step()
    b.drain()
    assert [r["round"] for r in mem.rows] == list(range(1, 4 + k))
    assert all(r["gvar_proxy"] >= 0.0 for r in mem.rows)
    assert [r["admitted"] for r in mem.rows] == [r["admitted"] for r in rows]
    for x, v in a.sim.params.items():
        assert v.is_cuda and torch.equal(v, b.sim.params[x]), x
    for name, v in a.sim._get_state().items():
        for p, q in zip(tree_leaves(v), tree_leaves(b.sim._get_state()[name])):
            assert torch.equal(p, q), name


@pytest.mark.parametrize("method", ["fedprox", "scaffold", "fedncv+",
                                    "fedper", "fedrep", "pfedsim",
                                    "fedglomo"])
def test_method_rounds_launch_their_kernel_and_match_cpu(cuda, method):
    """Two rounds of each of the other methods: one `ncv_weighted_sum` a
    round (none for fedncv+, whose server reduces the dense uploads
    itself), no `rloo_combine`; params and state within the CPU run's
    tolerance."""
    spec, train, test = federated_splits("cifar10", n_clients=6, alpha=0.1,
                                         seed=0, scale=0.02)
    cfg = lenet.LeNetConfig()
    task = Task(loss=lambda p, b: lenet.loss_fn(cfg, p, b),
                accuracy=lambda p, b: lenet.accuracy(cfg, p, b),
                head_keys=lenet.HEAD_KEYS)
    fl = FLConfig.make(method=method, n_clients=6, cohort=3, k_micro=3,
                       micro_batch=4, server_lr=0.5, local_lr=0.05,
                       local_epochs=2)
    params = lenet.init(cfg, torch.Generator().manual_seed(0))
    sim = Simulator(task, params, train, fl, seed=0)
    draws = [sim._draw_cohort_sel() for _ in range(2)]
    r0, w0 = K.rloo_combine.launches, K.ncv_weighted_sum.launches
    diags = sim.run_rounds(2, draws=draws)
    assert K.ncv_weighted_sum.launches - w0 == (0 if method == "fedncv+"
                                                else 2)
    assert K.rloo_combine.launches == r0
    cpu = Simulator(task, params, train, fl, seed=0, device="cpu")
    cdiags = cpu.run_rounds(2, draws=draws)
    for k, v in sim.params.items():
        torch.testing.assert_close(v.cpu(), cpu.params[k], rtol=1e-4,
                                   atol=1e-5)
    for name, tree in sim._state.items():
        tree_map(lambda a, b: torch.testing.assert_close(
            a.cpu(), b, rtol=1e-4, atol=1e-5), tree, cpu._state[name])
    np.testing.assert_array_equal(diags["bytes_up"], cdiags["bytes_up"])
    assert np.isfinite(sim.evaluate(test, personalize_steps=3))


# the samplers and fault models: (options, the server kernel); the first
# ceil(0.2 x 6) = 2 client ids are byzantine
_FAULT_PATHS = {
    "importance": (dict(sampler="importance"), "wsum"),
    "similarity": (dict(sampler="similarity"), "wsum"),
    "dropout": (dict(fault="dropout", drop_rate=0.4, drop_skew=0.5), "wsum"),
    "straggler": (dict(fault="straggler"), "wsum"),
    "markov": (dict(fault="markov", mk_fail=0.3), "wsum"),
    "byzantine-mean": (dict(fault="byzantine"), "wsum"),
    "byzantine-trimmed_mean": (dict(fault="byzantine",
                                    aggregator="trimmed_mean",
                                    trim_frac=0.25), "band"),
    "byzantine-median": (dict(fault="byzantine", aggregator="median"),
                         "band"),
    "signflip-norm_clip": (dict(fault="byzantine", byz_attack="signflip",
                                aggregator="norm_clip"), "wsum"),
    "labelflip-int8": (dict(fault="byzantine", byz_attack="labelflip",
                            codec="int8"), "q8"),
    "dropout+importance": (dict(sampler="importance", fault="dropout",
                                drop_rate=0.4), "wsum"),
    "external": (dict(sampler="external", ext_cohort=4, fault="external",
                      ext_slots=4), "wsum"),
}


def _external_tables(r):
    """Round r's host-written tables; in round 1 every slot is dead."""
    alive = torch.tensor([1.0, 0.0, 1.0, 1.0]) if r == 0 else torch.zeros(4)
    return (dict(idx=torch.tensor([4, 0, 2, 5], dtype=torch.int32),
                 invp=torch.tensor([1.5, 0.5, 1.0, 0.8])),
            dict(alive=alive, invp=alive / 0.7))


@pytest.mark.parametrize("case", list(_FAULT_PATHS))
def test_sampler_and_fault_rounds_launch_their_kernels(cuda, case):
    """Two rounds of each sampler and fault path: two `rloo_combine` and
    one server kernel a round, no other; params finite; over the identity
    wire, params and every state field (sampler and fault state among
    them) within the CPU run's tolerance on the card's draws and plans."""
    kw, kernel = _FAULT_PATHS[case]
    spec, train, test = federated_splits("cifar10", n_clients=6, alpha=0.1,
                                         seed=0, scale=0.02)
    cfg = lenet.LeNetConfig()
    task = Task(loss=lambda p, b: lenet.loss_fn(cfg, p, b),
                accuracy=lambda p, b: lenet.accuracy(cfg, p, b))
    fl = FLConfig.make(method="fedncv", n_clients=6, cohort=4, k_micro=3,
                       micro_batch=4, server_lr=0.5, local_lr=0.05,
                       local_epochs=2, ncv_alpha0=0.3, ncv_beta=0.0, **kw)
    params = lenet.init(cfg, torch.Generator().manual_seed(0))
    sims = [Simulator(task, params, train, fl, seed=0),
            Simulator(task, params, train, fl, seed=0, device="cpu")]
    fns = dict(rloo=K.rloo_combine, q8=K.ncv_weighted_sum_q,
               q4=K.ncv_weighted_sum_q4, wsum=K.ncv_weighted_sum,
               band=R.rank_band_mean)
    before = {n: f.launches for n, f in fns.items()}
    draws = []
    for r in range(2):
        if case == "external":
            for s in sims:
                s.sampler, s.faults = _external_tables(r)
        draws.append(sims[0].draw_round())
        sims[0].run_round(draws=draws[-1])
    launches = {n: f.launches - before[n] for n, f in fns.items()}
    assert launches == dict({n: 0 for n in fns}, rloo=4, **{kernel: 2})
    assert all(bool(torch.isfinite(v).all())
               for v in sims[0].params.values())
    if fl.codec != "identity":
        return
    for d in draws:
        sims[1].run_round(draws=d)
    for k, v in sims[0].params.items():
        torch.testing.assert_close(v.cpu(), sims[1].params[k], rtol=1e-4,
                                   atol=1e-5)
    for name, tree in sims[0]._state.items():
        tree_map(lambda a, b: torch.testing.assert_close(
            a.cpu(), b, rtol=1e-4, atol=1e-5), tree, sims[1]._state[name])


# ----------------------------- LM slice: flash attention, selective scan ----

def _qkv(seed, b, s, h, kv, hd, dtype):
    rng = np.random.default_rng(seed)
    mk = lambda n: torch.from_numpy(  # noqa: E731
        rng.standard_normal((b, s, n, hd)).astype(np.float32)).to(dtype)
    return mk(h), mk(kv), mk(kv)


# (rtol, atol) f32: the reference kernel tests' 2e-4; bf16: both compute in
# f32 and round to bf16 once, so they differ by at most one bf16 step, at
# most 2^-7 of the value
_FLASH_TOL = {torch.float32: (2e-4, 2e-4), torch.bfloat16: (1e-2, 1e-3)}


def _flash_case(cuda, seed, b, s, h, kv, hd, dtype, **kw):
    q, k, v = (t.to(cuda) for t in _qkv(seed, b, s, h, kv, hd, dtype))
    before = FA.flash_attention.launches
    got = FA.flash_attention(q, k, v, **kw)
    want = flash_attention_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    assert FA.flash_attention.launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    rtol, atol = _FLASH_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=atol)
    # no float atomics, no split over keys: bitwise the same on a repeat
    assert torch.equal(got, FA.flash_attention(q, k, v, **kw))
    return q, k, v, got


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", list(range(8, 257, 8)))
def test_flash_kernel_matches_plain_every_head_dim(cuda, hd, dtype):
    _flash_case(cuda, hd, 1, 130, 4, 2, hd, dtype, causal=True)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,kv,hd,causal,window,softcap", [
    (2, 256, 4, 2, 128, True, None, None),
    (1, 1000, 8, 2, 64, True, None, None),       # ragged S
    (2, 24, 4, 2, 32, True, 16, None),           # the decode-test length
    (1, 1, 2, 1, 16, True, None, None),
    (1, 300, 4, 4, 96, False, None, None),       # phi3's hd, not causal
    (1, 700, 2, 1, 256, True, 200, 50.0),        # gemma2: window + softcap
    (1, 333, 6, 3, 64, False, 50, 30.0),         # window without causal
])
def test_flash_kernel_matches_plain_masks(cuda, b, s, h, kv, hd, causal,
                                          window, softcap, dtype):
    _flash_case(cuda, s + hd, b, s, h, kv, hd, dtype, causal=causal,
                window=window, softcap=softcap)


# the bf16 tensor-core kernel (wgmma, TMA maps over (hd, heads, S, B)):
# GQA r = 1..4, tiles of 128 query rows and 64 or 128 keys crossed by S
# below one tile, ragged S and B > 1 (the batch edge of the maps), every
# padded head width (hd 8 and 96 zero-filled to a 64-column panel, 192 and
# 256 on 64-key tiles), and each mask
@pytest.mark.parametrize("b,s,h,kv,hd,causal,window,softcap", [
    (1, 1, 4, 1, 128, True, None, None),         # S = 1, r = 4
    (2, 24, 6, 2, 64, True, None, None),         # S below a tile, r = 3
    (3, 130, 4, 4, 96, True, None, None),        # r = 1, phi3's hd, B = 3
    (2, 1000, 8, 4, 128, True, None, None),      # ragged S, r = 2
    (2, 1000, 8, 2, 256, False, None, None),     # not causal, hd 256, r = 4
    (1, 257, 4, 2, 192, True, None, None),       # hd 192 (64-key tiles)
    (2, 777, 4, 2, 128, True, 100, None),        # window
    (2, 300, 4, 1, 64, False, None, 30.0),       # softcap, not causal
    (2, 700, 4, 2, 256, True, 200, 50.0),        # gemma2: window + softcap
    (1, 333, 6, 3, 8, False, 50, 30.0),          # window without causal
    (1, 2048, 8, 8, 128, True, 512, None),       # window over many tiles
])
def test_flash_bf16_kernel_cases(cuda, b, s, h, kv, hd, causal, window,
                                 softcap):
    _flash_case(cuda, 3 * s + hd, b, s, h, kv, hd, torch.bfloat16,
                causal=causal, window=window, softcap=softcap)


def test_flash_bf16_wrapper_rejects_unaligned_tensors(cuda):
    q, k, v = (t.to(cuda) for t in _qkv(0, 1, 64, 4, 2, 64, torch.bfloat16))
    flat = torch.zeros(q.numel() + 1, dtype=torch.bfloat16, device=cuda)
    shifted = flat[1:].view(q.shape)      # contiguous, 2 bytes off
    with pytest.raises(ValueError, match="16-byte"):
        FA.flash_attention(shifted, k, v)


def test_flash_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    q, k, v = (t.to(cuda) for t in _qkv(0, 1, 64, 4, 2, 64, torch.float32))
    with pytest.raises(ValueError, match="hd"):
        FA.flash_attention(q[..., :12].contiguous(), k[..., :12].contiguous(),
                           v[..., :12].contiguous())
    big = torch.zeros(1, 8, 2, 264, device=cuda)
    with pytest.raises(ValueError, match="hd"):
        FA.flash_attention(big, big, big)
    with pytest.raises(TypeError):
        FA.flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(TypeError):
        FA.flash_attention(q, k.bfloat16(), v)
    with pytest.raises(ValueError, match="contiguous"):
        FA.flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2),
                           k, v)
    with pytest.raises(ValueError):
        FA.flash_attention(q, k.cpu(), v)
    with pytest.raises(ValueError):
        FA.flash_attention(q, k[:, :, :1].expand(1, 64, 3, 64).contiguous(),
                           v[:, :, :1].expand(1, 64, 3, 64).contiguous())


def _scan_inputs(seed, shape):
    rng = np.random.default_rng(seed)
    # a in (0, 1) like exp(dt * A) with A < 0
    a = 1.0 / (1.0 + np.exp(-rng.standard_normal(shape)))
    b = rng.standard_normal(shape)
    return (torch.from_numpy(a.astype(np.float32)),
            torch.from_numpy(b.astype(np.float32)))


@pytest.mark.parametrize("shape", [(128, 64), (256, 256), (512, 100),
                                   (1024, 32), (3, 1000, 77), (2, 17, 4099),
                                   (1, 1, 5), (4, 2048, 512)])
def test_scan_kernel_matches_plain(cuda, shape):
    a, b = (t.to(cuda) for t in _scan_inputs(sum(shape), shape))
    before = SS.selective_scan.launches
    h = SS.selective_scan(a, b)
    hr = selective_scan_ref(a, b)
    torch.cuda.synchronize()
    assert SS.selective_scan.launches == before + 1
    # sequential FMAs vs the doubling scan: the reference tests' 2e-4
    torch.testing.assert_close(h, hr, rtol=2e-4, atol=2e-4)
    assert torch.equal(h, SS.selective_scan(a, b))


def test_scan_kernel_takes_bf16_and_broadcast_states(cuda):
    a, b = (t.to(cuda) for t in _scan_inputs(3, (2, 64, 16, 8)))
    h = scan_states(a[:, :, :, :1], b.bfloat16())
    hr = selective_scan_ref(a[:, :, :, :1].expand(b.shape).reshape(2, 64, -1),
                            b.bfloat16().reshape(2, 64, -1))
    assert h.dtype == torch.float32 and h.shape == b.shape
    torch.testing.assert_close(h.reshape(2, 64, -1), hr, rtol=2e-4,
                               atol=2e-4)


def test_scan_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    a, b = (t.to(cuda) for t in _scan_inputs(0, (64, 32)))
    with pytest.raises(ValueError, match="contiguous"):
        SS.selective_scan(a.t().contiguous().t(), b)
    with pytest.raises(ValueError):
        SS.selective_scan(a, b.cpu())
    with pytest.raises(ValueError):
        SS.selective_scan(a, b[:, :16].contiguous())
    with pytest.raises(TypeError):
        SS.selective_scan(a.int(), b)


@pytest.mark.parametrize("arch,kernel", [("llama3.2-3b", "flash"),
                                         ("gemma2-9b", "flash"),
                                         ("falcon-mamba-7b", "scan")])
def test_reduced_prefill_launches_its_kernel(cuda, arch, kernel):
    cfg = configs.get(arch).reduced().replace(dtype="float32")
    params = lm_api.init_params(cfg, 0, device="cpu")
    batch = lm_api.make_batch(cfg, torch.Generator().manual_seed(1), 2, 40,
                              device="cpu")
    want = make_prefill_step(cfg)(params, batch)
    fn = dict(flash=FA.flash_attention, scan=SS.selective_scan)[kernel]
    p_cuda = tree_map(lambda x: x.to(cuda), params)
    b_cuda = {k: v.to(cuda) for k, v in batch.items()}
    before = fn.launches
    got = make_prefill_step(cfg)(p_cuda, b_cuda)
    torch.cuda.synchronize()
    assert fn.launches - before == cfg.n_layers
    # f32 matmuls and sums in other orders on the card
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)


# ------------------------------- the moe family -------------------------------

def _moe_case(top_k, e, t, dtype):
    from repro_torch.configs.base import ArchConfig
    cfg = ArchConfig(name="m", family="moe", n_layers=1, d_model=256,
                     n_heads=2, n_kv_heads=1, d_ff=64, vocab=64, n_experts=e,
                     top_k=top_k, d_ff_expert=128,
                     dtype=str(dtype).split(".")[-1])
    p = dict(router=_randn(1, 256, e) / 16, w_gate=_randn(2, e, 256, 128) / 16,
             w_up=_randn(3, e, 256, 128) / 16,
             w_down=_randn(4, e, 128, 256) / 128 ** 0.5)
    return cfg, {n: a.to(dtype) for n, a in p.items()}, _randn(5, t, 256).to(
        dtype)


@pytest.mark.parametrize("top_k,e,t,dtype", [
    (1, 16, 2048, torch.float32),     # llama4's routing, two groups
    (8, 64, 2048, torch.float32),     # kimi's top-8
    (8, 64, 8, torch.float32),        # one decode step: cap 8
    (1, 16, 1024, torch.bfloat16),    # bf16 products with f32 results
])
def test_moe_ffn_on_the_card_matches_cpu(cuda, top_k, e, t, dtype):
    """The routing (experts, slots, drops) is the CPU's bitwise, the gates
    too at top-1 (exactly 1); the output is within f32 sums in another
    order (bf16: one rounding of h and of y)."""
    from repro_torch.models import moe
    cfg, p, x = _moe_case(top_k, e, t, dtype)
    pc = {n: a.to(cuda) for n, a in p.items()}
    y, aux = moe.moe_ffn(cfg, p, x)
    yc, auxc = moe.moe_ffn(cfg, pc, x.to(cuda))
    group = min(moe.MOE_GROUP, t)
    cap = moe._capacity(cfg, group)
    r = moe.route(cfg, p["router"], x.reshape(-1, group, 256), cap)
    rc = moe.route(cfg, pc["router"], x.to(cuda).reshape(-1, group, 256),
                   cap)
    for key in ("idx", "pos", "keep"):
        assert torch.equal(rc[key].cpu(), r[key]), key
    if top_k == 1:
        assert torch.equal(rc["gates"].cpu(), r["gates"])
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    torch.testing.assert_close(yc.cpu(), y, rtol=tol, atol=tol)
    torch.testing.assert_close(auxc.cpu(), aux, rtol=1e-5, atol=0.0)
    # deterministic: no float atomics in dispatch or combine
    assert torch.equal(moe.moe_ffn(cfg, pc, x.to(cuda))[0], yc)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,chunk,hd", [
    (2, 512, 128, 64),      # whole chunks: one folded call
    (2, 300, 128, 64),      # B > 1 with a tail: two calls
    (1, 300, 128, 112),     # B = 1: the tail a view; kimi's hd
    (1, 100, 128, 128),     # S < chunk: one plain call
])
def test_chunked_flash_matches_masked_plain(cuda, dtype, b, s, chunk, hd):
    from repro_torch.models import layers as TL
    q, k, v = (t.to(cuda) for t in _qkv(s + hd, b, s, 4, 2, hd, dtype))
    before = FA.flash_attention.launches
    got = TL.chunked_flash_attention(q, k, v, chunk)
    n, r = divmod(s, chunk)
    assert FA.flash_attention.launches - before == (
        1 if n == 0 or r == 0 else 2)
    mask = TL._make_mask(s, s, causal=True, chunk=chunk, device=cuda)
    want = TL.attend(q.float(), k.float(), v.float(), mask).to(dtype)
    rtol, atol = (2e-4, 2e-4) if dtype == torch.float32 else (1e-2, 1e-3)
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=atol)


# ------------------------------ the hybrid family ----------------------------

@pytest.mark.parametrize("shape", [(2, 64, 8, 16, 16), (1, 300, 4, 8, 64)])
def test_scan_states_mamba2_layout_matches_plain(cuda, shape):
    """The (B, S, H, N, P) state with one a per (step, head), broadcast
    over (N, P) as `ssm.mamba2_block` passes it: one launch."""
    a, b = _scan_inputs(sum(shape), shape)
    a = a[..., :1, :1].to(cuda)
    b = b.to(cuda)
    before = SS.selective_scan.launches
    h = scan_states(a, b)
    torch.cuda.synchronize()
    assert SS.selective_scan.launches == before + 1
    assert h.shape == b.shape and h.dtype == torch.float32
    bsz, s = shape[:2]
    hr = selective_scan_ref(a.expand(shape).reshape(bsz, s, -1),
                            b.reshape(bsz, s, -1))
    torch.testing.assert_close(h.reshape(bsz, s, -1), hr, rtol=2e-4,
                               atol=2e-4)


def test_reduced_hybrid_on_the_card_matches_cpu(cuda):
    """Reduced zamba2 at 6 layers (4 Mamba-2 blocks, 2 applications of the
    shared block), f32: the prefill launches 4 scans and 2 flash calls and
    matches the CPU's; 16 teacher-forced decode steps launch nothing and
    match the CPU's step by step, caches included."""
    from repro_torch.launch.train import make_serve_step
    cfg = configs.get("zamba2-7b").reduced().replace(dtype="float32",
                                                     n_layers=6)
    params = lm_api.init_params(cfg, 0, device="cpu")
    batch = lm_api.make_batch(cfg, torch.Generator().manual_seed(1), 2, 40,
                              device="cpu")
    want = make_prefill_step(cfg)(params, batch)
    p_cuda = tree_map(lambda x: x.to(cuda), params)
    b_cuda = {k: v.to(cuda) for k, v in batch.items()}
    before = (SS.selective_scan.launches, FA.flash_attention.launches)
    got = make_prefill_step(cfg)(p_cuda, b_cuda)
    torch.cuda.synchronize()
    assert (SS.selective_scan.launches - before[0],
            FA.flash_attention.launches - before[1]) == (4, 2)
    # f32 matmuls and sums in other orders on the card
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    step = make_serve_step(cfg)
    cache = lm_api.init_cache(cfg, 2, 16, device="cpu")
    cache_c = lm_api.init_cache(cfg, 2, 16, device=cuda)
    before = (SS.selective_scan.launches, FA.flash_attention.launches)
    for i in range(16):
        lg, cache = step(params, cache, batch["tokens"][:, i:i + 1], i)
        lg_c, cache_c = step(p_cuda, cache_c, b_cuda["tokens"][:, i:i + 1], i)
        torch.testing.assert_close(lg_c.cpu(), lg, rtol=1e-4, atol=1e-4)
    assert (SS.selective_scan.launches,
            FA.flash_attention.launches) == before
    for got_c, want_c in zip(tree_leaves(cache_c), tree_leaves(cache)):
        torch.testing.assert_close(got_c.cpu(), want_c, rtol=1e-4, atol=1e-4)


# ------------------------------ the encdec family ----------------------------

# (b, s, s_kv, h, kv, hd, causal, window): k and v of their own length S_kv
# below, equal to and above S, ragged (whisper's 1,500 = 11 * 128 + 92),
# GQA, every mask; where S > S_kv a window leaves the rows qi >= S_kv +
# window - 1 no key (their mean over all S_kv values, as the plain
# version's -1e30 mask gives)
_SKV_CASES = [
    (2, 448, 1500, 4, 4, 64, False, None),       # whisper's cross, cut heads
    (2, 96, 128, 4, 2, 64, False, None),
    (1, 300, 1000, 8, 2, 128, True, None),
    (1, 1000, 300, 8, 2, 128, True, None),       # S > S_kv, causal
    (2, 256, 256, 4, 2, 64, False, None),        # S_kv = S
    (2, 257, 40, 4, 1, 64, True, 8),             # rows 47.. keep no key
    (1, 300, 77, 4, 2, 96, False, 16),           # rows 92.., no causal
    (1, 130, 700, 6, 3, 256, True, 64),
    (3, 1, 333, 4, 2, 32, False, None),          # one query
    (1, 700, 1, 4, 2, 64, True, 50),             # one key; rows 50.. none
    # the vlm's cross-attention, cut heads: GQA r 4, S_kv = 1,601 = 25 * 64
    # + 1 = 12 * 128 + 65, so the last key tile holds one key of 64
    (2, 320, 1601, 8, 2, 128, False, None),
]


def _flash_skv_case(cuda, seed, b, s, s_kv, h, kv, hd, dtype, **kw):
    rng = np.random.default_rng(seed)
    mk = lambda n, length: torch.from_numpy(  # noqa: E731
        rng.standard_normal((b, length, n, hd)).astype(np.float32)).to(
            dtype).to(cuda)
    q, k, v = mk(h, s), mk(kv, s_kv), mk(kv, s_kv)
    before = FA.flash_attention.launches
    got = FA.flash_attention(q, k, v, **kw)
    want = flash_attention_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    assert FA.flash_attention.launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    rtol, atol = _FLASH_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=atol)
    assert torch.equal(got, FA.flash_attention(q, k, v, **kw))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,s_kv,h,kv,hd,causal,window", _SKV_CASES)
def test_flash_kernel_takes_its_own_key_length(cuda, b, s, s_kv, h, kv, hd,
                                               causal, window, dtype):
    _flash_skv_case(cuda, s + 3 * s_kv + hd, b, s, s_kv, h, kv, hd, dtype,
                    causal=causal, window=window)


def test_flash_wrapper_refuses_other_batch_or_head_width(cuda):
    q, k, v = (t.to(cuda) for t in _qkv(0, 2, 64, 4, 2, 64, torch.float32))
    for bad in (k[:1].contiguous(), k[..., :32].contiguous()):
        with pytest.raises(ValueError, match="do not match"):
            FA.flash_attention(q, bad, bad)


def test_reduced_encdec_on_the_card_matches_cpu(cuda):
    """Reduced whisper (2 encoder, 2 decoder layers), f32: the prefill
    launches L_enc + 2 L_dec = 6 flash calls (encoder, decoder self- and
    cross-attention) and matches the CPU's; the serve loop's cache (the
    encoder's 2 launches) and 16 teacher-forced decode steps (no launch)
    match the CPU's step by step, caches included."""
    from repro_torch.launch.serve import prepare_cache
    from repro_torch.launch.train import make_serve_step
    cfg = configs.get("whisper-medium").reduced().replace(dtype="float32")
    params = lm_api.init_params(cfg, 0, device="cpu")
    batch = lm_api.make_batch(cfg, torch.Generator().manual_seed(1), 2, 40,
                              device="cpu")
    want = make_prefill_step(cfg)(params, batch)
    p_cuda = tree_map(lambda x: x.to(cuda), params)
    b_cuda = {k: v.to(cuda) for k, v in batch.items()}
    before = FA.flash_attention.launches
    got = make_prefill_step(cfg)(p_cuda, b_cuda)
    torch.cuda.synchronize()
    assert FA.flash_attention.launches - before == \
        cfg.n_enc_layers + 2 * cfg.n_layers
    # f32 matmuls and sums in other orders on the card
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    step = make_serve_step(cfg)
    cache = prepare_cache(cfg, params, 2, 16, "cpu", batch["frames"])
    before = FA.flash_attention.launches
    cache_c = prepare_cache(cfg, p_cuda, 2, 16, cuda, b_cuda["frames"])
    assert FA.flash_attention.launches - before == cfg.n_enc_layers
    before = FA.flash_attention.launches
    for i in range(16):
        lg, cache = step(params, cache, batch["tokens"][:, i:i + 1], i)
        lg_c, cache_c = step(p_cuda, cache_c, b_cuda["tokens"][:, i:i + 1], i)
        torch.testing.assert_close(lg_c.cpu(), lg, rtol=1e-4, atol=1e-4)
    assert FA.flash_attention.launches == before
    for got_c, want_c in zip(tree_leaves(cache_c), tree_leaves(cache)):
        torch.testing.assert_close(got_c.cpu(), want_c, rtol=1e-4, atol=1e-4)


# -------------------------------- the vlm family -----------------------------

def test_reduced_vlm_on_the_card_matches_cpu(cuda):
    """Reduced llama-3.2-vision (2 groups of a self and a gated cross layer,
    nonzero gates), f32: the prefill launches 4 flash calls (2 causal, 2
    cross onto the image tokens) and matches the CPU's; `prepare_cache`
    (no launch) and 16 teacher-forced decode steps (no launch) match the
    CPU's step by step, caches included."""
    from repro_torch.launch.serve import prepare_cache
    from repro_torch.launch.train import make_serve_step
    cfg = configs.get("llama-3.2-vision-11b").reduced().replace(
        n_layers=4, dtype="float32")
    params = lm_api.init_params(cfg, 0, device="cpu")
    gates = torch.Generator().manual_seed(2)
    for n in ("attn_gate", "ffn_gate"):
        params["cross_layers"][n] = torch.rand(2, generator=gates) * 2 - 1
    batch = lm_api.make_batch(cfg, torch.Generator().manual_seed(1), 2, 40,
                              device="cpu")
    want = make_prefill_step(cfg)(params, batch)
    p_cuda = tree_map(lambda x: x.to(cuda), params)
    b_cuda = {k: v.to(cuda) for k, v in batch.items()}
    before = FA.flash_attention.launches
    got = make_prefill_step(cfg)(p_cuda, b_cuda)
    torch.cuda.synchronize()
    assert FA.flash_attention.launches - before == cfg.n_layers
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    step = make_serve_step(cfg)
    cache = prepare_cache(cfg, params, 2, 16, "cpu",
                          image_embeds=batch["image_embeds"])
    before = FA.flash_attention.launches
    cache_c = prepare_cache(cfg, p_cuda, 2, 16, cuda,
                            image_embeds=b_cuda["image_embeds"])
    for i in range(16):
        lg, cache = step(params, cache, batch["tokens"][:, i:i + 1], i)
        lg_c, cache_c = step(p_cuda, cache_c, b_cuda["tokens"][:, i:i + 1], i)
        torch.testing.assert_close(lg_c.cpu(), lg, rtol=1e-4, atol=1e-4)
    assert FA.flash_attention.launches == before
    for got_c, want_c in zip(tree_leaves(cache_c), tree_leaves(cache)):
        torch.testing.assert_close(got_c.cpu(), want_c, rtol=1e-4, atol=1e-4)
