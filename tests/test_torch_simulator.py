"""The port's simulator against the reference's on the CPU, small size.

The port replays the reference's draws through its draw-injection seam:
for 0-based round i the reference draws with
`key = fold_in(PRNGKey(seed), i)`, `kd, kk = split(key)` and
`_draw_cohort_sel(state, kd)`; fedavg and fedncv draw nothing else, and
the int8 / int4 wire draws its rounding uniforms from `kk` per cohort
slot (`reference_draws`).

Tolerances and why:
  params  rtol 1e-4 / atol 1e-5 — three rounds of training compound the
          f32 summation-order differences of XLA's and PyTorch's CPU
          convolutions (about 1e-7 per step);
  alphas  rtol 1e-5 — one scalar update per round from S1;
  agg_norm rtol 1e-4 — a sum of 62,006 squares of the above;
  bytes_up equal — pure accounting;
  wire codes — equal up to rare single steps, round by round (see
          `test_quantized_rounds_match_reference`);
  evaluate within 1e-2 absolute — an argmax may flip on a near tie.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import federated_splits as j_splits
from repro.fed import FLConfig as JFLConfig, Simulator as JSimulator
from repro.fed import Task as JTask
from repro.models import lenet as jlenet
from repro_torch.data import federated_splits as t_splits
from repro_torch.fed import FLConfig, Simulator, Task
from repro_torch.kernels.rloo.ref import unpack_int4_ref
from repro_torch.models import lenet as tlenet
from repro_torch.weights import params_from_jax

SEED, ROUNDS = 0, 3
COMMON = dict(n_clients=6, cohort=3, k_micro=3, micro_batch=4, server_lr=0.5,
              local_lr=0.05)


@pytest.fixture(scope="module")
def world():
    spec, train, test = j_splits("cifar10", n_clients=6, alpha=0.1,
                                 seed=SEED, scale=0.02)
    _, ttrain, ttest = t_splits("cifar10", n_clients=6, alpha=0.1,
                                seed=SEED, scale=0.02)
    jcfg, tcfg = jlenet.LeNetConfig(), tlenet.LeNetConfig()
    jtask = JTask(loss=lambda p, b: jlenet.loss_fn(jcfg, p, b),
                  accuracy=lambda p, b: jlenet.accuracy(jcfg, p, b),
                  head_keys=jlenet.HEAD_KEYS)
    ttask = Task(loss=lambda p, b: tlenet.loss_fn(tcfg, p, b),
                 accuracy=lambda p, b: tlenet.accuracy(tcfg, p, b),
                 head_keys=tlenet.HEAD_KEYS)
    jp = jlenet.init(jcfg, jax.random.PRNGKey(SEED))
    return dict(train=train, test=test, ttrain=ttrain, ttest=ttest,
                jtask=jtask, ttask=ttask, jp=jp,
                tp=params_from_jax(jax.tree.map(np.asarray, jp)))


def _toy(world, method="fedncv", **kw):
    fl = FLConfig.make(method=method, **COMMON, **kw)
    return Simulator(world["ttask"], world["tp"], world["ttrain"], fl,
                     seed=SEED, device="cpu")


CASES = {
    "fedavg": ("fedavg", dict(local_epochs=2)),
    "fedavg-1epoch": ("fedavg", dict(local_epochs=1)),
    "fedncv": ("fedncv", dict(local_epochs=2, ncv_alpha0=0.3,
                              ncv_alpha_lr=1e-2, ncv_beta=0.0)),
    "fedncv-lit": ("fedncv", dict(local_epochs=2, ncv_alpha0=0.3,
                                  ncv_alpha_lr=1e-2, ncv_beta=1.0)),
    "fedncv-1epoch-optimal": ("fedncv", dict(local_epochs=1, ncv_alpha0=0.5,
                                             ncv_beta=1.0,
                                             ncv_alpha_mode="optimal")),
}


@pytest.mark.parametrize("case", list(CASES))
def test_rounds_match_reference_with_replayed_draws(world, case):
    method, kw = CASES[case]
    jfl = JFLConfig.make(method=method, **COMMON, **kw)
    jsim = JSimulator(world["jtask"], world["jp"], world["train"], jfl,
                      seed=SEED)
    tsim = Simulator(world["ttask"], world["tp"], world["ttrain"],
                     FLConfig.make(method=method, **COMMON, **kw),
                     seed=SEED, device="cpu")
    draws, jdiags = [], []
    for i in range(ROUNDS):
        key = jax.random.fold_in(jax.random.PRNGKey(SEED), i)
        kd, _ = jax.random.split(key)
        idx, sel, *_ = jsim._draw_cohort_sel(jsim._get_state(), kd)
        draws.append((np.asarray(idx), np.asarray(sel)))
        jdiags.append(jsim.run_round())
    tdiags = tsim.run_rounds(ROUNDS, draws=draws)
    for k, v in jsim.params.items():
        np.testing.assert_allclose(tsim.params[k].numpy(), np.asarray(v),
                                   rtol=1e-4, atol=1e-5, err_msg=k)
    if method == "fedncv":
        np.testing.assert_allclose(tsim.alphas.numpy(),
                                   np.asarray(jsim.alphas), rtol=1e-5)
    np.testing.assert_allclose(tdiags["agg_norm"],
                               [d["agg_norm"] for d in jdiags], rtol=1e-4)
    np.testing.assert_array_equal(tdiags["bytes_up"],
                                  np.float32([d["bytes_up"] for d in jdiags]))
    for steps in (0, 3):
        assert abs(tsim.evaluate(world["ttest"], personalize_steps=steps)
                   - jsim.evaluate(world["test"], personalize_steps=steps)) \
            <= 1e-2


def test_bytes_up_is_the_reference_accounting(world):
    sim = _toy(world, local_epochs=2, ncv_beta=0.0)
    diag = sim.run_round()
    # identity wire: cohort * (4 N + FedNCV's 4 f32 scalars)
    assert diag["bytes_up"] == 3 * (4 * 62006 + 16)


def test_run_round_and_run_rounds_agree_bitwise(world):
    a = _toy(world, local_epochs=2, ncv_beta=1.0)
    b = _toy(world, local_epochs=2, ncv_beta=1.0)
    draws = [a._draw_cohort_sel() for _ in range(2)]
    rows = [a.run_round(draws=d) for d in draws]
    stacked = b.run_rounds(2, draws=draws)
    for k in a.params:
        assert torch.equal(a.params[k], b.params[k])
    assert [r["agg_norm"] for r in rows] == list(
        stacked["agg_norm"].astype(float))


def test_own_draws_are_valid_and_seeded(world):
    a, b = _toy(world), _toy(world)
    train = world["ttrain"]
    for _ in range(3):
        (ia, sa), (ib, sb) = a._draw_cohort_sel(), b._draw_cohort_sel()
        assert torch.equal(ia, ib) and torch.equal(sa, sb)
        assert len(set(ia.tolist())) == 3 and sa.shape == (3, 3, 4)
        for u, rows in zip(ia.tolist(), sa):
            shard = set(train["client_idx"][u][:train["client_sizes"][u]])
            assert set(rows.flatten().tolist()) <= shard
    a.run_rounds(2)
    assert a.round_idx == 2 and np.isfinite(a.evaluate(world["ttest"]))


@pytest.mark.parametrize("kw,err", [
    (dict(method="fedbogus"), KeyError),
    (dict(method="fedncv", prox_mu=0.1), TypeError),
    (dict(method="fedavg", ncv_beta=0.0), TypeError),
    (dict(method="fedncv", ncv_alpha0=1.5), ValueError),
    (dict(method="fedncv", ncv_alpha0=-0.1), ValueError),
    (dict(method="fedncv", ncv_alpha_mode="greedy"), ValueError),
    (dict(method="fedncv", cohort=1, ncv_beta=1.0), ValueError),
    (dict(method="fedncv", codec="nope"), KeyError),
    (dict(method="fedncv", codec="int8", codec_opts=dict(ratio=0.1)),
     TypeError),
    (dict(method="fedncv", aggregator="median", ncv_beta=1.0), ValueError),
    (dict(method="fedncv", aggregator="trimmed_mean", ncv_beta=0.0,
          agg_opts=dict(trim_frac=0.6)), ValueError),
])
def test_flconfig_errors_match_reference(kw, err):
    args = dict(n_clients=6, cohort=3)
    args.update(kw)
    with pytest.raises(err):
        JFLConfig.make(**args)
    with pytest.raises(err):
        FLConfig.make(**args)


@pytest.mark.parametrize("kw", [
    dict(method="scaffold"), dict(codec="topk"), dict(sampler="importance"),
    dict(codec="lowrank"), dict(fault="dropout"),
    dict(tracker="jsonl"),
    dict(store="host"),
])
def test_unported_names_raise_not_ported(kw):
    JFLConfig.make(**dict(dict(n_clients=6, cohort=3), **kw))   # reference ok
    with pytest.raises(KeyError, match="not ported"):
        FLConfig.make(**dict(dict(n_clients=6, cohort=3), **kw))


def test_simulator_without_device_raises_without_a_card(world, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fl = FLConfig.make(method="fedavg", **COMMON)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Simulator(world["ttask"], world["tp"], world["ttrain"], fl)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Simulator(world["ttask"], world["tp"], world["ttrain"], fl,
                  device="cuda")


# ---------------------------------------------------------------------------
# the compressed wire and the robust aggregators
# ---------------------------------------------------------------------------

FEDNCV = dict(local_epochs=2, ncv_alpha0=0.3, ncv_alpha_lr=1e-2)
# deterministic wires: the port's own trajectory against the reference's
WIRE_CASES = {
    "bf16": dict(COMMON, codec="bf16", ncv_beta=1.0),
    # cohort 5: trim_frac 0.25 drops one value at each end of a coordinate
    "trimmed_mean": dict(COMMON, cohort=5, aggregator="trimmed_mean",
                         trim_frac=0.25, ncv_beta=0.0),
    "norm_clip": dict(COMMON, cohort=5, aggregator="norm_clip",
                      ncv_beta=0.0),
}
# stochastic rounding: round by round from the reference's state
QUANTIZED_CASES = {
    "int8": dict(COMMON, codec="int8", ncv_beta=1.0),
    "int4": dict(COMMON, codec="int4", ncv_beta=1.0),
    "median-int8": dict(COMMON, cohort=5, aggregator="median",
                        codec="int8", ncv_beta=0.0),
}


def reference_draws(jsim, i):
    """The reference's draws of 0-based round i: (idx, sel, u), with u the
    stochastic-rounding uniforms of each cohort slot's encode
    (`_slot_keys` fold_in, then `with_codec`'s split) or None."""
    key = jax.random.fold_in(jax.random.PRNGKey(SEED), i)
    kd, kk = jax.random.split(key)
    idx, sel, *_ = jsim._draw_cohort_sel(jsim._get_state(), kd)
    codec = jsim.codec
    u = None
    if codec.name in ("int8", "int4"):
        u = np.stack([np.asarray(jax.random.uniform(
            jax.random.split(jax.random.fold_in(kk, s))[1],
            (codec.n_chunks, codec.chunk)))
            for s in range(jsim.fl.cohort)])
    return np.asarray(idx), np.asarray(sel), u


def _sims(world, kw):
    jsim = JSimulator(world["jtask"], world["jp"], world["train"],
                      JFLConfig.make(method="fedncv", **kw), seed=SEED)
    tsim = Simulator(world["ttask"], world["tp"], world["ttrain"],
                     FLConfig.make(method="fedncv", **kw), seed=SEED,
                     device="cpu")
    return jsim, tsim


def _check_params(tsim, jsim):
    for k, v in jsim.params.items():
        np.testing.assert_allclose(tsim.params[k].numpy(), np.asarray(v),
                                   rtol=1e-4, atol=1e-5, err_msg=k)
    np.testing.assert_allclose(tsim.alphas.numpy(), np.asarray(jsim.alphas),
                               rtol=1e-5)


@pytest.mark.parametrize("case", list(WIRE_CASES))
def test_wire_and_robust_rounds_match_reference(world, case):
    kw = dict(WIRE_CASES[case], **FEDNCV)
    jsim, tsim = _sims(world, kw)
    draws, jdiags = [], []
    for i in range(ROUNDS):
        draws.append(reference_draws(jsim, i))
        jdiags.append(jsim.run_round())
    tdiags = tsim.run_rounds(ROUNDS, draws=draws)
    _check_params(tsim, jsim)
    np.testing.assert_allclose(tdiags["agg_norm"],
                               [d["agg_norm"] for d in jdiags], rtol=1e-4)
    np.testing.assert_array_equal(tdiags["bytes_up"],
                                  np.float32([d["bytes_up"] for d in jdiags]))


def _codes(codec, wire):
    q = torch.as_tensor(np.array(wire["q"]))
    if codec.name == "int4":
        return unpack_int4_ref(q, chunk=codec.chunk).numpy()
    return q.numpy().astype(np.int32)


@pytest.mark.parametrize("case", list(QUANTIZED_CASES))
def test_quantized_rounds_match_reference(world, case):
    """Stochastic rounding is discontinuous: where x/scale + u lies within
    f32 noise of an integer, the frameworks' convolutions (which differ by
    about 1e-7) put the code one step apart, and one step of a chunk's
    scale is far above the parameter tolerance.  So each of the three
    rounds starts the port from the reference's state and replays the
    round's (idx, sel, u): the wires must agree up to rare single-step
    flips (codes bitwise given the same input: tests/test_torch_comm.py),
    and the port's server section, given the reference's wire, must give
    the reference's parameters at the usual tolerance."""
    kw = dict(QUANTIZED_CASES[case], **FEDNCV)
    jsim, tsim = _sims(world, kw)
    jclient = jax.jit(jsim._client_section_local)
    jserver = jax.jit(jsim._server_section)
    for i in range(ROUNDS):
        tsim.params = params_from_jax(jax.tree.map(np.asarray, jsim.params))
        tsim._state["alphas"] = torch.from_numpy(np.array(jsim.alphas))
        draws = reference_draws(jsim, i)
        # the reference's round through its two sections, so that its
        # server takes the very wire compared here (its one-jit round fuses
        # otherwise, which moves codes too)
        key = jax.random.fold_in(jax.random.PRNGKey(SEED), i)
        jstate = jsim._get_state()
        jpending = jclient(jsim.params, jstate, key)
        jwire = jpending["grads"]
        jsim.params, jstate, jdiag = jserver(jsim.params, jstate, jpending,
                                             jnp.int32(i + 1))
        jsim._set_state(jstate)
        pending = tsim._client_section_local(tsim.params, tsim._state,
                                             draws)
        jcodes = _codes(jsim.codec, jwire)
        tcodes = _codes(tsim.codec, pending["grads"])
        assert np.abs(jcodes - tcodes).max() <= 1
        assert np.count_nonzero(jcodes != tcodes) <= 1e-3 * jcodes.size
        np.testing.assert_allclose(pending["grads"]["s"].numpy(),
                                   np.asarray(jwire["s"]), rtol=1e-4)
        pending["grads"] = {k: torch.from_numpy(np.array(v))
                            for k, v in jwire.items()}
        tsim.params, tsim._state, tdiag = tsim._server_section(
            tsim.params, tsim._state, pending, i + 1)
        _check_params(tsim, jsim)
        np.testing.assert_allclose(float(tdiag["agg_norm"]),
                                   float(jdiag["agg_norm"]), rtol=1e-4)
        assert float(tdiag["bytes_up"]) == float(jdiag["bytes_up"])
