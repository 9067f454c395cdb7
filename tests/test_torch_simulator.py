"""The port's simulator against the reference's on the CPU, small size.

The port replays the reference's draws through its draw-injection seam:
for 0-based round i the reference draws with
`key = fold_in(PRNGKey(seed), i)`, `kd, kk = split(key)` and
`_draw_cohort_sel(state, kd)`; no method draws anything else, and
the int8 / int4 wire draws its rounding uniforms from `kk` per cohort
slot (`reference_draws`).

Every registered method runs 3 rounds (pfedsim 10, so that its round-10
head mixing is compared too).  Tolerances and why:
  params and every state field (c_u, c_global, h, h_sum, personal, m, v)
          rtol 1e-4 / atol 1e-5 — the rounds of training compound the
          f32 summation-order differences of XLA's and PyTorch's CPU
          convolutions (about 1e-7 per step);
  alphas  rtol 1e-5 — one scalar update per round from S1;
  agg_norm rtol 1e-4 — a sum of 62,006 squares of the above;
  bytes_up equal — pure accounting;
  wire codes — equal up to rare single steps, round by round (see
          `test_quantized_rounds_match_reference`);
  evaluate within 1e-2 absolute — an argmax may flip on a near tie;
  pfedsim_server_mix and fedncv_plus_server, given the same inputs,
          rtol 1e-5 / atol 1e-6 — one pass of f32 arithmetic;
  the federated mask and the masked aggregate equal (products by 0 and 1),
          the masked norm rtol 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import federated_splits as j_splits
from repro.fed import FLConfig as JFLConfig, Simulator as JSimulator
from repro.fed import Task as JTask
from repro.fed import api as japi
from repro.fed import methods as jmethods
from repro.fed import registered_methods as j_registered_methods
from repro.models import lenet as jlenet
from repro_torch.data import federated_splits as t_splits
from repro_torch.fed import FLConfig, Simulator, Task
from repro_torch.fed import api as tapi
from repro_torch.fed import methods as tmethods
from repro_torch.fed.api import registered_methods
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
    "fedprox": ("fedprox", dict(local_epochs=2, prox_mu=0.1)),
    "scaffold": ("scaffold", dict(local_epochs=2)),
    "fedncv+": ("fedncv+", dict(local_epochs=2)),
    "fedper": ("fedper", dict(local_epochs=2)),
    "fedrep": ("fedrep", dict(local_epochs=1, head_local_steps=2)),
    "pfedsim": ("pfedsim", dict(local_epochs=2)),
    "fedglomo": ("fedglomo", dict(local_epochs=2, glomo_beta_local=0.5)),
}
# rounds of a case, where it is not ROUNDS: pfedsim mixes heads in round 10
CASE_ROUNDS = {"pfedsim": 10}


def _check_state(tsim, jsim):
    """Every state field of the port against the reference's."""
    jstate = jsim._get_state()
    assert set(tsim._state) == set(jstate)
    for name, jv in jstate.items():
        tol = dict(rtol=1e-5) if name == "alphas" else dict(rtol=1e-4,
                                                             atol=1e-5)
        for path, leaf in _flat(jv):
            np.testing.assert_allclose(_get(tsim._state[name], path).numpy(),
                                       np.asarray(leaf), err_msg=name + path,
                                       **tol)


def _flat(tree, path=""):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k],
                                                       f"{path}/{k}")]
    return [(path, tree)]


def _get(tree, path):
    for k in path.split("/")[1:]:
        tree = tree[k]
    return tree


@pytest.mark.parametrize("case", list(CASES))
def test_rounds_match_reference_with_replayed_draws(world, case):
    method, kw = CASES[case]
    jfl = JFLConfig.make(method=method, **COMMON, **kw)
    jsim = JSimulator(world["jtask"], world["jp"], world["train"], jfl,
                      seed=SEED)
    tsim = Simulator(world["ttask"], world["tp"], world["ttrain"],
                     FLConfig.make(method=method, **COMMON, **kw),
                     seed=SEED, device="cpu")
    rounds = CASE_ROUNDS.get(case, ROUNDS)
    draws, jdiags = [], []
    for i in range(rounds):
        key = jax.random.fold_in(jax.random.PRNGKey(SEED), i)
        kd, _ = jax.random.split(key)
        idx, sel, *_ = jsim._draw_cohort_sel(jsim._get_state(), kd)
        draws.append((np.asarray(idx), np.asarray(sel)))
        jdiags.append(jsim.run_round())
    tdiags = tsim.run_rounds(rounds, draws=draws)
    for k, v in jsim.params.items():
        np.testing.assert_allclose(tsim.params[k].numpy(), np.asarray(v),
                                   rtol=1e-4, atol=1e-5, err_msg=k)
    _check_state(tsim, jsim)
    np.testing.assert_allclose(tdiags["agg_norm"],
                               [d["agg_norm"] for d in jdiags], rtol=1e-4)
    np.testing.assert_array_equal(tdiags["bytes_up"],
                                  np.float32([d["bytes_up"] for d in jdiags]))
    for steps in (0, 3):
        assert abs(tsim.evaluate(world["ttest"], personalize_steps=steps)
                   - jsim.evaluate(world["test"], personalize_steps=steps)) \
            <= 1e-2


@pytest.mark.parametrize("method,kw,aux_bytes", [
    # identity wire: cohort * (4 N + what the method adds to the upload)
    ("fedncv", dict(ncv_beta=0.0), 16),          # FedNCV's 4 f32 scalars
    ("scaffold", {}, 4 * 62006),                 # delta_c
    ("pfedsim", {}, 4 * (84 * 10 + 10)),         # the flattened head
    ("fedglomo", {}, 0),
])
def test_bytes_up_is_the_reference_accounting(world, method, kw, aux_bytes):
    sim = _toy(world, method=method, local_epochs=2, **kw)
    diag = sim.run_round()
    assert diag["bytes_up"] == 3 * (4 * 62006 + aux_bytes)


def test_registry_matches_reference():
    assert registered_methods() == j_registered_methods()
    for m in registered_methods():
        assert FLConfig.make(method=m, n_clients=6, cohort=3).mc.name == m


def _np_tree(tree):
    return {k: _np_tree(v) if isinstance(v, dict) else np.asarray(v)
            for k, v in tree.items()}


def _assert_trees_close(ttree, jtree, **tol):
    for path, leaf in _flat(jtree):
        np.testing.assert_allclose(_get(ttree, path).numpy(),
                                   np.asarray(leaf), err_msg=path, **tol)


def test_pfedsim_server_mix_matches_reference():
    rng = np.random.default_rng(5)
    heads = rng.standard_normal((5, 850)).astype(np.float32)
    personal = {"head": rng.standard_normal((5, 84, 10)).astype(np.float32),
                "bh": rng.standard_normal((5, 10)).astype(np.float32)}
    for temp in (5.0, 0.5):
        want = jmethods.pfedsim_server_mix(jnp.asarray(heads),
                                           jax.tree.map(jnp.asarray,
                                                        personal), temp)
        got = tmethods.pfedsim_server_mix(
            torch.from_numpy(heads),
            {k: torch.from_numpy(v) for k, v in personal.items()}, temp)
        _assert_trees_close(got, want, rtol=1e-5, atol=1e-6)


def test_federated_mask_matches_reference(world):
    """The personal methods' federated slice: the mask, the aggregate's hard
    mask and its norm, as the reference computes them."""
    jfields = japi.get_method("fedper").state_spec(world["jtask"], None)
    tfields = tapi.get_method("fedper").state_spec(world["ttask"], None)
    jmask = japi.federated_mask(jfields, world["jp"], world["jtask"], None)
    tmask = tapi.federated_mask(tfields, world["tp"], world["ttask"], None)
    _assert_trees_close(tmask, jmask, rtol=0, atol=0)
    assert float(tmask["head"].max()) == 0.0 and float(
        tmask["conv1"].min()) == 1.0
    rng = np.random.default_rng(7)
    agg = {k: rng.standard_normal(v.shape).astype(np.float32)
           for k, v in world["jp"].items()}
    jt, jn = japi.apply_federated_mask(jax.tree.map(jnp.asarray, agg), jmask)
    tt, tn = tapi.apply_federated_mask(
        {k: torch.from_numpy(v) for k, v in agg.items()}, tmask)
    _assert_trees_close(tt, jt, rtol=0, atol=0)
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    assert tapi.federated_mask(
        tapi.get_method("scaffold").state_spec(world["ttask"], None),
        world["tp"], world["ttask"], None) is None


def test_personal_heads_get_no_update_over_a_lossy_wire(world, monkeypatch):
    """fedper over the int8 wire: the server hard-masks the decoded
    aggregate (once a round), and the shared copy of the personal head
    keeps its bits."""
    calls = []

    def spy(tree, mask):
        calls.append(1)
        return apply(tree, mask)

    apply = tapi.apply_federated_mask
    monkeypatch.setattr(tapi, "apply_federated_mask", spy)
    sim = _toy(world, method="fedper", codec="int8", local_epochs=2)
    head0 = {k: sim.params[k].clone() for k in ("head", "bh")}
    draws = sim.draw_round()
    diag = sim.run_round(draws=draws)
    for k, v in head0.items():
        assert torch.equal(sim.params[k], v), k
    # the cohort trained its own heads; the others kept the initial one
    moved = [not torch.equal(sim.personal["head"][u], head0["head"])
             for u in range(6)]
    assert moved == [u in draws[0].tolist() for u in range(6)]
    assert not torch.equal(sim.params["conv1"], world["tp"]["conv1"])
    assert np.isfinite(diag["agg_norm"]) and len(calls) == 1


@pytest.mark.parametrize("invp,alive", [
    (None, None),
    ([1.5, 0.5, 2.0, 1.0], None),
    ([1.6, 0.0, 2.4, 0.8], [1.0, 0.0, 1.0, 1.0]),   # client 1 dropped
])
def test_fedncv_plus_server_matches_reference(invp, alive):
    rng = np.random.default_rng(6)
    m_total, c = 7, 4
    shapes = {"w": (3, 5), "b": (5,)}
    mk = lambda *lead: {k: rng.standard_normal(lead + s).astype(np.float32)
                        for k, s in shapes.items()}
    params, grads, h = mk(), mk(c), mk(m_total)
    sstate = dict(h=h, h_sum={k: v.sum(0) for k, v in h.items()})
    idx = np.array([5, 0, 3, 6])
    sizes = np.array([10.0, 4.0, 7.0, 3.0], np.float32)
    args = lambda cast, arr: (
        cast(params), cast(grads), arr(sizes), arr(idx),
        dict(h=cast(sstate["h"]), h_sum=cast(sstate["h_sum"])), 0.5,
        m_total, None if invp is None else arr(np.float32(invp)),
        None if alive is None else arr(np.float32(alive)))
    jp, js, jd = jmethods.fedncv_plus_server(
        None, None, *args(lambda t: jax.tree.map(jnp.asarray, t),
                          jnp.asarray))
    tp, ts, td = tmethods.fedncv_plus_server(
        None, None, *args(lambda t: {k: torch.from_numpy(v)
                                     for k, v in t.items()},
                          torch.from_numpy))
    _assert_trees_close(tp, jp, rtol=1e-5, atol=1e-6)
    _assert_trees_close(ts, js, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(td["agg_norm"]), float(jd["agg_norm"]),
                               rtol=1e-5)


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
    # the other methods' options (tests/test_api.py)
    (dict(method="fedprox", prox_mu=-1.0), ValueError),
    (dict(method="fedglomo", glomo_beta_global=1.5), ValueError),
    (dict(method="fedglomo", glomo_beta_local=-0.1), ValueError),
    (dict(method="fedncv", glomo_beta_global=0.9), TypeError),
    (dict(method="fedavg", prox_mu=0.1), TypeError),
    (dict(method="fedper", head_local_steps=2), TypeError),
    (dict(method="scaffold", ncv_beta=0.0), TypeError),
    (dict(method="fedncv+", aggregator="median"), ValueError),
    (dict(method="fedrep", aggregator="trimmed_mean", prox_mu=0.1),
     TypeError),
])
def test_flconfig_errors_match_reference(kw, err):
    args = dict(n_clients=6, cohort=3)
    args.update(kw)
    with pytest.raises(err):
        JFLConfig.make(**args)
    with pytest.raises(err):
        FLConfig.make(**args)


@pytest.mark.parametrize("kw", [
    # these ids named registry entries the port did not have yet; with the
    # codecs and then every tracker ported they keep their ids and assert,
    # in place, what the reference asserts for each configuration: it
    # builds, with the reference's tracker, tracker_opts and codec, and the
    # tracker's registered options and defaults (no sink is constructed)
    dict(tracker="csv"), dict(codec="topk", tracker="csv"),
    dict(tracker="memory"), dict(codec="lowrank", tracker="memory"),
    dict(tracker="stdout"),
    dict(tracker="jsonl"),
    dict(tracker="composite"),
])
def test_unported_names_raise_not_ported(kw):
    from repro import track as jtrack
    from repro_torch import track
    jfl = JFLConfig.make(**dict(dict(n_clients=6, cohort=3), **kw))
    fl = FLConfig.make(**dict(dict(n_clients=6, cohort=3), **kw))
    assert (fl.tracker, fl.tracker_opts, fl.codec) == \
        (jfl.tracker, jfl.tracker_opts, jfl.codec)
    spec, jspec = track.get_tracker(fl.tracker), jtrack.get_tracker(
        jfl.tracker)
    assert (spec.options, spec.defaults) == (jspec.options, jspec.defaults)


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
