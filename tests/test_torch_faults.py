"""The port's fault models (`repro_torch/fed/faults.py`) and their hooks in
the simulator against the reference's (`src/repro/fed/faults.py`,
`tests/test_faults.py`), on the CPU.

Registry and option validation equal the reference's; the plans, given the
reference's own uniforms (exponentials for the stragglers), equal the
reference's plans, and the Markov start is its fixed-key table bit for bit;
the port's own draws keep the Horvitz-Thompson estimator unbiased, with the
reference tests' negative control; a zero-rate dropout run is bitwise the
run without faults; a dropped client keeps its state, its FedNCV alpha
included; and runs replaying the reference's draws (byzantine `scale`
under `trimmed_mean`, `labelflip` over `int8` round by round, fedncv+ and
scaffold under importance + dropout, markov, the external sampler and
fault with an all-dropped round) land on the reference's params and every
state field (tolerances: `torch_parity`).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.fed import FLConfig as JFLConfig
from repro.fed import faults as jfaults
from repro_torch.fed import FLConfig, Simulator, api, faults, sampling
from repro_torch.fed.methods import MethodConfig
from repro_torch.kernels.rloo.rloo import ncv_coefficients
from repro_torch.utils.tree_math import tree_map
from repro_torch.weights import params_from_jax
from torch_parity import (COMMON, FEDNCV, SEED, check_diags,
                          check_params_and_state, make_world, ref_draws,
                          run_parity, sims, to_torch)


@pytest.fixture(scope="module")
def world():
    return make_world()


# ----------------------------- registry / config ------------------------------

def test_registry_matches_reference():
    # the reference's own tests register "_"-named probe models (its
    # tests/test_faults.py: _killzero, _killall) into the same process
    assert faults.registered_faults() == tuple(
        n for n in jfaults.registered_faults() if not n.startswith("_"))
    for name in faults.registered_faults():
        kw = dict(ext_slots=3) if name == "external" else {}
        fl = FLConfig.make(n_clients=6, cohort=3, fault=name, ncv_beta=0.0,
                           **kw)
        assert fl.fault_opts == JFLConfig.make(
            n_clients=6, cohort=3, fault=name, ncv_beta=0.0,
            **kw).fault_opts


def test_registry_refusals():
    with pytest.raises(KeyError, match="dropout"):
        faults.get_fault("dorpout")
    with pytest.raises(ValueError, match="already registered"):
        faults.register_fault(faults.get_fault("dropout"))
    with pytest.raises(ValueError, match="init_state"):
        faults.register_fault(faults.FaultModel(
            name="_probe_bad", plan=None,
            step=lambda opts, state, gen: state))
    with pytest.raises(ValueError, match="undeclared"):
        faults.register_fault(faults.FaultModel(
            name="_probe_bad", plan=None, defaults=dict(knob=1)))
    assert "_probe_bad" not in faults.registered_faults()


def test_make_routes_fault_options():
    kw = dict(method="fedavg", n_clients=6, cohort=3, fault="dropout",
              drop_rate=0.5, aggregator="trimmed_mean", trim_frac=0.1)
    fl, jfl = FLConfig.make(**kw), JFLConfig.make(**kw)
    assert fl.fault_opts == jfl.fault_opts == dict(drop_rate=0.5)
    assert fl.agg_opts == jfl.agg_opts


@pytest.mark.parametrize("kw,err,match", [
    (dict(fault="dorpout"), KeyError, "unknown fault model"),
    (dict(fault="dropout", drop_rte=0.5), TypeError, "not used by"),
    (dict(fault="dropout", byz_frac=0.2), TypeError, "not used by"),
    (dict(fault="dropout", drop_rate=0.5, fault_opts=dict(drop_rate=0.5)),
     TypeError, "passed both"),
    (dict(fault="dropout", drop_rate=1.5), ValueError, "drop_rate"),
    (dict(fault="dropout", drop_skew=2.0), ValueError, "drop_skew"),
    (dict(fault="markov", mk_fail=0.0), ValueError, "mk_fail"),
    (dict(fault="straggler", str_mean=0.0), ValueError, "str_mean"),
    (dict(fault="straggler", str_skew=1.0), ValueError, "str_skew"),
    (dict(fault="byzantine", byz_attack="nuke"), ValueError, "byz_attack"),
    (dict(fault="byzantine", byz_frac=1.5), ValueError, "byz_frac"),
    (dict(fault="byzantine", byz_scale=0.0), ValueError, "byz_scale"),
    (dict(fault="external"), ValueError, "ext_slots"),
    (dict(fault="none", fault_opts=dict(drop_rate=0.1)), TypeError,
     "not used by"),
])
def test_option_errors_match_reference(kw, err, match):
    args = dict(method="fedavg", n_clients=6, cohort=3, **kw)
    with pytest.raises(err, match=match):
        JFLConfig.make(**args)
    with pytest.raises(err, match=match):
        FLConfig.make(**args)


# ----------------- plans on the reference's own draws -------------------------

M_PLAN = 24
IDX = np.array([0, 5, 23, 11, 17, 2, 9, 20])


def _both(name, **kw):
    return (faults.resolve_opts(faults.get_fault(name), kw),
            jfaults.resolve_opts(jfaults.get_fault(name), kw))


def _check_plan(plan, jplan):
    assert set(plan) == set(jplan)
    for k in jplan:
        assert plan[k].dtype == torch.float32, k
        np.testing.assert_allclose(plan[k].numpy(), np.asarray(jplan[k]),
                                   rtol=1e-6, err_msg=k)
    np.testing.assert_array_equal(plan["alive"].numpy(),
                                  np.asarray(jplan["alive"]))


@pytest.mark.parametrize("kw", [dict(), dict(drop_rate=0.35, drop_skew=0.8),
                                dict(drop_rate=0.35, drop_skew=0.8,
                                     drop_reweight=False)])
def test_dropout_plan_on_the_reference_uniforms(kw):
    opts, jopts = _both("dropout", **kw)
    for s in range(4):
        key = jax.random.PRNGKey(s)
        jplan = jfaults.get_fault("dropout").plan(
            jopts, None, key, jnp.asarray(IDX), M_PLAN)
        u = torch.from_numpy(np.array(jax.random.uniform(key, IDX.shape)))
        _check_plan(faults.dropout_plan_from(opts, torch.from_numpy(IDX),
                                             M_PLAN, u), jplan)


@pytest.mark.parametrize("kw", [dict(), dict(str_mean=1.5, str_deadline=1.5,
                                             str_skew=0.8)])
def test_straggler_plan_on_the_reference_exponentials(kw):
    opts, jopts = _both("straggler", **kw)
    for s in range(4):
        key = jax.random.PRNGKey(s)
        jplan = jfaults.get_fault("straggler").plan(
            jopts, None, key, jnp.asarray(IDX), M_PLAN)
        e = torch.from_numpy(np.array(jax.random.exponential(key,
                                                             IDX.shape)))
        _check_plan(faults.straggler_plan_from(
            opts, torch.from_numpy(IDX), M_PLAN, e), jplan)


def test_markov_start_step_and_plan_match_reference():
    fm, jfm = faults.get_fault("markov"), jfaults.get_fault("markov")
    for kw in (dict(), dict(mk_fail=0.2, mk_recover=0.6)):
        opts, jopts = _both("markov", **kw)
        for m in (6, 40, M_PLAN):
            state, jstate = fm.init_state(opts, m), jfm.init_state(jopts, m)
            np.testing.assert_array_equal(state["on"].numpy(),
                                          np.asarray(jstate["on"]))
        for s in range(3):
            key = jax.random.PRNGKey(s)
            jstate = jfm.step(jopts, jstate, key)
            state = faults.markov_step_from(opts, state, torch.from_numpy(
                np.array(jax.random.uniform(key, (M_PLAN,)))))
            np.testing.assert_array_equal(state["on"].numpy(),
                                          np.asarray(jstate["on"]))
            _check_plan(fm.plan(opts, state, None, torch.from_numpy(IDX),
                                M_PLAN),
                        jfm.plan(jopts, jstate, key, jnp.asarray(IDX),
                                 M_PLAN))


@pytest.mark.parametrize("attack", faults.BYZ_ATTACKS)
def test_byzantine_plan_marks_the_reference_prefix(attack):
    opts, jopts = _both("byzantine", byz_frac=0.25, byz_attack=attack)
    assert faults.n_byzantine(opts, 12) == jfaults.n_byzantine(jopts, 12) == 3
    idx = np.array([0, 5, 2, 11])
    plan = faults.get_fault("byzantine").plan(opts, None, None,
                                              torch.from_numpy(idx), 12)
    _check_plan(plan, jfaults.get_fault("byzantine").plan(
        jopts, None, jax.random.PRNGKey(0), jnp.asarray(idx), 12))
    fm = faults.get_fault("byzantine")
    assert fm.corrupts(opts) == (attack != "labelflip")
    assert fm.flips(opts) == (attack == "labelflip")


def test_external_plan_reads_its_tables():
    opts, jopts = _both("external", ext_slots=4)
    tables = dict(alive=np.float32([1, 0, 1, 1]),
                  invp=np.float32([1.25, 0, 2.0, 0.5]))
    idx = np.array([3, 1, 4, 0])
    _check_plan(faults.get_fault("external").plan(
        opts, to_torch(tables), None, torch.from_numpy(idx), 6),
        jfaults.get_fault("external").plan(
            jopts, jax.tree.map(jnp.asarray, tables), None,
            jnp.asarray(idx), 6))
    with pytest.raises(ValueError, match="ext_slots"):
        faults.get_fault("external").plan(opts, to_torch(tables), None,
                                          torch.arange(3), 6)


# ----------------- HT unbiasedness of the port's own draws --------------------

M_STAT, C_STAT, T_STAT = 24, 8, 4000


def _fault_estimate(fault, fopts):
    rng = np.random.default_rng(42)
    g = torch.from_numpy((rng.standard_normal((M_STAT, 5))
                          + np.arange(M_STAT)[:, None] / 8.0)
                         .astype(np.float32))
    n = torch.from_numpy(np.random.default_rng(0).integers(
        5, 40, M_STAT).astype(np.float32))
    full = (n[:, None] * g).sum(0) / n.sum()
    fm = faults.get_fault(fault)
    opts = faults.resolve_opts(fm, fopts)
    smp = sampling.get_sampler("uniform")
    state0 = fm.init_state(opts, M_STAT) if fm.init_state else None
    gen, fgen = (torch.Generator().manual_seed(s) for s in (7, 8))
    est, lives = torch.zeros(5), 0.0
    for _ in range(T_STAT):
        idx, _ = smp.draw({}, None, gen, M_STAT, C_STAT)
        state = fm.step(opts, state0, fgen) if fm.step else state0
        w_eff = n[idx] * fm.plan(opts, state, fgen, idx, M_STAT)["invp"]
        if float(w_eff.sum()) > 0:
            est += (ncv_coefficients(w_eff, 0.0)[:, None] * g[idx]).sum(0)
            lives += 1.0
    return float(torch.linalg.norm(est / lives - full)
                 / torch.linalg.norm(full))


def test_dropout_reweighting_unbiased_with_negative_control():
    err = _fault_estimate("dropout", dict(drop_rate=0.35, drop_skew=0.8))
    assert err < 0.07, err
    err_raw = _fault_estimate("dropout", dict(drop_rate=0.35, drop_skew=0.8,
                                              drop_reweight=False))
    assert err_raw > 0.12, err_raw


def test_straggler_reweighting_unbiased():
    err = _fault_estimate("straggler", dict(str_mean=1.5, str_deadline=1.5,
                                            str_skew=0.8))
    assert err < 0.07, err


def test_markov_stationary_reweighting_unbiased():
    err = _fault_estimate("markov", dict(mk_fail=0.2, mk_recover=0.6))
    assert err < 0.05, err


# --------------------------- simulator integration ----------------------------

def _port_sim(world, **kw):
    fl = FLConfig.make(**dict(COMMON, **kw))
    return Simulator(world["ttask"], world["tp"], world["ttrain"], fl,
                     seed=SEED, device="cpu")


def test_zero_rate_dropout_matches_no_fault_exactly(world):
    """Every fault wrapper on, every factor exactly 1: the port's own
    trajectory is bitwise the one without faults (the fault draws run on a
    generator of their own, so the cohorts are the same)."""
    kw = dict(FEDNCV, local_epochs=1)
    sa = _port_sim(world, **kw)
    sb = _port_sim(world, fault="dropout", drop_rate=0.0, **kw)
    da, db = sa.run_rounds(2), sb.run_rounds(2)
    for k in sa.params:
        assert torch.equal(sa.params[k], sb.params[k]), k
    assert torch.equal(sa.alphas, sb.alphas)
    np.testing.assert_array_equal(da["agg_norm"], db["agg_norm"])
    np.testing.assert_array_equal(da["bytes_up"], db["bytes_up"])
    np.testing.assert_array_equal(db["live"], 3.0)


def test_dropped_client_keeps_its_alpha():
    """`_fedncv_server` writes a dropped slot's alpha back unchanged: the
    round's starting alpha (aux["alpha"]), not the update its stats would
    give."""
    mc = MethodConfig(name="fedncv", ncv_alpha_lr=0.5)
    fl = FLConfig.make(n_clients=5, cohort=3, ncv_alpha_lr=0.5)
    aux = dict(alpha=torch.tensor([0.3, 0.4, 0.5]), k=torch.full((3,), 4.0),
               mean_norm_sq=torch.tensor([1.0, 2.0, 3.0]),
               sum_norm_sq=torch.tensor([5.0, 9.0, 14.0]))
    params = {"w": torch.zeros(2)}
    agg = ({"w": torch.ones(2)}, torch.tensor(2.0))
    state = dict(alphas=torch.full((5,), 0.3))
    outs = []
    for alive in (None, torch.tensor([1.0, 0.0, 1.0])):
        ctx = api.RoundCtx(task=None, mc=mc, fl=fl, r=1,
                           idx=torch.tensor([4, 1, 2]), sizes=torch.ones(3),
                           aux=aux, alive=alive)
        _, st, _ = api.get_method("fedncv").server_update(ctx, params, agg,
                                                          dict(state))
        outs.append(st["alphas"])
    assert float(outs[0][1]) != 0.4          # the update moves it ...
    assert float(outs[1][1]) == pytest.approx(0.4)   # ... unless dropped
    assert torch.equal(outs[0][[2, 4]], outs[1][[2, 4]])


def test_never_reporting_client_keeps_its_state(world):
    """Client 0 never reports: its alpha stays at the initial value while
    the same run without the fault moves it."""
    faults.register_fault(faults.FaultModel(
        name="_killzero",
        plan=lambda opts, state, gen, idx, m: dict(
            faults._ones_plan(idx.shape[0]), alive=(idx != 0).float(),
            invp=(idx != 0).float()),
        drops=staticmethod(lambda opts: True)))
    try:
        kw = dict(FEDNCV, local_epochs=1, ncv_alpha_lr=0.5)
        sa, sb = _port_sim(world, fault="_killzero", **kw), _port_sim(
            world, **kw)
        sa.run_rounds(3)
        sb.run_rounds(3)
    finally:
        faults._REGISTRY.pop("_killzero")
    assert float(sb.alphas[0]) != 0.3
    assert float(sa.alphas[0]) == np.float32(0.3)
    assert bool((sa.alphas[1:] != np.float32(0.3)).any())


def test_byzantine_scale_owns_mean_not_trimmed(world):
    """2 of 6 clients upload 50x: the mean's agg_norm blows up against its
    honest run, the trimmed mean's does not (the reference's margins)."""
    kw = dict(method="fedavg", cohort=6, local_epochs=1)
    topts = dict(aggregator="trimmed_mean", trim_frac=0.34)
    byz = dict(fault="byzantine", byz_frac=0.2, byz_scale=50.0)

    def first_norm(**extra):
        return float(_port_sim(world, **kw, **extra).run_rounds(1)[
            "agg_norm"][0])
    n_mean, n_mean_h = first_norm(**byz), first_norm()
    n_trim, n_trim_h = first_norm(**byz, **topts), first_norm(**topts)
    assert n_mean > 10.0 * n_mean_h, (n_mean, n_mean_h)
    assert n_trim < 4.0 * n_trim_h, (n_trim, n_trim_h)
    assert n_mean / n_mean_h > 10.0 * (n_trim / n_trim_h)


@pytest.mark.parametrize("method,kw", [
    ("fedncv", dict(FEDNCV, cohort=5, fault="byzantine", byz_frac=0.34,
                    aggregator="trimmed_mean", trim_frac=0.25)),
    ("fedncv", dict(FEDNCV, fault="markov", mk_fail=0.3, mk_recover=0.5)),
    ("fedncv+", dict(local_epochs=2, sampler="importance", fault="dropout",
                     drop_rate=0.4, drop_skew=0.5)),
    ("scaffold", dict(local_epochs=2, sampler="importance", fault="dropout",
                      drop_rate=0.4, drop_skew=0.5)),
], ids=["byzantine-scale-trimmed_mean", "markov", "fedncv+-invp-alive",
        "scaffold-invp-alive"])
def test_rounds_match_reference_with_replayed_draws(world, method, kw):
    _, _, draws = run_parity(world, 2, method=method, **kw)
    if kw["fault"] != "byzantine":
        assert any(d.plan["alive"].min() == 0 for d in draws)


def test_external_tables_and_an_all_dropped_round(world):
    """The external sampler and fault with tables written before each
    round, the same on both sides; in the second every slot is dead: a
    finite no-op that keeps every state field."""
    kw = dict(FEDNCV, sampler="external", ext_cohort=3, fault="external",
              ext_slots=3)
    jsim, tsim = sims(world, **kw)
    tables = [(np.int32([4, 0, 2]), np.float32([1.5, 0.5, 1.0]),
               np.float32([1, 1, 0]), np.float32([1.25, 2.0, 0.0])),
              (np.int32([1, 3, 5]), np.float32([1.0, 1.0, 1.0]),
               np.float32([0, 0, 0]), np.float32([0, 0, 0]))]
    for i, (idx, invp, alive, finvp) in enumerate(tables):
        jsim.sampler = dict(idx=jnp.asarray(idx), invp=jnp.asarray(invp))
        jsim.faults = dict(alive=jnp.asarray(alive), invp=jnp.asarray(finvp))
        tsim.sampler = dict(idx=torch.from_numpy(idx),
                            invp=torch.from_numpy(invp))
        tsim.faults = dict(alive=torch.from_numpy(alive),
                           invp=torch.from_numpy(finvp))
        draws = ref_draws(jsim, i)
        np.testing.assert_array_equal(draws.idx, idx)
        before = tree_map(torch.clone, dict(tsim.params, **tsim._state))
        tdiag = tsim.run_rounds(1, draws=[draws])
        check_diags(tdiag, [jsim.run_round()])
        check_params_and_state(tsim, jsim)
        if i == 1:
            assert tdiag["agg_norm"][0] == 0.0 and tdiag["live"][0] == 0.0
            after = dict(tsim.params, **tsim._state)
            for k in tsim.params:
                assert torch.equal(before[k], after[k]), k
            assert torch.equal(before["alphas"], after["alphas"])


def test_labelflip_over_int8_matches_reference_round_by_round(world):
    """Label-flipping clients over the int8 wire.  Stochastic rounding is
    discontinuous, so as in `test_quantized_rounds_match_reference` each
    round starts the port from the reference's state and its server takes
    the reference's wire; the codes agree up to rare single steps."""
    kw = dict(FEDNCV, cohort=5, fault="byzantine", byz_frac=0.34,
              byz_attack="labelflip", codec="int8")
    jsim, tsim = sims(world, **kw)
    jclient = jax.jit(jsim._client_section_local)
    jserver = jax.jit(jsim._server_section)
    flipped = 0
    for i in range(2):
        tsim.params = params_from_jax(jax.tree.map(np.asarray, jsim.params))
        tsim._state["alphas"] = torch.from_numpy(np.array(jsim.alphas))
        draws = ref_draws(jsim, i)
        flipped += int(draws.plan["flip"].sum())
        key = jax.random.fold_in(jax.random.PRNGKey(SEED), i)
        jstate = jsim._get_state()
        jpending = jclient(jsim.params, jstate, key)
        jwire = jpending["grads"]
        jsim.params, jstate, jdiag = jserver(jsim.params, jstate, jpending,
                                             jnp.int32(i + 1))
        jsim._set_state(jstate)
        pending = tsim._client_section_local(tsim.params, tsim._state,
                                             draws)
        jcodes = np.asarray(jwire["q"]).astype(np.int32)
        tcodes = pending["grads"]["q"].numpy().astype(np.int32)
        assert np.abs(jcodes - tcodes).max() <= 1
        assert np.count_nonzero(jcodes != tcodes) <= 1e-3 * jcodes.size
        pending["grads"] = {k: torch.from_numpy(np.array(v))
                            for k, v in jwire.items()}
        tsim.params, tsim._state, tdiag = tsim._server_section(
            tsim.params, tsim._state, pending, i + 1)
        check_params_and_state(tsim, jsim)
        check_diags({k: np.float32([v]) for k, v in tdiag.items()},
                    [{k: float(v) for k, v in jdiag.items()}])
    assert flipped > 0
