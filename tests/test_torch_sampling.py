"""The port's cohort samplers (`repro_torch/fed/sampling.py`) against the
reference's (`src/repro/fed/sampling.py`, `tests/test_sampling.py`), on
the CPU.

Registry and option validation equal the reference's; the sketch
projection is the reference's matrix bit for bit; the draws, given the
reference's Gumbel noise, pick the reference's cohort; the port's own
draws keep the Horvitz-Thompson estimator unbiased, with the reference
tests' negative control; and 2-round runs of importance, similarity and
importance + dropout, replaying the reference's draws, land on the
reference's params and every state field (tolerances: `torch_parity`).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.fed import FLConfig as JFLConfig
from repro.fed import sampling as jsampling
from repro_torch.fed import FLConfig, Simulator, sampling
from repro_torch.kernels.rloo.rloo import ncv_coefficients
from torch_parity import COMMON, FEDNCV, make_world, run_parity


@pytest.fixture(scope="module")
def world():
    return make_world()


def test_registry_matches_reference():
    # "_"-named probes are registered by tests, the reference's among them
    assert sampling.registered_samplers() == tuple(
        n for n in jsampling.registered_samplers() if not n.startswith("_"))
    for name in sampling.registered_samplers():
        kw = dict(ext_cohort=3) if name == "external" else {}
        fl = FLConfig.make(n_clients=6, cohort=3, sampler=name, **kw)
        assert fl.sampler_opts == JFLConfig.make(
            n_clients=6, cohort=3, sampler=name, **kw).sampler_opts


def test_registry_refusals():
    with pytest.raises(KeyError, match="uniform"):
        sampling.get_sampler("unifrom")
    with pytest.raises(ValueError, match="already registered"):
        sampling.register_sampler(sampling.get_sampler("uniform"))
    sampling.register_sampler(sampling.get_sampler("uniform"),
                              overwrite=True)
    with pytest.raises(ValueError, match="init_state"):
        sampling.register_sampler(sampling.CohortSampler(
            name="_probe_bad",
            draw=lambda opts, state, gen, m, c: (torch.arange(c), None),
            update=lambda opts, state, idx, sizes, aux: state))
    with pytest.raises(ValueError, match="undeclared"):
        sampling.register_sampler(sampling.CohortSampler(
            name="_probe_bad", draw=None, defaults=dict(knob=1)))
    assert "_probe_bad" not in sampling.registered_samplers()


def test_make_allows_latent_option_collision():
    probe = sampling.CohortSampler(
        name="_probe_collide",
        draw=lambda opts, state, gen, m, c: (torch.randperm(m)[:c], None),
        options=("local_lr",), defaults=dict(local_lr=0.5))
    sampling.register_sampler(probe)
    try:
        FLConfig.make(method="fedavg", sampler="_probe_collide")
        fl = FLConfig.make(method="fedavg", sampler="_probe_collide",
                           sampler_opts=dict(local_lr=0.25))
        assert fl.sampler_opts == dict(local_lr=0.25)
        with pytest.raises(TypeError, match="claimed by both"):
            FLConfig.make(method="fedavg", sampler="_probe_collide",
                          local_lr=0.25)
    finally:
        sampling._REGISTRY.pop("_probe_collide")


def test_make_routes_sampler_options():
    for kw in (dict(method="fedncv", sampler="importance", imp_mix=0.5,
                    ncv_beta=0.0),
               dict(sampler="similarity", sampler_opts=dict(sim_dim=4),
                    sim_ema=0.9)):
        fl, jfl = FLConfig.make(**kw), JFLConfig.make(**kw)
        assert fl.sampler_opts == jfl.sampler_opts
        assert fl.mc.ncv_beta == jfl.mc.ncv_beta


@pytest.mark.parametrize("kw,err,match", [
    (dict(sampler="importence"), KeyError, "unknown cohort sampler"),
    (dict(sampler="importance", imp_mixx=0.5), TypeError, "imp_mixx"),
    (dict(sampler="importance", sim_dim=4), TypeError, "sim_dim"),
    (dict(sampler="uniform", imp_mix=0.5), TypeError, "imp_mix"),
    (dict(sampler="similarity", sampler_opts=dict(sim_ema=0.2),
          sim_ema=0.9), TypeError, "sim_ema"),
    (dict(sampler="importance", imp_mix=0.0), ValueError, "imp_mix"),
    (dict(sampler="importance", imp_ema=1.5), ValueError, "imp_ema"),
    (dict(sampler="similarity", sim_dim=0), ValueError, "sim_dim"),
    (dict(sampler="similarity", sim_ema=0.0), ValueError, "sim_ema"),
    (dict(sampler="similarity", sim_noise=-1.0), ValueError, "sim_noise"),
    (dict(sampler="similarity", sim_noise=0.0, sim_explore=0.0), ValueError,
     "sim_noise"),
    (dict(sampler="external"), ValueError, "ext_cohort"),
])
def test_option_errors_match_reference(kw, err, match):
    with pytest.raises(err, match=match):
        JFLConfig.make(**kw)
    with pytest.raises(err, match=match):
        FLConfig.make(**kw)


@pytest.mark.parametrize("n,d", [(62006, 8), (1001, 3)])
def test_sketch_projection_is_the_reference_matrix(n, d):
    got = sampling.sketch_projection(n, d)
    want = np.asarray(jsampling.sketch_projection(n, d))
    assert got.dtype == torch.float32 and got.shape == (d, n)
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  want.view(np.uint32))


def _opts(name, **kw):
    return (sampling.resolve_opts(sampling.get_sampler(name), kw),
            jsampling.resolve_opts(jsampling.get_sampler(name), kw))


def test_draws_on_the_reference_noise_pick_its_cohort():
    """Importance's probabilities and HT factors, and the similarity
    traversal given the reference's Gumbel noise, equal the reference's
    (a fresh and a trained table, skewed scores)."""
    m, c = 12, 5
    score = np.linspace(0.2, 3.0, m).astype(np.float32)
    topts, jopts = _opts("importance")
    for state in (dict(score=np.ones(m, np.float32)), dict(score=score)):
        key = jax.random.PRNGKey(3)
        jidx, jinvp = jsampling.get_sampler("importance").draw(
            jopts, jax.tree.map(jnp.asarray, state), key, m, c)
        q = sampling.importance_q(topts, {"score": torch.from_numpy(
            state["score"])}, m)
        g = torch.from_numpy(np.array(jax.random.gumbel(key, (m,))))
        idx = torch.topk(torch.log(q) + g, c).indices
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
        np.testing.assert_allclose((1.0 / (m * q[idx])).numpy(),
                                   np.asarray(jinvp), rtol=1e-6)
    topts, jopts = _opts("similarity", sim_dim=4)
    rng = np.random.default_rng(0)
    for state in (dict(sketch=np.zeros((m, 4), np.float32),
                       age=np.zeros(m, np.float32)),
                  dict(sketch=rng.standard_normal((m, 4)).astype(np.float32),
                       age=rng.integers(0, 4, m).astype(np.float32))):
        key = jax.random.PRNGKey(4)
        jidx, jinvp = jsampling.get_sampler("similarity").draw(
            jopts, jax.tree.map(jnp.asarray, state), key, m, c)
        idx = sampling.similarity_pick(
            topts, {k: torch.from_numpy(v) for k, v in state.items()},
            torch.from_numpy(np.array(jax.random.gumbel(key, (m,)))), c)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
        assert jinvp is None


def test_importance_invp_is_one_on_fresh_table():
    smp = sampling.get_sampler("importance")
    opts = sampling.resolve_opts(smp, {})
    _, invp = smp.draw(opts, smp.init_state(opts, 10),
                       torch.Generator().manual_seed(0), 10, 4)
    np.testing.assert_allclose(invp.numpy(), 1.0, rtol=1e-6)


def test_gumbel_top_k_marginals_match_probabilities():
    q = torch.tensor([0.05, 0.1, 0.15, 0.3, 0.4])
    gen = torch.Generator().manual_seed(0)
    idx = [int(sampling.gumbel_top_k(gen, torch.log(q), 1)[0])
           for _ in range(8000)]
    freq = np.bincount(idx, minlength=5) / 8000.0
    np.testing.assert_allclose(freq, q.numpy(), atol=0.02)


def test_draws_are_without_replacement():
    gen = torch.Generator().manual_seed(5)
    for name in sorted(set(sampling.registered_samplers()) - {"external"}):
        smp = sampling.get_sampler(name)
        opts = sampling.resolve_opts(smp, {})
        state = smp.init_state(opts, 8) if smp.stateful else None
        idx, _ = smp.draw(opts, state, gen, 8, 5)
        assert idx.dtype == torch.int64
        assert len(np.unique(idx.numpy())) == 5, name


# the reference's estimator problem (tests/test_sampling.py), its data made
# here with numpy: the self-normalized HT estimator of the port's own draws
# must reproduce the full-participation weighted mean
M_STAT, C_STAT, D_STAT, T_STAT = 24, 8, 5, 3000


def _mean_estimate(name, state, *, reweight=True):
    rng = np.random.default_rng(42)
    g = torch.from_numpy((rng.standard_normal((M_STAT, D_STAT))
                          + np.arange(M_STAT)[:, None] / 8.0)
                         .astype(np.float32))
    n = torch.from_numpy(np.random.default_rng(0).integers(
        5, 40, M_STAT).astype(np.float32))
    full = (n[:, None] * g).sum(0) / n.sum()
    smp = sampling.get_sampler(name)
    opts = sampling.resolve_opts(smp, {})
    gen = torch.Generator().manual_seed(7)
    est = torch.zeros(D_STAT)
    for _ in range(T_STAT):
        idx, invp = smp.draw(opts, state, gen, M_STAT, C_STAT)
        w_eff = n[idx] if (invp is None or not reweight) else n[idx] * invp
        est += (ncv_coefficients(w_eff, 0.0)[:, None] * g[idx]).sum(0)
    return float(torch.linalg.norm(est / T_STAT - full)
                 / torch.linalg.norm(full))


def test_uniform_estimator_unbiased():
    assert _mean_estimate("uniform", None) < 0.03


def test_importance_estimator_unbiased_under_skewed_table():
    state = dict(score=torch.linspace(0.2, 3.0, M_STAT))
    err = _mean_estimate("importance", state)
    assert err < 0.05, err
    # negative control: the same skewed selection without the factors
    err_raw = _mean_estimate("importance", state, reweight=False)
    assert err_raw > 0.10, err_raw


def test_similarity_estimator_unbiased():
    smp = sampling.get_sampler("similarity")
    opts = sampling.resolve_opts(smp, {})
    fresh = smp.init_state(opts, M_STAT)
    assert _mean_estimate("similarity", fresh) < 0.03
    trained = dict(fresh, sketch=torch.randn(
        M_STAT, opts["sim_dim"], generator=torch.Generator().manual_seed(3)))
    assert _mean_estimate("similarity", trained) < 0.05


@pytest.mark.parametrize("kw", [
    dict(sampler="importance"),
    dict(sampler="similarity", sim_dim=4),
    dict(sampler="importance", fault="dropout", drop_rate=0.4,
         drop_skew=0.5),
], ids=["importance", "similarity", "importance+dropout"])
def test_rounds_match_reference_with_replayed_draws(world, kw):
    _, tsim, draws = run_parity(world, 2, **FEDNCV, **kw)
    assert "sampler" in tsim._state
    if kw["sampler"] == "importance":
        assert any(d.invp is not None and not np.allclose(d.invp, 1.0)
                   for d in draws)


def test_own_draws_follow_the_state_and_ride_bytes_up(world):
    """The port's own draws: the tables adapt, sampled clients' ages reset,
    and the statistics' bytes (4 a norm, 4 d a sketch) are in bytes_up."""
    def sim(**kw):
        return Simulator(world["ttask"], world["tp"], world["ttrain"],
                         FLConfig.make(**COMMON, **FEDNCV, **kw), seed=0,
                         device="cpu")
    base = sim().run_rounds(1)["bytes_up"][0]
    imp = sim(sampler="importance")
    d_imp = imp.run_rounds(2)
    assert float(d_imp["bytes_up"][0] - base) == 4 * 3
    assert (imp.sampler["score"] != 1.0).any()
    sim_ = sim(sampler="similarity", sim_dim=4)
    d_sim = sim_.run_rounds(2)
    assert float(d_sim["bytes_up"][0] - base) == 4 * 4 * 3
    age = sim_.sampler["age"]
    assert float(torch.sum(sim_.sampler["sketch"] ** 2)) > 0.0
    assert (age == 0).any() and (age <= 2).all()
