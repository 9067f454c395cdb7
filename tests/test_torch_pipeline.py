"""The port's pipelined rounds (`staleness = K >= 1`, the depth-K ring of
`repro_torch/fed/simulator.py`) against the reference's
(`src/repro/fed/simulator.py`, `tests/test_serve_coordinator.py`), on the
CPU, at `torch_parity`'s tiny world.

Contracts: round r issues its cohort against the current params and
applies the cohort issued at round r - K; the K warmup bubbles read 0 in
every diagnostic and leave params and state as they were; the ring is
bitwise a hand-unrolled client/server loop at K = 1, 2, 3 (every method,
every aggregator and wire); chunked driving and the draw seam follow one
run bitwise; on the reference's replayed draws the ring lands on the
reference's params and state (rtol 1e-4 / atol 1e-5, alphas rtol 1e-5,
`torch_parity`).
"""
import numpy as np
import pytest
import torch

from repro.fed import FLConfig as JFLConfig
from repro_torch.fed import FLConfig, Simulator
from repro_torch.utils.tree_math import tree_leaves
from torch_parity import (COMMON, FEDNCV, check_diags, check_params_and_state,
                          make_world, ref_draws, sims)

ROUNDS = 6
FEDNCV_LIT = dict(FEDNCV, ncv_beta=1.0)


@pytest.fixture(scope="module")
def world():
    return make_world()


def port_sim(world, method="fedncv", **kw):
    return Simulator(world["ttask"], world["tp"], world["ttrain"],
                     FLConfig.make(method=method, **dict(COMMON, **kw)),
                     seed=0, device="cpu")


def unrolled(sim, n, k, draws=None):
    """The hand-unrolled depth-k pipeline on `sim`'s sections: issue at
    round r, apply at round r + k, oldest first.  Without `draws` each
    round draws from `sim` as its state stands before the round's server
    section."""
    ring = []
    for i in range(n):
        d = sim.draw_round() if draws is None else draws[i]
        pending = sim._client_section_local(sim.params, sim._state, d)
        if len(ring) == k:
            sim.params, sim._state, _ = sim._server_section(
                sim.params, sim._state, ring.pop(0), i + 1)
        ring.append(pending)
    return sim


def assert_same(a, b):
    for k in a.params:
        assert torch.equal(a.params[k], b.params[k]), k
    sa, sb = a._get_state(), b._get_state()
    assert set(sa) == set(sb)
    for name in sa:
        for x, y in zip(tree_leaves(sa[name]), tree_leaves(sb[name])):
            assert torch.equal(x, y), name


# ----------------------------- configuration ---------------------------------

@pytest.mark.parametrize("store", ["device", "host"])
@pytest.mark.parametrize("k", [0, 1, 2, 3])
def test_flconfig_builds_every_depth_under_both_stores(world, k, store):
    kw = dict(n_clients=6, cohort=3, staleness=k, store=store)
    assert JFLConfig.make(**kw).staleness == k
    fl = FLConfig.make(**kw)
    assert (fl.staleness, fl.store) == (k, store)
    sim = Simulator(world["ttask"], world["tp"], world["ttrain"], fl,
                    device="cpu")
    assert sim.pipeline_state() is None


@pytest.mark.parametrize("bad", [-1, 1.5])
def test_bad_staleness_is_refused_as_the_reference_does(bad):
    with pytest.raises(ValueError, match="staleness"):
        JFLConfig.make(n_clients=6, cohort=3, staleness=bad)
    with pytest.raises(ValueError, match="staleness"):
        FLConfig.make(n_clients=6, cohort=3, staleness=bad)


# ----------------------------- against the reference -------------------------

@pytest.mark.parametrize("k", [1, 2])
def test_ring_matches_reference_with_replayed_draws(world, k):
    jsim, tsim = sims(world, "fedncv", staleness=k, **FEDNCV_LIT)
    draws, jdiags = [], []
    for i in range(ROUNDS):
        draws.append(ref_draws(jsim, i))
        jdiags.append(jsim.run_round())
    tdiags = tsim.run_rounds(ROUNDS, draws=draws)
    check_params_and_state(tsim, jsim)
    check_diags(tdiags, jdiags)
    assert np.all(tdiags["agg_norm"][:k] == 0.0)
    assert np.all(tdiags["agg_norm"][k:] > 0.0)


# ----------------------------- against the unrolled loop ---------------------

@pytest.mark.parametrize("k", [1, 2, 3])
def test_ring_is_the_unrolled_loop_bitwise(world, k):
    draws = [port_sim(world, **FEDNCV_LIT).draw_round()
             for _ in range(ROUNDS)]
    sim = port_sim(world, staleness=k, **FEDNCV_LIT)
    sim.run_rounds(ROUNDS, draws=draws)
    ref = unrolled(port_sim(world, **FEDNCV_LIT), ROUNDS, k, draws)
    assert_same(sim, ref)
    assert len(sim.pipeline_state()["ring"]) == k


METHODS = {
    "fedavg": dict(local_epochs=1),
    "fedncv": FEDNCV_LIT,
    "fedprox": dict(local_epochs=1, prox_mu=0.1),
    "scaffold": dict(local_epochs=1),
    "fedncv+": dict(local_epochs=1),
    "fedper": dict(local_epochs=1),
    "fedrep": dict(local_epochs=1, head_local_steps=1),
    "pfedsim": dict(local_epochs=1),
    "fedglomo": dict(local_epochs=1, glomo_beta_local=0.5),
}


@pytest.mark.parametrize("method", list(METHODS))
def test_every_method_rings_as_its_unrolled_loop(world, method):
    kw = METHODS[method]
    sim = port_sim(world, method, staleness=1, **kw)
    sim.run_rounds(3)
    ref = unrolled(port_sim(world, method, **kw), 3, 1)
    assert_same(sim, ref)


WIRES = {
    "trimmed_mean": dict(cohort=5, aggregator="trimmed_mean", trim_frac=0.25,
                         ncv_beta=0.0),
    "median-int8": dict(cohort=5, aggregator="median", codec="int8",
                        ncv_beta=0.0),
    "norm_clip": dict(cohort=5, aggregator="norm_clip", ncv_beta=0.0),
    "int4": dict(codec="int4", ncv_beta=1.0),
    "bf16": dict(codec="bf16", ncv_beta=1.0),
}


@pytest.mark.parametrize("case", list(WIRES))
def test_every_wire_and_aggregator_rings_as_its_unrolled_loop(world, case):
    kw = dict(WIRES[case], local_epochs=1)
    sim = port_sim(world, staleness=2, **kw)
    diags = sim.run_rounds(4)
    ref = unrolled(port_sim(world, **kw), 4, 2)
    assert_same(sim, ref)
    assert np.all(diags["agg_norm"][:2] == 0.0)
    assert np.all(np.isfinite(diags["agg_norm"]))


def test_ring_with_dropout_and_importance_is_its_unrolled_loop(world):
    # a stateful sampler: round r's draw reads the sampler state after
    # round r - 1's server section, in the ring as in the unrolled loop
    kw = dict(FEDNCV_LIT, fault="dropout", drop_rate=0.3,
              sampler="importance")
    sim = port_sim(world, staleness=2, **kw)
    diags = sim.run_rounds(ROUNDS)
    ref = unrolled(port_sim(world, **kw), ROUNDS, 2)
    assert_same(sim, ref)
    assert np.all(diags["live"][:2] == 0.0) and np.any(diags["live"][2:] > 0)
    assert all(np.all(np.isfinite(v)) for v in diags.values())
    assert "invp" in sim.pipeline_state()["ring"][0]


# ----------------------------- bubbles, chunks, the draw seam ----------------

@pytest.mark.parametrize("k", [1, 2, 3])
def test_bubbles_zero_every_diagnostic_and_change_nothing(world, k):
    kw = dict(FEDNCV_LIT, fault="dropout", drop_rate=0.3)
    sync = port_sim(world, **kw).run_rounds(1)
    sim = port_sim(world, staleness=k, **kw)
    p0 = {n: v.clone() for n, v in sim.params.items()}
    a0 = sim.alphas.clone()
    diags = sim.run_rounds(k)
    assert set(diags) == set(sync) >= {"agg_norm", "bytes_up", "live"}
    assert all(np.all(v == 0.0) for v in diags.values())
    assert all(torch.equal(p0[n], sim.params[n]) for n in p0)
    assert torch.equal(a0, sim.alphas)
    more = sim.run_rounds(2)
    assert np.all(more["bytes_up"] > 0.0) and np.all(more["agg_norm"] > 0.0)


@pytest.mark.parametrize("k", [1, 3])
def test_chunked_driving_follows_one_run(world, k):
    one = port_sim(world, staleness=k, **FEDNCV_LIT)
    d1 = one.run_rounds(ROUNDS)
    chunked = port_sim(world, staleness=k, **FEDNCV_LIT)
    d2 = [chunked.run_rounds(2) for _ in range(3)]
    assert_same(one, chunked)
    for key in d1:
        assert np.array_equal(d1[key], np.concatenate([d[key] for d in d2]))


def test_draw_seam_replays_under_the_ring(world):
    own = port_sim(world, staleness=2, **FEDNCV_LIT)
    draws = []
    for _ in range(4):
        d = own.draw_round()
        draws.append(d)
        own.run_round(draws=d)
    again = port_sim(world, staleness=2, **FEDNCV_LIT)
    again.run_rounds(4, draws=draws)
    assert_same(own, again)
