"""`examples/port/quickstart.py` against the reference's quickstart, on the
CPU: its fedavg and fedncv runs, 15 rounds each through the twin's `run`
function, from the reference's initial params, replaying the reference
Simulator's draws through `draws`.

The 15 rounds are not compared end to end: in LeNet's max-pool a window
whose two largest inputs lie within the frameworks' convolution
difference (about 1e-7) routes that window's gradient to the other input
on the other side, moving a few conv1 weights by about 1e-5; within a
client's local SGD the later steps carry that into its conv1 and conv2,
and across rounds the two runs part chaotically (on these draws from
round 5 on: 2e-4 by round 15, against an atol of 1e-5).  So, as
`tests/test_torch_simulator.py::test_quantized_rounds_match_reference`
does for the stochastic wire, each
of the port's rounds is held to the reference's two round sections run
from the port's own state before that round, with the same draws:
  uploads   off rtol 1e-4 / atol 1e-5 in at most 1e-2 of the values, the
            allowance `chip_smoke.py` gives the same discontinuity (one
            client's pass in a round moved by a near-tie leaves 0.26% of
            the round's values off), and FedNCV's S1, S2 at rtol 1e-4 for
            every client whose upload is within the tolerance;
  params and alphas after the round: the reference's server section,
            given the port's uploads, within rtol 1e-4 / atol 1e-5 of the
            port's (alphas rtol 1e-5);
  agg_norm  rtol 1e-4; bytes_up equal.
"""
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import federated_splits as j_splits
from repro.fed import FLConfig as JFLConfig, Simulator as JSimulator
from repro.fed import Task as JTask
from repro.models import lenet as jlenet
from repro_torch.utils.tree_math import ravel_stack, tree_map
from repro_torch.weights import params_from_jax

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def qs():
    spec = importlib.util.spec_from_file_location(
        "port_quickstart", ROOT / "examples" / "port" / "quickstart.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _np(tree):
    return tree_map(lambda x: np.array(x.detach().cpu()), tree)


@pytest.mark.parametrize("method", ["fedavg", "fedncv"])
def test_quickstart_rounds_match_reference(qs, method, monkeypatch):
    spec, train, _ = j_splits("cifar10", n_clients=12, alpha=0.1, seed=0,
                              scale=0.15, noise=1.2, class_sep=0.8)
    jcfg = jlenet.LeNetConfig(n_classes=spec.n_classes,
                              image_size=spec.image_size,
                              channels=spec.channels)
    jtask = JTask(loss=lambda p, b: jlenet.loss_fn(jcfg, p, b),
                  accuracy=lambda p, b: jlenet.accuracy(jcfg, p, b),
                  head_keys=jlenet.HEAD_KEYS)
    jp = jlenet.init(jcfg, jax.random.PRNGKey(0))
    ncv_kw = dict(ncv_alpha0=0.3, ncv_alpha_lr=1e-5, ncv_beta=0.0) \
        if method == "fedncv" else {}
    jsim = JSimulator(jtask, jp, train, JFLConfig.make(
        method=method, n_clients=12, cohort=6, k_micro=4, micro_batch=16,
        server_lr=0.5, local_lr=0.05, local_epochs=2, **ncv_kw), seed=0)
    keys = [jax.random.fold_in(jax.random.PRNGKey(0), i)
            for i in range(qs.ROUNDS)]
    # the uniform draw does not read the state
    draws = []
    for key in keys:
        idx, sel, *_ = jsim._draw_cohort_sel(jsim._get_state(),
                                             jax.random.split(key)[0])
        draws.append((np.asarray(idx), np.asarray(sel)))

    class Recording(qs.Simulator):
        """Keeps each round's starting params and state (as numpy) and its
        client section's output."""
        record = []

        def _client_section_local(self, params, state, draws):
            pending = super()._client_section_local(params, state, draws)
            self.record.append((_np(params), _np(state), pending))
            return pending

    monkeypatch.setattr(qs, "Simulator", Recording)
    ttrain, _, task, _ = qs.make_world()
    sim, diags = qs.run(qs.make_config(method, "identity"), task,
                        params_from_jax(jax.tree.map(np.asarray, jp)),
                        ttrain, device="cpu", draws=draws)
    assert len(sim.record) == qs.ROUNDS

    jclient = jax.jit(jsim._client_section_local)
    jserver = jax.jit(jsim._server_section)
    after = [r[:2] for r in sim.record[1:]] + [(_np(sim.params),
                                                 _np(sim._state))]
    for i, (params, state, pending) in enumerate(sim.record):
        jparams = jax.tree.map(jnp.asarray, params)
        jstate = jax.tree.map(jnp.asarray, state)
        jpending = jclient(jparams, jstate, keys[i])
        np.testing.assert_array_equal(np.asarray(jpending["idx"]),
                                      draws[i][0])
        got = ravel_stack(pending["grads"])[0].numpy()
        want = np.concatenate([np.asarray(x).reshape(6, -1) for x in
                               jax.tree.leaves(jpending["grads"])], axis=1)
        off = np.abs(got - want) > 1e-5 + 1e-4 * np.abs(want)
        assert off.sum() <= 1e-2 * off.size, (i, int(off.sum()))
        held = ~off.any(axis=1)          # the clients no near-tie moved
        for k in pending["aux"]:
            np.testing.assert_allclose(pending["aux"][k].numpy()[held],
                                       np.asarray(jpending["aux"][k])[held],
                                       rtol=1e-4, err_msg=k)
        jpending["grads"] = jax.tree.map(jnp.asarray,
                                         _np(pending["grads"]))
        jparams, jstate, jdiag = jserver(jparams, jstate, jpending,
                                         jnp.int32(i + 1))
        for k, v in jparams.items():
            np.testing.assert_allclose(after[i][0][k], np.asarray(v),
                                       rtol=1e-4, atol=1e-5,
                                       err_msg=f"round {i + 1} {k}")
        if method == "fedncv":
            np.testing.assert_allclose(after[i][1]["alphas"],
                                       np.asarray(jstate["alphas"]),
                                       rtol=1e-5)
        np.testing.assert_allclose(diags["agg_norm"][i],
                                   float(jdiag["agg_norm"]), rtol=1e-4)
        assert diags["bytes_up"][i] == float(jdiag["bytes_up"])
    assert all(bool(torch.isfinite(v).all()) for v in sim.params.values())
