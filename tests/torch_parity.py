"""Shared pieces of the sampler and fault parity tests (not a test module).

The port replays the reference's draws through its draw-injection seam.
For 0-based round i the reference draws with `key = fold_in(PRNGKey(seed),
i)`, `kd, kk = split(key)`: the cohort and its HT factors and the rows
from `_draw_cohort_sel(state, kd)`, the fault plan and the stepped fault
state from `_fault_plan(state, key, ...)`, and the int8 / int4 rounding
uniforms per cohort slot from `kk` (`ref_draws`).

Tolerances are those of `tests/test_torch_simulator.py`: params and every
state field (sampler and fault state among them) rtol 1e-4 / atol 1e-5,
alphas rtol 1e-5, agg_norm rtol 1e-4, bytes_up and live equal.
"""
import jax
import numpy as np
import torch

from repro.data import federated_splits as j_splits
from repro.fed import FLConfig as JFLConfig, Simulator as JSimulator
from repro.fed import Task as JTask
from repro.models import lenet as jlenet
from repro_torch.data import federated_splits as t_splits
from repro_torch.fed import Draws, FLConfig, Simulator, Task
from repro_torch.models import lenet as tlenet
from repro_torch.weights import params_from_jax

SEED = 0
COMMON = dict(n_clients=6, cohort=3, k_micro=3, micro_batch=4, server_lr=0.5,
              local_lr=0.05)
FEDNCV = dict(local_epochs=2, ncv_alpha0=0.3, ncv_alpha_lr=1e-2,
              ncv_beta=0.0)


def make_world(port_init=False):
    """The two packages' data, tasks and LeNet-5 params at the small size.
    `port_init`: draw the params with the port's init (the reference's
    eager init compiles for seconds a shape); both packages start from the
    same values either way."""
    _, train, test = j_splits("cifar10", n_clients=6, alpha=0.1, seed=SEED,
                              scale=0.02)
    _, ttrain, _ = t_splits("cifar10", n_clients=6, alpha=0.1, seed=SEED,
                            scale=0.02)
    jcfg, tcfg = jlenet.LeNetConfig(), tlenet.LeNetConfig()
    jtask = JTask(loss=lambda p, b: jlenet.loss_fn(jcfg, p, b),
                  accuracy=lambda p, b: jlenet.accuracy(jcfg, p, b),
                  head_keys=jlenet.HEAD_KEYS)
    ttask = Task(loss=lambda p, b: tlenet.loss_fn(tcfg, p, b),
                 accuracy=lambda p, b: tlenet.accuracy(tcfg, p, b),
                 head_keys=tlenet.HEAD_KEYS)
    if port_init:
        tp = tlenet.init(tcfg, torch.Generator().manual_seed(SEED))
        jp = {k: jax.numpy.asarray(v.numpy()) for k, v in tp.items()}
    else:
        jp = jlenet.init(jcfg, jax.random.PRNGKey(SEED))
        tp = params_from_jax(jax.tree.map(np.asarray, jp))
    return dict(train=train, ttrain=ttrain, jtask=jtask, ttask=ttask, jp=jp,
                tp=tp)


def sims(world, method="fedncv", **kw):
    """The reference's and the port's simulator of one configuration."""
    kw = dict(COMMON, **kw)
    jsim = JSimulator(world["jtask"], world["jp"], world["train"],
                      JFLConfig.make(method=method, **kw), seed=SEED)
    tsim = Simulator(world["ttask"], world["tp"], world["ttrain"],
                     FLConfig.make(method=method, **kw), seed=SEED,
                     device="cpu")
    return jsim, tsim


def _np(tree):
    return None if tree is None else jax.tree.map(np.asarray, tree)


def ref_draws(jsim, i):
    """The reference's draws of 0-based round i, as a port `Draws`."""
    key = jax.random.fold_in(jax.random.PRNGKey(SEED), i)
    kd, kk = jax.random.split(key)
    state = jsim._get_state()
    idx, sel, _, weights, invp = jsim._draw_cohort_sel(state, kd)
    plan, fstate, *_ = jsim._fault_plan(state, key, idx, weights, invp)
    codec = jsim.codec
    u = None
    if codec.name in ("int8", "int4"):
        u = np.stack([np.asarray(jax.random.uniform(
            jax.random.split(jax.random.fold_in(kk, s))[1],
            (codec.n_chunks, codec.chunk))) for s in range(jsim.fl.cohort)])
    stepped = fstate if jsim.fm.step is not None else None
    return Draws(np.asarray(idx), np.asarray(sel), u, _np(invp), _np(plan),
                 _np(stepped))


def flat(tree, path=""):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in flat(tree[k],
                                                      f"{path}/{k}")]
    return [(path, tree)]


def get(tree, path):
    for k in path.split("/")[1:]:
        tree = tree[k]
    return tree


def check_params_and_state(tsim, jsim):
    """Params and every state field of the port against the reference's."""
    for k, v in jsim.params.items():
        np.testing.assert_allclose(tsim.params[k].numpy(), np.asarray(v),
                                   rtol=1e-4, atol=1e-5, err_msg=k)
    jstate = jsim._get_state()
    assert set(tsim._state) == set(jstate)
    for name, jv in jstate.items():
        tol = dict(rtol=1e-5) if name == "alphas" else dict(rtol=1e-4,
                                                             atol=1e-5)
        for path, leaf in flat(jv):
            np.testing.assert_allclose(
                get(tsim._state[name], path).numpy(), np.asarray(leaf),
                err_msg=name + path, **tol)


def check_diags(tdiags, jdiags):
    np.testing.assert_allclose(tdiags["agg_norm"],
                               [d["agg_norm"] for d in jdiags], rtol=1e-4)
    assert set(tdiags) == set(jdiags[0])
    for k in set(tdiags) - {"agg_norm"}:
        np.testing.assert_array_equal(
            tdiags[k], np.float32([d[k] for d in jdiags]), err_msg=k)


def run_parity(world, rounds, method="fedncv", **kw):
    """`rounds` rounds of the reference, the port replaying its draws;
    params, every state field and the diagnostics compared after the last.
    Returns (jsim, tsim, the port's draws)."""
    jsim, tsim = sims(world, method, **kw)
    draws, jdiags = [], []
    for i in range(rounds):
        draws.append(ref_draws(jsim, i))
        jdiags.append(jsim.run_round())
    tdiags = tsim.run_rounds(rounds, draws=draws)
    check_params_and_state(tsim, jsim)
    check_diags(tdiags, jdiags)
    return jsim, tsim, draws


def to_torch(tree):
    return {k: to_torch(v) if isinstance(v, dict)
            else torch.from_numpy(np.array(v)) for k, v in tree.items()}
