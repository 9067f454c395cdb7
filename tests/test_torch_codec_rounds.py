"""Rounds over the port's stateful codecs (`topk`, `lowrank`) with their
per-client error feedback (`sim.ef`), on the CPU, at the small size of
`tests/test_torch_simulator.py` (6 clients, cohort 3, scale 0.02).

Against the reference (`src/repro/`), on its replayed draws
(`torch_parity.ref_draws`): both wires part the two runs at
discontinuities, topk where two magnitudes at the k-th place lie within
the frameworks' convolution difference (about 1e-7) of each other, so
that another coordinate ships; lowrank where the power iteration turns a
basis inside a nearly degenerate pair of singular values.  So each round
starts the port from the reference's params and state (its error
feedback included), as `test_quantized_rounds_match_reference` does for
the stochastic wire, and holds:
  the client section — the decoded uploads at rtol 1e-4 / atol 1e-5, with
          at most 1e-3 of the values off (a swapped topk selection); the
          new error feedback likewise (topk), or (lowrank) exactly 0 on
          the dense leaves, and on each factored matrix its residual
          X - U V^T and its bases V within atol 1e-5 + rtol 1e-4 of the
          matrix's largest |X| and the factor's largest |V|: an error in
          the subspace the iteration finds moves every entry of U V^T by
          an amount that scales with the matrix, not with the entry (the
          decoded product is held entry by entry above);
  the server section, given the reference's wire and error feedback —
          params and every state field (ef too) rtol 1e-4 / atol 1e-5,
          alphas rtol 1e-5, agg_norm rtol 1e-4, bytes_up and live equal.
Within the port, bitwise: run_round against run_rounds, a resumed
checkpoint against the uninterrupted run, the host store against the
device store, the depth-1 ring against the hand-unrolled loop, and a
dropped client's error feedback left as it was.
"""
import functools
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import comm as jcomm
from repro.checkpoint import ckpt as jckpt
from repro_torch.checkpoint import ckpt
from repro_torch.fed import Draws, FLConfig, Simulator
from repro_torch.models import lenet as tlenet
from repro_torch.utils.tree_math import tree_leaves, tree_map
from repro_torch.weights import params_from_jax
from torch_parity import (COMMON, FEDNCV, SEED, check_params_and_state,
                          make_world, ref_draws, sims)

ROOT = pathlib.Path(__file__).resolve().parents[1]
OFF_SHARE = 1e-3
CODECS = {"topk": dict(codec="topk", ratio=0.25),
          "lowrank": dict(codec="lowrank", rank=4)}


@pytest.fixture(scope="module")
def world():
    return make_world(port_init=True)


def port_sim(world, method="fedncv", **kw):
    return Simulator(world["ttask"], world["tp"], world["ttrain"],
                     FLConfig.make(method=method, **dict(COMMON, **kw)),
                     seed=0, device="cpu")


def _t(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


@functools.lru_cache(maxsize=None)
def _ref_decoder(codec):
    return jax.jit(jax.vmap(codec.decode))


def _ref_decode(codec, wire):
    return np.asarray(_ref_decoder(codec)(wire))


def _off(got, want, tol):
    return int(np.count_nonzero(np.abs(got - want) > tol))


def _check_client(tcodec, jcodec, pending, jpending):
    """The port's client section against the reference's (module
    docstring)."""
    tw, jw = pending["grads"], jpending["grads"]
    assert set(tw) == set(jw)
    for k in tw:
        assert str(tw[k].dtype).split(".")[-1] == str(jw[k].dtype), k
    got, want = tcodec.decode(tw).numpy(), _ref_decode(jcodec, jw)
    assert _off(got, want, 1e-5 + 1e-4 * np.abs(want)) <= \
        OFF_SHARE * want.size
    tef, jef = pending["cstates"]["ef"], jpending["cstates"]["ef"]
    if tcodec.name == "topk":
        jr = np.asarray(jef)
        assert _off(tef.numpy(), jr, 1e-5 + 1e-4 * np.abs(jr)) <= \
            OFF_SHARE * jr.size
        return
    jr, jv = np.asarray(jef["r"]), np.asarray(jef["v"])
    x = jr + want                          # the encode's input X
    mats, rest = tcodec._plan
    for off, sz in rest:                   # dense segments: exactly 0
        assert not tef["r"][:, off:off + sz].any() and \
            not jr[:, off:off + sz].any()
    for off, p, q, _, v_off in mats:
        m = slice(off, off + p * q)
        vb = slice(v_off, v_off + q * tcodec.rank)
        _within_block(tef["r"].numpy()[:, m], jr[:, m], x[:, m])
        _within_block(tef["v"].numpy()[:, vb], jv[:, vb], jv[:, vb])


def _within_block(got, want, scale):
    """|got - want| <= 1e-5 + 1e-4 max|scale|, the max per client."""
    top = np.abs(scale).max(axis=1, keepdims=True)
    np.testing.assert_array_less(np.abs(got - want), np.broadcast_to(
        1e-5 + 1e-4 * top, got.shape))


def round_by_round(world, rounds, **kw):
    """`rounds` rounds of fedncv (beta = 0), each from the reference's
    state, on its draws (module docstring)."""
    jsim, tsim = sims(world, "fedncv", **dict(FEDNCV, **kw))
    jclient = jax.jit(jsim._client_section_local)
    jserver = jax.jit(jsim._server_section)
    for i in range(rounds):
        tsim.params = params_from_jax(jax.tree.map(np.asarray, jsim.params))
        tsim._set_state(_t(jsim._get_state()))
        draws = ref_draws(jsim, i)
        key = jax.random.fold_in(jax.random.PRNGKey(SEED), i)
        jstate = jsim._get_state()
        jpending = jclient(jsim.params, jstate, key)
        jsim.params, jstate, jdiag = jserver(jsim.params, jstate, jpending,
                                             jnp.int32(i + 1))
        jsim._set_state(jstate)
        pending = tsim._client_section_local(tsim.params, tsim._state,
                                             draws)
        _check_client(tsim.codec, jsim.codec, pending, jpending)
        pending["grads"] = _t(jpending["grads"])
        pending["cstates"]["ef"] = _t(jpending["cstates"]["ef"])
        tsim.params, tsim._state, tdiag = tsim._server_section(
            tsim.params, tsim._state, pending, i + 1)
        check_params_and_state(tsim, jsim)
        np.testing.assert_allclose(float(tdiag["agg_norm"]),
                                   float(jdiag["agg_norm"]), rtol=1e-4)
        for k in ("bytes_up", "live"):
            if k in jdiag:
                assert float(tdiag[k]) == float(jdiag[k]), k
    return jsim, tsim


# ----------------------------------------------------------------------------
# against the reference
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("codec", list(CODECS))
def test_codec_rounds_match_reference(world, codec):
    jsim, tsim = round_by_round(world, 2, **CODECS[codec])
    assert tsim.codec.bytes_per_client() == jsim.codec.bytes_per_client()


@pytest.mark.parametrize("codec", list(CODECS))
def test_simulator_wire_bytes_and_state(world, codec):
    """The reference's `test_simulator_wire_bytes_and_state`: fewer bytes
    than the f32 wire, exactly cohort x the reference's bytes_per_client
    plus FedNCV's aux; topk ships uint16 indices and leaves non-zero
    error feedback (lowrank: residuals and moved bases)."""
    opts = {k: v for k, v in CODECS[codec].items() if k != "codec"}
    sim = port_sim(world, codec=codec, **FEDNCV, **opts)
    jc = jcomm.get_codec(codec, n=sim._grad_spec.n, spec=sim._grad_spec,
                         **opts)
    f32_bytes = 4 * sim._grad_spec.n * sim.fl.cohort
    aux_bytes = 16 * sim.fl.cohort          # fedncv uploads 4 f32 scalars
    v0 = sim.ef["v"].clone() if codec == "lowrank" else None
    diag = sim.run_round()
    assert diag["bytes_up"] < f32_bytes
    assert diag["bytes_up"] == sim.fl.cohort * jc.bytes_per_client() + \
        aux_bytes
    if codec == "topk":
        assert sim.codec.index_dtype == torch.uint16
        assert float(torch.sum(torch.abs(sim.ef))) > 0.0
        assert tuple(sim.ef.shape) == (sim.fl.n_clients, sim._grad_spec.n)
    else:
        assert float(torch.sum(torch.abs(sim.ef["r"]))) > 0.0
        assert not torch.equal(sim.ef["v"], v0)


def test_reference_checkpoint_with_ef_restores_into_the_port(world,
                                                             tmp_path):
    """The error feedback is written under the reference's keys
    (state/ef/r, state/ef/v): a reference checkpoint restores into the
    port bitwise, and a port checkpoint into the reference."""
    jsim, tsim = sims(world, "fedncv", **dict(FEDNCV, **CODECS["lowrank"]))
    jckpt.save_sim(str(tmp_path / "j"), jsim)
    ckpt.restore_sim(str(tmp_path / "j"), tsim)
    for k in ("r", "v"):
        assert np.array_equal(tsim.ef[k].numpy(), np.asarray(jsim.ef[k]))
    tsim.run_round(draws=ref_draws(jsim, 0))
    ckpt.save_sim(str(tmp_path / "t"), tsim)
    payload = ckpt._read_payload(ckpt._step_path(str(tmp_path / "t"), None))
    assert {"state/ef/r", "state/ef/v"} <= set(payload)
    jckpt.restore_sim(str(tmp_path / "t"), jsim)
    for k in ("r", "v"):
        assert np.array_equal(np.asarray(jsim.ef[k]), tsim.ef[k].numpy())


# ----------------------------------------------------------------------------
# within the port: bitwise
# ----------------------------------------------------------------------------

def assert_same(a, b):
    for k in a.params:
        assert torch.equal(a.params[k], b.params[k]), k
    sa, sb = a._get_state(), b._get_state()
    assert set(sa) == set(sb) and "ef" in sa
    for name in sa:
        la, lb = tree_leaves(sa[name]), tree_leaves(sb[name])
        assert len(la) == len(lb)
        for x, y in zip(la, lb):
            assert torch.equal(x, y), name


@pytest.mark.parametrize("codec", list(CODECS))
def test_run_round_and_checkpoint_resume(world, tmp_path, codec):
    """The reference's run_rounds-vs-run_round and EF checkpoint tests in
    one: a run driven by run_round, checkpointed after round 1, and a
    fresh simulator restored from it and driven by run_rounds(2) end on
    the same bits, error feedback included; another codec's simulator
    refuses the checkpoint."""
    kw = dict(FEDNCV, **CODECS[codec])
    a = port_sim(world, **kw)
    a.run_round()
    ckpt.save_sim(str(tmp_path), a)
    rows_a = [a.run_round() for _ in range(2)]
    b = port_sim(world, **kw)
    meta = ckpt.restore_sim(str(tmp_path), b)
    assert meta["round_idx"] == b.round_idx == 1
    rows_b = b.run_rounds(2)
    assert_same(a, b)
    assert all(np.array_equal(np.float32([r[k] for r in rows_a]), rows_b[k])
               for k in rows_b)
    with pytest.raises(ValueError, match="codec"):
        other = "lowrank" if codec == "topk" else "topk"
        ckpt.restore_sim(str(tmp_path), port_sim(
            world, **dict(FEDNCV, **CODECS[other])))


@pytest.mark.parametrize("case", ["topk", "lowrank-dropout", "topk-k1"])
def test_host_store_matches_device_store(world, case):
    """The reference's test_host_matches_device_stateful_codec (topk at
    ratio 0.25), and lowrank under dropout, and the ring: every round's
    diagnostics, params and state bitwise; the host table `ef` holds the
    device store's."""
    kw = dict(FEDNCV, **CODECS[case.split("-")[0]])
    rounds = 2
    if case.endswith("k1"):
        kw.update(staleness=1)
        rounds = 3
    if case.endswith("dropout"):
        kw.update(fault="dropout", drop_rate=0.5)
    d = port_sim(world, **kw)
    h = port_sim(world, store="host", **kw)
    assert "ef" in h._host_state_names and "ef" not in h._state
    assert h.host_state_bytes() >= sum(
        x.numel() * 4 for x in tree_leaves(d.ef))
    dd, dh = d.run_rounds(rounds), h.run_rounds(rounds)
    assert all(np.array_equal(dd[k], dh[k]) for k in dd)
    assert_same(d, h)
    h.close()


@pytest.mark.parametrize("store", ["device", "host"])
def test_dropped_clients_keep_their_error_feedback(world, store):
    """A dropped client never reported: its error-feedback rows (residual
    and, under lowrank, bases) are the ones it had before the round;
    every live client's changed."""
    for codec in CODECS:
        sim = port_sim(world, store=store, fault="dropout", drop_rate=0.5,
                       **dict(FEDNCV, **CODECS[codec]))
        seen = set()
        for _ in range(2):
            d = sim.draw_round()
            before = tree_map(lambda t: t.clone(), sim.ef)
            sim.run_round(draws=d)
            alive = d.plan["alive"]
            for slot, u in enumerate(d.idx.tolist()):
                same = all(torch.equal(x[u], y[u]) for x, y in zip(
                    tree_leaves(before), tree_leaves(sim.ef)))
                assert same == (float(alive[slot]) == 0.0), (u, slot)
                seen.add(float(alive[slot]))
        assert seen == {0.0, 1.0}
        sim.close()


def unrolled(sim, n, k, draws=None):
    """The hand-unrolled depth-k pipeline on `sim`'s sections."""
    ring = []
    for i in range(n):
        d = sim.draw_round() if draws is None else draws[i]
        pending = sim._client_section_local(sim.params, sim._state, d)
        if len(ring) == k:
            sim.params, sim._state, _ = sim._server_section(
                sim.params, sim._state, ring.pop(0), i + 1)
        ring.append(pending)
    return sim


@pytest.mark.parametrize("codec", list(CODECS))
def test_ring_k1_is_the_unrolled_loop(world, codec):
    """Depth 1: the error feedback a cohort wrote lands one round late,
    as the hand-unrolled loop writes it; the in-flight pending carries the
    cohort's new error feedback and counts in the template."""
    kw = dict(FEDNCV, **CODECS[codec])
    ring = port_sim(world, staleness=1, **kw)
    ring.run_rounds(3)
    ref = unrolled(port_sim(world, **kw), 3, 1)
    assert_same(ring, ref)
    tmpl = ring.pipeline_template()
    assert "ef" in tmpl["ring"][0]["cstates"]
    state = ring.pipeline_state()
    assert all(torch.equal(x, y) for x, y in zip(
        tree_leaves(state["ring"][0]["cstates"]["ef"]),
        tree_leaves(ring._ring[0]["cstates"]["ef"])))


# ----------------------------------------------------------------------------
# the quickstart twin's fourth run
# ----------------------------------------------------------------------------

QS_ROUNDS = 2


def test_quickstart_topk_run():
    """`examples/port/quickstart.py`'s fourth run, fedncv over topk (ratio
    0.16), 2 rounds through the twin's `run` on its own draws: each
    round's wire and error feedback are bitwise the reference's encode of
    the same input x = upload + residual (decode + new residual == x);
    clients outside the cohort keep their rows; bytes_up is the
    reference's accounting (6 x (59,526 + 16) at N = 62,006)."""
    spec = importlib.util.spec_from_file_location(
        "port_quickstart", ROOT / "examples" / "port" / "quickstart.py")
    qs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(qs)
    assert qs.RUNS[-1] == ("fedncv", "topk")
    fl = qs.make_config("fedncv", "topk")
    assert fl.codec_opts == {"ratio": 0.16}
    record = []

    class Recording(qs.Simulator):
        def _client_section_local(self, params, state, draws):
            pending = super()._client_section_local(params, state, draws)
            record.append((Draws(*draws).idx, state["ef"].clone(), pending))
            return pending

    qs.Simulator = Recording
    train, _, task, cfg = qs.make_world()
    params = tlenet.init(cfg, torch.Generator().manual_seed(0))
    sim, diags = qs.run(fl, task, params, train, rounds=QS_ROUNDS,
                        device="cpu")
    jc = jcomm.get_codec("topk", n=sim.codec.n, ratio=0.16)
    assert jc.bytes_per_client() == sim.codec.bytes_per_client() == 59526
    np.testing.assert_array_equal(diags["bytes_up"],
                                  np.float32([6 * (59526 + 16)] * QS_ROUNDS))
    jencode = jax.jit(jax.vmap(lambda v: jc.encode(v)))
    for idx, ef_before, pending in record:
        wire, ef = pending["grads"], pending["cstates"]["ef"]
        x = sim.codec.decode(wire) + ef
        jwire, jef = jencode(jnp.asarray(x.numpy()))
        assert wire["i"].dtype == torch.uint16
        np.testing.assert_array_equal(wire["i"].numpy(), np.asarray(jwire["i"]))
        np.testing.assert_array_equal(wire["v"].numpy(), np.asarray(jwire["v"]))
        np.testing.assert_array_equal(ef.numpy(), np.asarray(jef))
    out = np.ones(sim.fl.n_clients, bool)
    for idx, _, _ in record:
        out[idx.numpy()] = False
    assert not sim.ef[torch.from_numpy(out)].any()
    assert all(bool(torch.isfinite(v).all()) for v in sim.params.values())
