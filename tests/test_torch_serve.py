"""`repro_torch.serve` against `repro.serve` on the CPU, small size.

The admission-policy registry and its decisions on the same injected
stats; the client queue's availability, check-ins, waiting line, latencies
and `state_dict` over 20 ticks, bitwise the reference's for `none`,
`markov` and `dropout` at the same seed; the coordinator beside the
reference's coordinator (each driving its own package's simulator) for 3
rounds and the drain at K = 0 and K = 1: the external tables it writes
(idx, both invp, alive), the `faults` state after each round, its queue
and admission metrics and the rows' keys, bitwise.  The round's own numbers are not compared here: each
simulator draws its own microbatch rows (the tracked rounds' parity is
`tests/test_torch_track.py`).  Port only: the refusals, invp == 1 in a
uniform world, a save / restore that resumes the exact served trajectory,
and `examples/port/serve.py --smoke --device cpu` in a subprocess.

The coordinator's world is the reference's `tests/test_serve_coordinator
.py` one: 12 clients with 8 rows of a 3-feature linear regression, cohort
4, K = 2 microbatches of 4.
"""
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import serve as jserve
from repro import track as jtrack
from repro.fed import Simulator as JSimulator, Task as JTask
from repro_torch import serve, track
from repro_torch.fed import FLConfig, Simulator, Task

ROOT = os.path.join(os.path.dirname(__file__), "..")
M, N_MAX, POOL, COHORT = 12, 8, 64, 4
QUEUE_COLS = ("queue_depth", "checkins", "admitted", "rejected",
              "cohort_size", "deadline_miss_frac")


@pytest.fixture(scope="module")
def toy():
    rng = np.random.default_rng(0)
    data = dict(
        images=rng.standard_normal((POOL, 3)).astype(np.float32),
        labels=rng.integers(0, 2, POOL).astype(np.int32),
        client_idx=rng.integers(0, POOL, (M, N_MAX)).astype(np.int32),
        client_sizes=np.full((M,), N_MAX, np.int32))
    jtask = JTask(loss=lambda p, b: jnp.mean(
        (b["images"] @ p["w"] + p["b"] - b["labels"]) ** 2))
    ttask = Task(loss=lambda p, b: torch.mean(
        (b["images"] @ p["w"] + p["b"] - b["labels"]) ** 2))
    return data, jtask, ttask


def _fl_kw(staleness):
    return dict(method="fedncv", n_clients=M, cohort=COHORT, k_micro=2,
                micro_batch=4, server_lr=0.5, local_epochs=1,
                staleness=staleness)


def _coord(toy, staleness=1, policy="token_bucket", seed=0, tracker=None,
           pkg=serve):
    """A coordinator of `pkg` (the port's or the reference's) over its own
    package's simulator."""
    data, jtask, ttask = toy
    fl = pkg.make_serve_config(**_fl_kw(staleness))
    if pkg is serve:
        sim = Simulator(ttask, dict(w=torch.zeros(3), b=torch.zeros(())),
                        data, fl, seed=seed, device="cpu", tracker=tracker)
    else:
        sim = JSimulator(jtask, dict(w=jnp.zeros((3,), jnp.float32),
                                     b=jnp.zeros((), jnp.float32)),
                         data, fl, seed=seed, tracker=tracker)
    queue = pkg.ClientQueue(M, avail="markov", checkin_rate=0.7,
                            lat_mean=0.5, lat_skew=0.5, seed=seed)
    return pkg.Coordinator(sim, queue, policy=policy, deadline_s=1.5)


# ------------------------------ policies --------------------------------------

def test_policy_registry_equals_reference():
    assert serve.registered_policies() == jserve.registered_policies() == \
        ("adaptive", "fixed", "token_bucket")
    for name in serve.registered_policies():
        a, b = serve.get_policy(name), jserve.get_policy(name)
        assert (a.options, a.defaults) == (b.options, b.defaults), name
        opts = serve.resolve_opts(a, None)
        assert a.init(opts) == b.init(opts), name


@pytest.mark.parametrize("call,err", [
    (lambda s: s.get_policy("nope"), KeyError),
    (lambda s: s.resolve_opts(s.get_policy("fixed"), dict(tb_rate=1.0)),
     TypeError),
    (lambda s: s.resolve_opts(s.get_policy("adaptive"),
                              dict(ad_shrink=1.5)), ValueError),
    (lambda s: s.resolve_opts(s.get_policy("adaptive"), dict(ad_grow=0.0)),
     ValueError),
    (lambda s: s.resolve_opts(s.get_policy("adaptive"), dict(ad_min=0)),
     ValueError),
    (lambda s: s.resolve_opts(s.get_policy("token_bucket"),
                              dict(tb_rate=0.0)), ValueError),
    (lambda s: s.register_policy(s.get_policy("fixed")), ValueError),
])
def test_policy_errors_match_reference(call, err):
    for pkg in (jserve, serve):
        with pytest.raises(err):
            call(pkg)


# queue depth and last round seconds of each injected round
STATS = [(10, 0.0), (10, 0.0), (2, 9.0), (7, 1.0), (0, 3.0), (12, 0.5),
         (12, 2.5), (5, 0.0)]


@pytest.mark.parametrize("name,opts", [
    ("fixed", None), ("token_bucket", dict(tb_rate=1.5, tb_burst=3.0)),
    ("adaptive", dict(ad_shrink=0.5, ad_grow=1.0, ad_min=1)),
])
def test_policy_decisions_match_reference(name, opts):
    out = []
    for pkg in (jserve, serve):
        pol = pkg.get_policy(name)
        o = pkg.resolve_opts(pol, opts)
        state, got = pol.init(o), []
        for depth, last in STATS:
            n, state = pol.admit(o, state, dict(
                queue_depth=depth, cohort_max=COHORT, last_round_s=last,
                target_round_s=2.0))
            got.append((n, dict(state)))
        out.append(got)
    assert out[0] == out[1]


# -------------------------------- queue ---------------------------------------

@pytest.mark.parametrize("avail,opts", [
    ("none", None), ("markov", None),
    ("dropout", dict(drop_rate=0.3, drop_skew=0.5)),
])
def test_queue_trace_is_the_reference_bitwise(avail, opts):
    qs = [pkg.ClientQueue(M, avail=avail, avail_opts=opts, checkin_rate=0.6,
                          lat_mean=0.4, lat_skew=0.5, seed=7)
          for pkg in (jserve, serve)]
    assert np.array_equal(qs[0]._mu, qs[1]._mu)
    for t in range(20):
        assert qs[0].tick() == qs[1].tick(), t
        on = [q._on for q in qs]
        assert on[0].dtype == on[1].dtype and np.array_equal(*on), t
        assert qs[0].depth == qs[1].depth
        assert qs[0].admit(3) == qs[1].admit(3), t
        ids = qs[1]._queued[:2] or [0]
        assert np.array_equal(qs[0].latencies(ids), qs[1].latencies(ids))
        assert np.array_equal(qs[0].survival(ids, 1.0),
                              qs[1].survival(ids, 1.0))
        assert json.dumps(qs[0].state_dict()) == \
            json.dumps(qs[1].state_dict()), t
    # a restored port queue goes on with the same trace
    again = serve.ClientQueue(M, avail=avail, avail_opts=opts,
                              checkin_rate=0.6, seed=7)
    again.load_state_dict(json.loads(json.dumps(qs[1].state_dict())))
    for _ in range(3):
        assert again.tick() == qs[1].tick()
        assert again.admit(2) == qs[1].admit(2)


# ------------------------------ coordinator -----------------------------------

def _tables(sim):
    st = sim._get_state()
    return {f"{k}/{f}": np.asarray(st[k][f]) for k in ("sampler", "faults")
            for f in sorted(st[k])}


def _recording(c):
    """Record the tables each of `c`'s rounds is given, as the coordinator
    writes them (the reference's pipelined round later writes a stale copy
    of the fault table back into its state, so the state after a round is
    not what the next round reads)."""
    written = []
    write = c._write_tables

    def recorded(*args):
        write(*args)
        written.append(_tables(c.sim))
    c._write_tables = recorded
    return written


def _faults_after(c):
    """Record the simulator's `faults` state after each of `c`'s rounds
    (the drain's too): under the ring the server section writes back the
    table a round was issued with, K rounds late."""
    after = []
    step = c.step

    def recorded(**kw):
        out = step(**kw)
        st = c.sim._get_state()["faults"]
        after.append({f: np.asarray(st[f]) for f in sorted(st)})
        return out
    c.step = recorded
    return after


@pytest.mark.parametrize("k", [0, 1])
def test_coordinator_tables_and_metrics_match_reference(toy, k):
    """3 rounds and the drain (K zero-admission rounds): each round's
    tables, the `faults` state after it, metrics and streamed row keys
    against the reference's."""
    coords = [_coord(toy, staleness=k, tracker=tpkg.make_tracker("memory"),
                     pkg=spkg)
              for tpkg, spkg in ((jtrack, jserve), (track, serve))]
    written = [_recording(c) for c in coords]
    after = [_faults_after(c) for c in coords]
    outs = [[c.step() for _ in range(3)] + c.drain() for c in coords]
    assert len(outs[1]) == len(outs[0]) == 3 + k
    assert len(written[1]) == len(written[0]) == 3 + k
    for i, (ja, ta) in enumerate(zip(*written)):
        assert set(ja) == set(ta)
        for key, a in ja.items():
            b = ta[key]
            assert a.dtype == b.dtype and np.array_equal(a, b), (i, key)
    assert len(after[1]) == len(after[0]) == 3 + k
    for i, (ja, ta) in enumerate(zip(*after)):
        assert set(ja) == set(ta)
        for key, a in ja.items():
            b = ta[key]
            assert a.dtype == b.dtype and np.array_equal(a, b), (i, key)
    if k:
        # the state after a round holds the table written one round earlier
        assert not all(np.array_equal(after[1][i]["alive"],
                                      written[1][i]["faults/alive"])
                       for i in range(3))
    for i, (jo, to) in enumerate(zip(*outs)):
        assert set(to) == set(jo)
        assert {c: to[c] for c in QUEUE_COLS} == \
            {c: jo[c] for c in QUEUE_COLS}, i
        assert to["live"] == jo["live"] and to["bytes_up"] == jo["bytes_up"]
    jrows, trows = (c.sim.tracker.rows for c in coords)
    assert [r["round"] for r in trows] == [r["round"] for r in jrows] == \
        list(range(1, 4 + k))
    for jr, tr in zip(jrows, trows):
        assert set(tr) == set(jr)
    # at least one round cut a straggler and one admitted a full cohort
    assert any(0.0 in t["faults/alive"] for t in written[1][:3])
    assert any(t["sampler/invp"].all() for t in written[1][:3])


def test_coordinator_rows_carry_the_queue_columns(toy):
    mem = track.MemoryTracker()
    c = _coord(toy, staleness=1, tracker=mem)
    steps = [c.step() for _ in range(3)]
    drained = c.drain()
    assert len(drained) == 1 and drained[0]["admitted"] == 0.0
    assert [r["round"] for r in mem.rows] == [1, 2, 3, 4]
    for row, out in zip(mem.rows, steps + drained):
        assert {q: row[q] for q in QUEUE_COLS} == \
            {q: out[q] for q in QUEUE_COLS}
    assert all(bool(torch.isfinite(v).all()) for v in c.sim.params.values())


def test_coordinator_refusals(toy):
    data, _, ttask = toy
    params = dict(w=torch.zeros(3), b=torch.zeros(()))
    plain = Simulator(ttask, params, data, FLConfig.make(**_fl_kw(0)),
                      seed=0, device="cpu")
    with pytest.raises(ValueError, match="external"):
        serve.Coordinator(plain, serve.ClientQueue(M))
    sim = Simulator(ttask, params, data,
                    serve.make_serve_config(**_fl_kw(0)), seed=0,
                    device="cpu")
    with pytest.raises(ValueError, match="clients"):
        serve.Coordinator(sim, serve.ClientQueue(M + 1))
    fl = serve.make_serve_config(**_fl_kw(0))
    assert (fl.sampler, fl.fault, fl.sampler_opts, fl.fault_opts) == (
        "external", "external", dict(ext_cohort=COHORT),
        dict(ext_slots=COHORT))


def test_uniform_world_admission_invp_is_one(toy):
    c = _coord(toy)
    np.testing.assert_array_equal(c._admission_invp(list(range(COHORT))),
                                  np.ones(COHORT))


def test_save_restore_resumes_the_exact_trajectory(toy, tmp_path):
    a = _coord(toy, seed=3)
    for _ in range(3):
        a.step()
    a.save(str(tmp_path))
    for _ in range(3):
        a.step()
    b = _coord(toy, seed=3)
    b.restore(str(tmp_path))
    for _ in range(3):
        b.step()
    for k, v in a.sim.params.items():
        assert torch.equal(v, b.sim.params[k]), k
    assert a.queue.state_dict() == b.queue.state_dict()
    assert a.pstate == b.pstate and np.array_equal(a._freq, b._freq)
    with pytest.raises(ValueError, match="token_bucket"):
        _coord(toy, policy="fixed").restore(str(tmp_path))


# -------------------------------- the twin ------------------------------------

def test_serve_twin_smoke_on_cpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    path = str(tmp_path / "serve.jsonl")
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "examples", "port", "serve.py"),
         "--smoke", "--device", "cpu", "--tracker", "jsonl", "--track-out",
         path], capture_output=True, text=True, env=env, cwd=str(tmp_path),
        timeout=300)
    assert out.returncode == 0, (out.stdout[-1000:], out.stderr[-2000:])
    assert "SERVE_SMOKE_OK" in out.stdout
    assert "agg_norm=" in out.stdout and "live=" in out.stdout
    rows = [json.loads(x) for x in open(path)]
    assert [r.get("round") for r in rows] == [1, 2, None]
    assert all(set(QUEUE_COLS) <= set(r) for r in rows[:2])
    assert rows[-1]["summary"]["rounds"] == 2
