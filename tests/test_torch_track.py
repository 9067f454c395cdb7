"""`repro_torch.track` against `repro.track` on the CPU, small size.

The registry (names, options, defaults, error types), the sinks (the same
rows give the reference's bytes), the emitter's host enrichment, and
tracked rounds: the port replays the reference's draws
(`tests/torch_parity.py`) for 3 rounds of FedNCV at K = 1 with
`track_variance` and byzantine clients, so one run holds the bubble's zero
row, `gvar_proxy`, `corrupt_frac` and the larger `bytes_up` to the
reference's rows (rtol 1e-4, atol 1e-5; accounting keys equal).  Port
only: a tracked run is bitwise an untracked one, under both stores; a
checkpoint restore truncates the jsonl and keeps `bytes_up_cum`
continuous, and `tools/flwatch.py --check` accepts the file.

The world is the reference's `tests/test_track.py` one: mnist stand-in at
scale 0.1, 6 clients, cohort 3, K = 3 microbatches of 4.
"""
import io
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import track as jtrack
from repro.data import federated_splits as j_splits
from repro.fed import FLConfig as JFLConfig, Simulator as JSimulator
from repro.fed import Task as JTask
from repro.models import lenet as jlenet
from repro_torch import track
from repro_torch.checkpoint import restore_sim, save_sim
from repro_torch.data import federated_splits as t_splits
from repro_torch.fed import FLConfig, Simulator, Task
from repro_torch.models import lenet as tlenet
from torch_parity import check_params_and_state, ref_draws

ROOT = os.path.join(os.path.dirname(__file__), "..")
# the emitter's host-side keys
HOST_KEYS = ("sec_per_round", "bytes_up_cum")
TRACKED = dict(method="fedncv", n_clients=6, cohort=3, k_micro=3,
               micro_batch=4, server_lr=0.5, ncv_beta=0.0, local_epochs=1,
               fault="byzantine",
               fault_opts=dict(byz_frac=0.7, byz_scale=10.0))
ROUNDS = 3


@pytest.fixture(scope="module")
def world():
    spec, train, _ = j_splits("mnist", n_clients=6, alpha=0.5, seed=0,
                              scale=0.1)
    _, ttrain, _ = t_splits("mnist", n_clients=6, alpha=0.5, seed=0,
                            scale=0.1)
    shape = dict(n_classes=spec.n_classes, image_size=spec.image_size,
                 channels=spec.channels)
    jcfg, tcfg = jlenet.LeNetConfig(**shape), tlenet.LeNetConfig(**shape)
    tp = tlenet.init(tcfg, torch.Generator().manual_seed(0))
    return dict(
        train=train, ttrain=ttrain, tp=tp,
        jp={k: jnp.asarray(v.numpy()) for k, v in tp.items()},
        jtask=JTask(loss=lambda p, b: jlenet.loss_fn(jcfg, p, b),
                    accuracy=lambda p, b: jlenet.accuracy(jcfg, p, b),
                    head_keys=jlenet.HEAD_KEYS),
        ttask=Task(loss=lambda p, b: tlenet.loss_fn(tcfg, p, b),
                   accuracy=lambda p, b: tlenet.accuracy(tcfg, p, b),
                   head_keys=tlenet.HEAD_KEYS))


def _sim(world, tracker_obj=None, **kw):
    fl = FLConfig.make(**dict(TRACKED, **kw))
    return Simulator(world["ttask"], world["tp"], world["ttrain"], fl,
                     seed=0, device="cpu", tracker=tracker_obj)


# ----------------------------- registry --------------------------------------

def test_registry_equals_reference():
    assert track.registered_trackers() == jtrack.registered_trackers()
    for name in track.registered_trackers():
        a, b = track.get_tracker(name), jtrack.get_tracker(name)
        assert (a.options, a.defaults) == (b.options, b.defaults), name
    assert track.PHASES == jtrack.PHASES
    assert track.GNORM_KEY == jtrack.GNORM_KEY


@pytest.mark.parametrize("call,err,match", [
    (lambda t: t.get_tracker("nope"), KeyError, "unknown tracker"),
    (lambda t: t.make_tracker("stdout", path="x"), TypeError,
     "not used by tracker"),
    (lambda t: t.make_tracker("stdout", every=0), ValueError, "every"),
    (lambda t: t.make_tracker("stdout", interval=-1.0), ValueError,
     "interval"),
    (lambda t: t.make_tracker("composite", children=[42]), TypeError,
     "composite children"),
    (lambda t: t.make_tracker("composite", children=["nope"]), KeyError,
     "unknown tracker"),
    (lambda t: t.register_tracker(t.get_tracker("memory")), ValueError,
     "already registered"),
    (lambda t: t.register_tracker(t.TrackerSpec(
        name="x", factory=None, defaults=dict(a=1))), ValueError,
     "undeclared"),
])
def test_registry_errors_match_reference(call, err, match):
    for pkg in (jtrack, track):
        with pytest.raises(err, match=match):
            call(pkg)


@pytest.mark.parametrize("kw,err", [
    (dict(tracker="nope"), KeyError),
    (dict(tracker="jsonl", every=3), TypeError),
    (dict(tracker="stdout", every=0), ValueError),
    (dict(tracker="stdout", every=2, tracker_opts=dict(every=3)), TypeError),
    (dict(tracker="stdout", tracker_opts=dict(path="x")), TypeError),
])
def test_flconfig_tracker_errors_match_reference(kw, err):
    for cls in (JFLConfig, FLConfig):
        with pytest.raises(err):
            cls.make(method="fedncv", **kw)


def test_flconfig_routes_tracker_options_as_reference():
    for kw in (dict(tracker="stdout", every=5),
               dict(tracker="stdout", tracker_opts=dict(interval=0.5)),
               dict(tracker="jsonl", path="x.jsonl"),
               dict(tracker="memory", track_variance=True)):
        j, t = JFLConfig.make(method="fedncv", **kw), \
            FLConfig.make(method="fedncv", **kw)
        assert (t.tracker, t.tracker_opts, t.track_variance) == \
            (j.tracker, j.tracker_opts, j.track_variance), kw


# ------------------------------- sinks ---------------------------------------

ROWS = [(1, dict(agg_norm=1.0 / 3.0, bytes_up=533172.0, live=3.0)),
        (2, dict(agg_norm=2.5e-8, bytes_up=0.0, live=0.0)),
        (3, dict(agg_norm=123456789.0, bytes_up=1e21, live=2.0)),
        (4, dict(agg_norm=float(np.float32(0.1)), bytes_up=7.0, live=1.0))]


@pytest.mark.parametrize("name", ["jsonl", "csv"])
def test_file_sinks_write_reference_bytes(tmp_path, name):
    files = []
    for pkg, tag in ((jtrack, "ref"), (track, "port")):
        path = str(tmp_path / tag / f"run.{name}")
        sink = pkg.make_tracker(name, path=path)
        for r, m in ROWS:
            sink.log(r, m)
        assert sink.resume(2) == (None if name == "csv"
                                  else dict(round=2, **ROWS[1][1]))
        sink.log(3, dict(agg_norm=9.5, bytes_up=1.0, live=3.0, extra=1.0))
        sink.finish(dict(rounds=3, ok=True))
        files.append(open(path, "rb").read())
    assert files[0] == files[1]
    assert len(files[1]) > 0


def test_stdout_memory_composite_match_reference():
    outs = []
    for pkg in (jtrack, track):
        buf = io.StringIO()
        mem = pkg.MemoryTracker()
        sink = pkg.composite(pkg.StdoutTracker(every=2, stream=buf), mem)
        for r, m in ROWS:
            sink.log(r, m)
        last = sink.resume(2)
        sink.finish(dict(rounds=2))
        outs.append((buf.getvalue(), mem.rows, mem.summary, last))
    assert outs[0] == outs[1]
    assert outs[1][0].count("\n") == 4       # rows 1, 2, 4 and the finish


def test_emitter_enrichment_matches_reference():
    """bytes_up_cum, reset, resume and set_host_metrics (merge) as the
    reference's emitter gives them for the same rounds."""
    rows = []
    for pkg, val in ((jtrack, jnp.float32), (track, torch.tensor)):
        mem = pkg.MemoryTracker()
        emit = pkg.emitter(mem)
        emit.reset()
        emit.set_host_metrics(dict(host_mem_peak=5.0))
        emit(1, dict(bytes_up=val(100.0), agg_norm=val(0.5)))
        emit.set_host_metrics(dict(queue_depth=3))
        emit(2, dict(bytes_up=val(50.0), agg_norm=val(0.25)))
        emit.resume(dict(bytes_up_cum=70.0))
        emit(3, dict(bytes_up=val(1.0), agg_norm=val(0.125)))
        emit.resume(None)
        emit(4, dict(bytes_up=val(2.0), agg_norm=val(1.0)))
        if pkg is jtrack:
            jax.effects_barrier()
        assert all(r["sec_per_round"] >= 0.0 for r in mem.rows)
        assert mem.rows[3]["sec_per_round"] == 0.0     # after a resume
        rows.append([{k: v for k, v in r.items() if k != "sec_per_round"}
                     for r in mem.rows])
    assert rows[0] == rows[1]
    assert [r["bytes_up_cum"] for r in rows[1]] == [100.0, 150.0, 71.0, 2.0]
    assert rows[1][2]["queue_depth"] == 3.0 and \
        rows[1][2]["host_mem_peak"] == 5.0


def test_emitter_reads_a_round_in_one_copy(monkeypatch):
    """The round's tensors cross to the host in one copy of their stack:
    no per-key `.item()`, `float()` or numpy conversion of a tensor."""
    copies = []
    cpu = torch.Tensor.cpu

    def counted(self, *a, **k):
        copies.append(self.shape)
        return cpu(self, *a, **k)

    def refused(self, *a, **k):
        raise AssertionError("a per-key host read of a tensor")
    monkeypatch.setattr(torch.Tensor, "cpu", counted)
    for name in ("item", "__float__", "__array__"):
        monkeypatch.setattr(torch.Tensor, name, refused)
    mem = track.MemoryTracker()
    track.emitter(mem)(1, dict(agg_norm=torch.tensor(0.5),
                               live=torch.tensor(3.0), bytes_up=12.0))
    monkeypatch.undo()
    assert copies == [(2,)]
    assert {k: mem.rows[0][k] for k in ("agg_norm", "live", "bytes_up")} \
        == dict(agg_norm=0.5, live=3.0, bytes_up=12.0)


# -------------------------- tracked rounds -----------------------------------

@pytest.fixture(scope="module")
def tracked(world):
    """The reference's and the port's tracked runs on the reference's
    draws: K = 1, track_variance, byzantine 0.7 at scale 10."""
    kw = dict(TRACKED, staleness=1, track_variance=True, tracker="memory")
    jsim = JSimulator(world["jtask"], world["jp"], world["train"],
                      JFLConfig.make(**kw), seed=0)
    draws = []
    for i in range(ROUNDS):
        draws.append(ref_draws(jsim, i))
        jsim.run_round()
    tsim = _sim(world, staleness=1, track_variance=True, tracker="memory")
    diags = tsim.run_rounds(ROUNDS, draws=draws)
    return jsim, tsim, draws, diags


def test_tracked_rows_match_reference(tracked):
    jsim, tsim, _, diags = tracked
    check_params_and_state(tsim, jsim)
    jrows, trows = jsim.tracker.rows, tsim.tracker.rows
    assert [r["round"] for r in trows] == [r["round"] for r in jrows] == \
        [1, 2, 3]
    for jr, tr in zip(jrows, trows):
        assert set(tr) == set(jr)
        assert {"gvar_proxy", "corrupt_frac", "bytes_up"} <= set(tr)
        for k in set(tr) - {"round", "sec_per_round"}:
            if k in ("bytes_up", "bytes_up_cum", "corrupt_frac"):
                assert tr[k] == jr[k], k
            else:
                np.testing.assert_allclose(tr[k], jr[k], rtol=1e-4,
                                           atol=1e-5, err_msg=k)
    # the bubble streams a zero row; then 2 of 3 clients are byzantine and
    # the cohort's variance proxy is positive
    assert all(v == 0.0 for k, v in trows[0].items()
               if k not in ("round",) + HOST_KEYS)
    assert all(r["gvar_proxy"] > 0.0 and r["corrupt_frac"] >= 2.0 / 3.0
               for r in trows[1:])
    # the streamed rows are the returned diagnostics
    for i, row in enumerate(trows):
        for k, v in diags.items():
            assert row[k] == float(v[i]), k


@pytest.mark.parametrize("store", ["device", "host"])
def test_tracked_run_is_bitwise_the_untracked_one(world, tracked, store):
    """Same draws: params, state and every shared diagnostic bitwise; the
    tracked run uploads 4 more bytes a live client (||g_u||^2) and its
    rows alone carry gvar_proxy and corrupt_frac (and, under the host
    store, the store's two gauges)."""
    _, tsim, draws, diags = tracked
    kw = dict(staleness=1)
    if store == "host":
        kw.update(store="host", prefetch=False)
        mem = track.MemoryTracker()
        host = _sim(world, tracker_obj=mem, track_variance=True, **kw)
        hdiags = host.run_rounds(ROUNDS, draws=draws)
        assert all({"host_mem_peak", "prefetch_overlap_frac"} <= set(r)
                   for r in mem.rows)
        for k, v in diags.items():
            np.testing.assert_array_equal(hdiags[k], v, err_msg=k)
    plain = _sim(world, **kw)
    assert plain._emit is None and not plain._track_on
    pdiags = plain.run_rounds(ROUNDS, draws=draws)
    for k, v in plain.params.items():
        assert torch.equal(v, tsim.params[k]), k
    for name, v in plain._get_state().items():
        for a, b in zip(jax.tree.leaves(v), jax.tree.leaves(
                tsim._get_state()[name])):
            assert torch.equal(a, b), name
    assert set(diags) - set(pdiags) == {"gvar_proxy", "corrupt_frac"}
    np.testing.assert_array_equal(diags["agg_norm"], pdiags["agg_norm"])
    np.testing.assert_array_equal(diags["bytes_up"] - pdiags["bytes_up"],
                                  [0.0, 12.0, 12.0])


def test_checkpoint_resume_truncates_jsonl_and_flwatch_accepts_it(
        world, tmp_path):
    path, ckdir = str(tmp_path / "run.jsonl"), str(tmp_path / "ck")
    first = _sim(world, tracker="jsonl", path=path)
    first.run_rounds(2)
    save_sim(ckdir, first)
    first.run_round()            # round 3: streamed, never checkpointed
    assert len(open(path).readlines()) == 3
    resumed = _sim(world, tracker="jsonl", path=path)
    restore_sim(ckdir, resumed)
    assert [json.loads(x)["round"] for x in open(path)] == [1, 2]
    resumed.run_rounds(2)
    resumed.tracker.finish(dict(rounds=4))
    rows = [json.loads(x) for x in open(path)]
    assert [r.get("round") for r in rows] == [1, 2, 3, 4, None]
    cum = np.cumsum([r["bytes_up"] for r in rows[:-1]])
    assert [r["bytes_up_cum"] for r in rows[:-1]] == list(cum)
    gate = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tools", "flwatch.py"), path,
         "--check", "--expect-rounds", "4"],
        capture_output=True, text=True, timeout=60)
    assert gate.returncode == 0, (gate.stdout, gate.stderr)
    assert "summary present" in gate.stdout


def test_phase_scopes_label_the_round(world):
    """A torch.profiler trace of one round names the reference's four
    phases (encode under a codec)."""
    sim = _sim(world, codec="bf16", tracker="memory")
    with torch.profiler.profile() as prof:
        sim.run_round()
    names = {e.name for e in prof.events()}
    assert set(track.PHASES) <= names, sorted(names)[:20]
