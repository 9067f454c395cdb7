"""The port's state stores (`repro_torch/fed/store.py`) against the
reference's (`src/repro/fed/store.py`, `tests/test_store.py`), on the CPU.

Registry and option validation equal the reference's; `HostTables`
gathers, writes back (never a dropped client's row), broadcasts its init
row and spills to an `np.memmap` file; the prefetch worker runs jobs in
order and raises its errors on the caller; and the standing contract:
under `store="host"` every round's params, state and diagnostics equal
the device store's bitwise, for every method, at K = 0 and K = 2, over
the int8 wire, under dropout and the importance sampler, with a spill,
without the worker and in chunks; `evaluate` too.  The host store's
device bytes do not grow with M.
"""
import numpy as np
import pytest
import torch

from repro.fed import FLConfig as JFLConfig
from repro.fed import store as jstore
from repro_torch.fed import FLConfig, Simulator, api, store as store_lib
from repro_torch.fed import get_store, register_store, registered_stores
from repro_torch.utils.tree_math import tree_leaves
from torch_parity import COMMON, FEDNCV, make_world


@pytest.fixture(scope="module")
def world():
    return make_world()


def port_sim(world, method="fedncv", store="device", **kw):
    return Simulator(world["ttask"], world["tp"], world["ttrain"],
                     FLConfig.make(method=method, store=store,
                                   **dict(COMMON, **kw)),
                     seed=0, device="cpu")


def run_pair(world, rounds=3, host_opts=None, **kw):
    """The device and the host store (with `host_opts`) on the same
    configuration; every round's diagnostics and the final params and
    state equal bitwise."""
    d = port_sim(world, store="device", **kw)
    h = port_sim(world, store="host", **kw, **(host_opts or {}))
    dd, dh = d.run_rounds(rounds), h.run_rounds(rounds)
    assert set(dd) == set(dh)
    for k in dd:
        assert np.array_equal(dd[k], dh[k]), k
    for k in d.params:
        assert torch.equal(d.params[k], h.params[k]), k
    sd, sh = d._get_state(), h._get_state()
    assert set(sd) == set(sh)
    for name in sd:
        for x, y in zip(tree_leaves(sd[name]), tree_leaves(sh[name])):
            assert torch.equal(x, y), name
    return d, h


# ----------------------------- registry --------------------------------------

def test_registry_matches_reference():
    ours = tuple(n for n in registered_stores() if not n.startswith("_"))
    assert ours == ("device", "host") == tuple(
        n for n in jstore.registered_stores() if not n.startswith("_"))
    assert api.registered_stores() == registered_stores()
    assert not get_store("device").host_resident
    assert get_store("host").host_resident
    assert get_store("host").defaults == jstore.get_store("host").defaults


def test_registry_refusals():
    with pytest.raises(KeyError, match="device"):
        get_store("hostt")
    with pytest.raises(ValueError, match="already registered"):
        register_store(get_store("host"))
    register_store(get_store("host"), overwrite=True)


@pytest.mark.parametrize("kw,err,match", [
    (dict(store="hostt"), KeyError, "unknown state store"),
    (dict(store="host", spill_mbb=1.0), TypeError, "spill_mbb"),
    (dict(store="device", spill_mb=1.0), TypeError, "spill_mb"),
    (dict(store="host", spill_mb=0.0), ValueError, "spill_mb"),
    (dict(store="host", store_opts=dict(prefetch=True), prefetch=False),
     TypeError, "prefetch"),
])
def test_store_options_are_validated_as_the_reference_does(kw, err, match):
    with pytest.raises(err, match=match):
        JFLConfig.make(method="fedavg", **kw)
    with pytest.raises(err, match=match):
        FLConfig.make(method="fedavg", **kw)


def test_resolve_opts_merges_defaults():
    opts = store_lib.resolve_opts(get_store("host"), dict(spill_mb=64.0))
    assert opts == dict(spill_mb=64.0, spill_dir=None, prefetch=True)
    fl = FLConfig.make(method="fedavg", store="host", prefetch=False)
    assert fl.store_opts == dict(prefetch=False) == JFLConfig.make(
        method="fedavg", store="host", prefetch=False).store_opts


# ----------------------------- HostTables ------------------------------------

def test_host_tables_gather_scatter_identity():
    t = store_lib.HostTables()
    rng = np.random.default_rng(0)
    t.adopt("w", dict(a=rng.normal(size=(10, 3)).astype(np.float32),
                      b=rng.normal(size=(10,)).astype(np.float32)))
    idx = np.array([7, 2, 5])
    win = t.gather(["w"], idx)["w"]
    assert win["a"].shape == (3, 3)
    new = {k: v + 1.0 for k, v in win.items()}
    t.scatter("w", idx, new)
    back = t.gather(["w"], torch.tensor(idx))["w"]
    assert all(torch.equal(back[k], new[k]) for k in new)
    out = {"w": {k: torch.empty_like(v) for k, v in win.items()}}
    got = t.gather(["w"], idx, out=out)["w"]
    assert got["a"].data_ptr() == out["w"]["a"].data_ptr()
    assert torch.equal(got["a"], new["a"])


def test_host_tables_scatter_skips_dropped_rows():
    t = store_lib.HostTables()
    base = torch.arange(12, dtype=torch.float32).reshape(6, 2)
    t.adopt("w", base.clone())
    idx = np.array([1, 3, 4])
    rows = t.gather(["w"], idx)["w"] * 100.0
    t.scatter("w", idx, rows, alive=np.array([1.0, 0.0, 1.0]))
    out = t.get("w")
    assert torch.equal(out[3], base[3])
    assert torch.equal(out[1], base[1] * 100.0)
    assert torch.equal(out[4], base[4] * 100.0)
    t.scatter("w", idx, rows, alive=np.zeros(3))     # all dead: a no-op
    assert torch.equal(out[3], base[3])


def test_host_tables_add_broadcasts_one_row():
    t = store_lib.HostTables()
    t.add("z", dict(v=np.zeros(4, np.float32)), m=7)
    t.add("c", torch.tensor([1.0, 2.0]), m=5)
    assert t.get("z")["v"].shape == (7, 4) and not t.get("z")["v"].any()
    assert torch.equal(t.get("c"), torch.tensor([[1.0, 2.0]] * 5))
    assert t.nbytes() == 7 * 4 * 4 + 5 * 2 * 4
    assert t.spilled_bytes() == 0


def test_host_tables_memmap_spill(tmp_path):
    t = store_lib.HostTables(dict(spill_mb=1e-5, spill_dir=str(tmp_path)))
    t.add("big", np.array([3.0, 1.0], np.float32), m=64)
    assert t.spilled_bytes() == 64 * 2 * 4
    assert len(list(tmp_path.glob("*.mmap"))) == 1
    idx = np.array([0, 63])
    win = t.gather(["big"], idx)["big"]
    assert torch.equal(win, torch.tensor([[3.0, 1.0]] * 2))
    t.scatter("big", idx, win * 2)
    assert torch.equal(t.get("big")[63], torch.tensor([6.0, 2.0]))
    t.set("big", np.ones((64, 2), np.float32))  # in place: still spilled
    assert t.spilled_bytes() == 64 * 2 * 4 and t.get("big")[10, 1] == 1.0
    mm = np.memmap(next(tmp_path.glob("*.mmap")), dtype=np.float32,
                   mode="r", shape=(64, 2))
    assert mm[10, 1] == 1.0


# ----------------------------- prefetch worker, staging ----------------------

def test_prefetcher_inline_and_threaded_agree():
    for enabled in (False, True):
        pf = store_lib.CohortPrefetcher(enabled=enabled)
        waits = [pf.submit(lambda k=k: k * k) for k in range(5)]
        assert [w() for w in waits] == [0, 1, 4, 9, 16]
        assert 0.0 <= pf.overlap_frac() <= 1.0
        pf.close()


@pytest.mark.parametrize("enabled", [False, True])
def test_prefetcher_raises_the_workers_error_on_the_caller(enabled):
    pf = store_lib.CohortPrefetcher(enabled=enabled)
    try:
        with pytest.raises(ZeroDivisionError):
            pf.submit(lambda: 1 / 0)()
        if enabled:   # the error stays: no later job runs quietly
            with pytest.raises(ZeroDivisionError):
                pf.submit(lambda: 1)
    finally:
        pf._err = None
        pf.close()


def test_staging_on_the_cpu_counts_its_bytes():
    st = store_lib.Staging(torch.device("cpu"))
    slot, out = st.buffers(dict(a=((3, 2), torch.float32),
                                b=dict(c=((4,), torch.int64))))
    out["a"].fill_(1.0)
    out["b"]["c"].fill_(2)
    staged = st.ship(slot, out).ready()
    assert torch.equal(staged["a"], torch.ones(3, 2))
    assert st.bytes_in == 3 * 2 * 4 + 4 * 8
    st.fetch(dict(x=torch.zeros(5)))
    assert st.bytes_out == 20


def test_a_failed_staging_raises_at_the_round(world, monkeypatch):
    sim = port_sim(world, store="host", **FEDNCV)

    def broken(*a, **k):
        raise RuntimeError("staging copy failed")
    monkeypatch.setattr(sim, "_host_stage", broken)
    with pytest.raises(RuntimeError, match="staging copy failed"):
        sim.run_rounds(2)
    assert sim.round_idx == 0


# ----------------------------- host == device, bitwise -----------------------

METHODS = {
    "fedavg": dict(local_epochs=1),
    "fedncv": FEDNCV,
    "fedprox": dict(local_epochs=1, prox_mu=0.1),
    "scaffold": dict(local_epochs=1),
    "fedncv+": dict(local_epochs=1),
    "fedper": dict(local_epochs=1),
    "fedrep": dict(local_epochs=1, head_local_steps=1),
    "pfedsim": dict(local_epochs=1),
    "fedglomo": dict(local_epochs=1, glomo_beta_local=0.5),
}


@pytest.mark.parametrize("k", [0, 2])
@pytest.mark.parametrize("method", list(METHODS))
def test_host_matches_device_for_every_method(world, method, k):
    _, h = run_pair(world, method=method, staleness=k, **METHODS[method])
    assert h.host_state_bytes() > 0
    assert not set(h._host_state_names) & set(h._state)


@pytest.mark.parametrize("case", [
    dict(codec="int8", ncv_beta=1.0),
    dict(fault="dropout", drop_rate=0.4, ncv_beta=1.0),
    dict(sampler="importance", ncv_beta=1.0),
    dict(staleness=2, fault="dropout", drop_rate=0.4, sampler="importance",
         ncv_beta=1.0),
    dict(prefetch=False, ncv_beta=1.0),
], ids=["int8", "dropout", "importance", "ring-dropout-importance",
        "no-prefetch"])
def test_host_matches_device_on_every_path(world, case):
    kw = dict(FEDNCV, **case)
    host_opts = {k: kw.pop(k) for k in ("prefetch",) if k in kw}
    run_pair(world, rounds=4, host_opts=host_opts, **kw)


def test_dropped_clients_rows_are_not_written(world):
    kw = dict(METHODS["scaffold"], fault="dropout", drop_rate=0.5)
    h = port_sim(world, "scaffold", store="host", **kw)
    mixed = 0
    for _ in range(6):
        before = {k: v.clone() for k, v in h.c_u.items()}
        draws = h.draw_round()
        h.run_round(draws=draws)
        alive = draws.plan["alive"]
        mixed += 0 < float(alive.sum()) < len(alive)
        for slot, u in enumerate(draws.idx.tolist()):
            same = all(torch.equal(before[k][u], h.c_u[k][u])
                       for k in before)
            assert same == (float(alive[slot]) == 0.0)
    assert mixed


def test_spill_and_chunks_match_one_run(world, tmp_path):
    d = port_sim(world, "fedncv+", **METHODS["fedncv+"])
    d.run_rounds(4)
    h = port_sim(world, "fedncv+", store="host", spill_mb=1e-3,
                 spill_dir=str(tmp_path), **METHODS["fedncv+"])
    h.run_rounds(1)
    h.run_rounds(3)
    assert h._host.spilled_bytes() > 0
    for k in d.params:
        assert torch.equal(d.params[k], h.params[k])
    for x, y in zip(tree_leaves(d.h), tree_leaves(h.h)):
        assert torch.equal(x, y)


@pytest.mark.parametrize("method", ["fedncv", "fedper"])
def test_host_evaluate_matches_device(world, method):
    d, h = run_pair(world, rounds=2, method=method, **METHODS[method])
    for steps in (0, 2):
        assert d.evaluate(world["ttrain"], personalize_steps=steps) == \
            h.evaluate(world["ttrain"], personalize_steps=steps)


def test_device_bytes_do_not_grow_with_m(world):
    """Twice the clients: the device store's (M, N) h table doubles, the
    host store's device bytes stay."""
    train = world["ttrain"]
    big = dict(train, client_idx=np.concatenate([train["client_idx"]] * 2),
               client_sizes=np.concatenate([train["client_sizes"]] * 2))
    out = {}
    for m, data in ((6, train), (12, big)):
        for store in ("device", "host"):
            fl = FLConfig.make(method="fedncv+", store=store,
                               **dict(COMMON, n_clients=m, local_epochs=1))
            sim = Simulator(world["ttask"], world["tp"], data, fl,
                            device="cpu")
            sim.run_rounds(1)
            out[m, store] = (sim.device_state_bytes(),
                             sim.host_state_bytes())
    assert out[6, "host"][0] == out[12, "host"][0]
    assert out[12, "host"][1] > out[6, "host"][1] > 0
    n = 62006 * 4
    assert out[12, "device"][0] - out[6, "device"][0] >= 6 * n
    assert out[6, "device"][1] == 0


def test_host_metrics_count_the_staged_bytes(world):
    h = port_sim(world, "fedncv+", store="host", **METHODS["fedncv+"])
    h.run_rounds(2)
    m = h.host_metrics()
    assert m["host_mem_peak"] > 0 and 0.0 <= m["prefetch_overlap_frac"] <= 1
    window = 3 * 62006 * 4
    batch = 3 * 3 * 4 * (32 * 32 * 3 * 4 + 8)
    assert m["staged_bytes_in"] == 2 * (window + batch)
    assert m["staged_bytes_out"] == 2 * window
    h.close()
    h.run_rounds(1)     # a later round starts a new worker
    assert h.round_idx == 3
