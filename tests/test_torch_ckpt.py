"""The port's checkpoints (`repro_torch/checkpoint/`) against the
reference's (`src/repro/checkpoint/ckpt.py`), on the CPU.

`_msgpack.packb` writes the bytes `msgpack.packb(obj, use_bin_type=True)`
writes, for every type a checkpoint holds (msgpack is imported here
only); a sync checkpoint the reference wrote restores into the port and
the next round lands on the reference's (tolerances: `torch_parity`), and
one the port wrote restores into the reference; a save in the middle of a
pipelined run, under either store, resumes bitwise the uninterrupted run,
the generators' draws included; the reference's refusals hold (staleness,
store, state layout, an unregistered name); no `repro_torch` module
imports msgpack.
"""
import ast
import pathlib
import subprocess
import sys

import msgpack
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as jckpt
from repro_torch.checkpoint import _msgpack, ckpt
from repro_torch.fed import FLConfig, Simulator
from repro_torch.utils.tree_math import tree_leaves
from torch_parity import (COMMON, FEDNCV, check_params_and_state, make_world,
                          ref_draws, sims)

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def world():
    return make_world()


def port_sim(world, method="fedncv", **kw):
    return Simulator(world["ttask"], world["tp"], world["ttrain"],
                     FLConfig.make(method=method, **dict(COMMON, **kw)),
                     seed=0, device="cpu")


def assert_same(a, b):
    for k in a.params:
        assert torch.equal(a.params[k], b.params[k]), k
    sa, sb = a._get_state(), b._get_state()
    assert set(sa) == set(sb)
    for name in sa:
        for x, y in zip(tree_leaves(sa[name]), tree_leaves(sb[name])):
            assert torch.equal(x, y), name


def rewrite_meta(directory, **changes):
    """Rewrite the latest checkpoint's meta (None deletes a key)."""
    path = ckpt._step_path(str(directory), None)
    payload = ckpt._read_payload(path)
    meta = dict(payload.pop("_meta"))
    for k, v in changes.items():
        if v is None:
            meta.pop(k, None)
        else:
            meta[k] = v
    payload["_meta"] = meta
    with open(path, "wb") as f:
        f.write(_msgpack.packb(payload))


# ----------------------------- the msgpack subset ----------------------------

PAYLOADS = {
    "nil-bool": [None, True, False],
    "ints": [0, 1, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32,
             2**63 - 1, 2**64 - 1, -1, -32, -33, -128, -129, -32768, -32769,
             -2**31, -2**31 - 1, -2**63],
    "floats": [0.0, -0.0, 1.5, -2.25e-300, float("inf"), 3.4e38],
    "strs": ["", "a" * 31, "a" * 32, "b" * 255, "c" * 256, "é" * 40000,
             "float32"],
    "bins": [b"", b"x", b"y" * 255, b"z" * 256, b"w" * 70000],
    "lists": [[], list(range(15)), list(range(16)), list(range(70000)),
              (1, [2, (3,)])],
    "maps": [{}, {str(i): i for i in range(15)},
             {str(i): [i] for i in range(16)},
             {f"k{i}": None for i in range(70000)}],
    "entry": {"params/conv1": dict(dtype="float32", shape=[5, 5, 3, 6],
                                   data=np.arange(450, dtype=np.float32)
                                   .tobytes()),
              "_meta": dict(round_idx=3, staleness=2, store="host",
                            state_keys=["alphas"], mesh={"cohort": 1})},
}


@pytest.mark.parametrize("name", list(PAYLOADS))
def test_packb_writes_msgpacks_bytes(name):
    obj = PAYLOADS[name]
    ours = _msgpack.packb(obj)
    assert ours == msgpack.packb(obj, use_bin_type=True)
    assert _msgpack.unpackb(ours) == msgpack.unpackb(ours, raw=False)


def test_unpackb_reads_the_wider_forms_and_refuses_garbage():
    for obj in (np.float32(1.5).item(), 7, -3, "s", b"b"):
        for data in (msgpack.packb(obj, use_bin_type=True,
                                   use_single_float=True),
                     msgpack.packb([obj, {"a": obj}], use_bin_type=True)):
            assert _msgpack.unpackb(data) == msgpack.unpackb(data,
                                                             raw=False)
    assert _msgpack.unpackb(b"\xca\x3f\xc0\x00\x00") == 1.5      # float32
    assert _msgpack.unpackb(b"\xd1\xff\x7f") == -129             # int16
    with pytest.raises(ValueError, match="truncated"):
        _msgpack.unpackb(b"\xda\x00\x05ab")
    with pytest.raises(ValueError, match="extra data"):
        _msgpack.unpackb(b"\x01\x02")
    with pytest.raises(TypeError, match="serialize"):
        _msgpack.packb({"x": object()})


def test_a_checkpoint_file_is_msgpack(world, tmp_path):
    sim = port_sim(world, staleness=2, codec="bf16", ncv_beta=0.0)
    sim.run_rounds(3)
    ckpt.save_sim(str(tmp_path), sim)
    data = (tmp_path / "3.ckpt").read_bytes()
    payload = msgpack.unpackb(data, raw=False)
    assert msgpack.packb(payload, use_bin_type=True) == data
    assert list(payload)[-1] == "_meta"
    keys = [k for k in payload if k != "_meta"]
    assert keys == sorted(keys, key=lambda k: k.split("/")[0])
    assert payload["pipeline/ring/0/grads/v"]["dtype"] == "bfloat16"
    assert {"rng/gen", "rng/fgen", "rng/ugen"} <= set(payload)


# ----------------------------- across the two packages -----------------------

@pytest.mark.parametrize("method,kw", [
    ("fedncv", dict(FEDNCV, ncv_beta=1.0)),
    ("scaffold", dict(local_epochs=2)),
])
def test_a_reference_checkpoint_restores_into_the_port(world, tmp_path,
                                                       method, kw):
    jsim, tsim = sims(world, method, **kw)
    for _ in range(2):
        jsim.run_round()
    jckpt.save_sim(str(tmp_path), jsim)
    gen = tsim._gen.get_state()
    meta = ckpt.restore_sim(str(tmp_path), tsim)
    assert meta["round_idx"] == tsim.round_idx == 2
    assert torch.equal(tsim._gen.get_state(), gen)   # no rng/: left as is
    check_params_and_state(tsim, jsim)
    draws = ref_draws(jsim, 2)
    jsim.run_round()
    tsim.run_round(draws=draws)
    check_params_and_state(tsim, jsim)


def test_a_port_checkpoint_restores_into_the_reference(world, tmp_path):
    jsim, tsim = sims(world, "scaffold", local_epochs=1)
    tsim.run_rounds(2)
    ckpt.save_sim(str(tmp_path), tsim)
    jckpt.restore_sim(str(tmp_path), jsim)
    assert jsim.round_idx == 2
    for k, v in jsim.params.items():
        assert np.array_equal(np.asarray(v), tsim.params[k].numpy())
    for k, v in jsim.c_u.items():
        assert np.array_equal(np.asarray(v), tsim.c_u[k].numpy())


# ----------------------------- resume == uninterrupted -----------------------

@pytest.mark.parametrize("store", ["device", "host"])
@pytest.mark.parametrize("k", [1, 2])
def test_mid_pipeline_save_resumes_bitwise(world, tmp_path, store, k):
    kw = dict(FEDNCV, ncv_beta=1.0, staleness=k, store=store)
    whole = port_sim(world, **kw)
    rows = whole.run_rounds(6)
    first = port_sim(world, **kw)
    rows1 = first.run_rounds(3)
    ckpt.save_sim(str(tmp_path), first)
    meta = ckpt.read_meta(str(tmp_path))
    assert meta["pipeline_inflight"] == k and meta["staleness"] == k
    resumed = port_sim(world, **kw)
    ckpt.restore_sim(str(tmp_path), resumed)
    assert resumed.round_idx == 3
    rows2 = resumed.run_rounds(3)
    assert_same(whole, resumed)
    for key in rows:
        assert np.array_equal(rows[key],
                              np.concatenate([rows1[key], rows2[key]]))


@pytest.mark.parametrize("store", ["device", "host"])
def test_sync_save_carries_every_generator(world, tmp_path, store):
    # int8 draws the device generator's uniforms, dropout the fault one's
    kw = dict(FEDNCV, codec="int8", fault="dropout", drop_rate=0.3,
              store=store)
    whole = port_sim(world, **kw)
    whole.run_rounds(4)
    first = port_sim(world, **kw)
    first.run_rounds(2)
    ckpt.save_sim(str(tmp_path), first)
    resumed = port_sim(world, **dict(kw))
    resumed.run_rounds(1)          # moved on: the restore puts it back
    ckpt.restore_sim(str(tmp_path), resumed)
    resumed.run_rounds(2)
    assert_same(whole, resumed)


# ----------------------------- refusals --------------------------------------

def test_staleness_and_store_mismatches_are_refused(world, tmp_path):
    sim = port_sim(world, staleness=2, **FEDNCV)
    sim.run_rounds(3)
    ckpt.save_sim(str(tmp_path), sim)
    with pytest.raises(ValueError, match="staleness=2"):
        ckpt.restore_sim(str(tmp_path), port_sim(world, staleness=1,
                                                 **FEDNCV))
    with pytest.raises(ValueError, match="store="):
        ckpt.restore_sim(str(tmp_path), port_sim(world, staleness=2,
                                                 store="host", **FEDNCV))
    # a sync checkpoint has no pipeline: any depth takes it, as in the
    # reference
    sync = port_sim(world, **FEDNCV)
    sync.run_rounds(1)
    ckpt.save_sim(str(tmp_path / "sync"), sync)
    ckpt.restore_sim(str(tmp_path / "sync"), port_sim(world, staleness=3,
                                                      **FEDNCV))


def test_state_layout_and_unregistered_names_are_refused(world, tmp_path):
    sim = port_sim(world, **FEDNCV)
    sim.run_rounds(1)
    ckpt.save_sim(str(tmp_path), sim)
    rewrite_meta(tmp_path, state_keys=["alphas", "extra"])
    with pytest.raises(ValueError, match="state layout"):
        ckpt.restore_sim(str(tmp_path), port_sim(world, **FEDNCV))
    rewrite_meta(tmp_path, state_keys=["alphas"], method="fedbogus")
    with pytest.raises(ValueError, match="registered methods.*fedncv"):
        ckpt.restore_sim(str(tmp_path), port_sim(world, **FEDNCV))
    rewrite_meta(tmp_path, method="fedncv", aggregator="krum")
    with pytest.raises(ValueError, match="registered aggregators"):
        ckpt.restore_sim(str(tmp_path), port_sim(world, **FEDNCV))


def test_absent_meta_keys_take_the_reference_defaults(world, tmp_path):
    sim = port_sim(world, **FEDNCV)
    sim.run_rounds(1)
    ckpt.save_sim(str(tmp_path), sim)
    rewrite_meta(tmp_path, method=None, codec=None, sampler=None,
                 aggregator=None, fault=None, store=None, state_keys=None)
    ckpt.restore_sim(str(tmp_path), port_sim(world, **FEDNCV))
    with pytest.raises(ValueError, match="sampler='uniform'"):
        ckpt.restore_sim(str(tmp_path), port_sim(
            world, sampler="importance", **FEDNCV))
    with pytest.raises(ValueError, match="store='device'"):
        ckpt.restore_sim(str(tmp_path), port_sim(world, store="host",
                                                 **FEDNCV))


def test_save_step_keeps_the_newest_and_restores_trees(tmp_path):
    tree = dict(a=torch.arange(6, dtype=torch.int32).reshape(2, 3),
                b=[torch.ones(2, dtype=torch.bfloat16), torch.zeros(())],
                c=dict(d=torch.tensor([True, False])))
    for step in (1, 5, 3, 7):
        ckpt.save_step(str(tmp_path), step, tree, dict(tag="x"), keep=2)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["5.ckpt",
                                                          "7.ckpt"]
    assert ckpt.latest_step(str(tmp_path)) == 7
    assert ckpt.latest_step(str(tmp_path / "none")) is None
    assert ckpt.read_meta(str(tmp_path), 5) == dict(tag="x", step=5)
    got, meta = ckpt.restore_step(str(tmp_path), tree)
    assert meta["step"] == 7
    for x, y in zip(tree_leaves(dict(a=got["a"], c=got["c"])),
                    tree_leaves(dict(a=tree["a"], c=tree["c"]))):
        assert torch.equal(x, y) and x.dtype == y.dtype
    assert torch.equal(got["b"][0], tree["b"][0])
    assert isinstance(got["b"], list) and got["b"][1].shape == ()
    with pytest.raises(KeyError, match="missing"):
        ckpt.restore_step(str(tmp_path), dict(tree, e=torch.ones(1)))
    with pytest.raises(FileNotFoundError):
        ckpt.restore_step(str(tmp_path / "none"), tree)


# ----------------------------- no msgpack in the port ------------------------

def test_no_port_module_imports_msgpack():
    sources = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    assert len(sources) > 15
    for path in sources:
        for node in ast.walk(ast.parse(path.read_text())):
            names = [a.name for a in node.names] if isinstance(
                node, ast.Import) else [node.module or ""] if isinstance(
                node, ast.ImportFrom) else []
            assert not any(n.split(".")[0] == "msgpack" for n in names), \
                path.relative_to(ROOT)
    code = f"""
import sys
sys.modules['msgpack'] = None          # any import of it fails
sys.path[:0] = [{str(ROOT / 'src')!r}]
import repro_torch.checkpoint, repro_torch.fed
print('ok')
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
