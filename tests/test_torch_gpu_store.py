"""The host store, the depth-K ring and checkpoints on the card.

Imports no JAX, so it runs on a machine with the card and PyTorch only:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu_store.py

The host store's card path — page-locked tables and staging buffers, the
copies on the staging side stream, the round's stream waiting on their
events — gives the device store's bits; so does a resumed checkpoint,
the device generator's state included.  Without a card every test skips
(decided in the `cuda` fixture, never at import).
"""
import numpy as np
import pytest
import torch

from repro_torch import checkpoint
from repro_torch.data import federated_splits
from repro_torch.fed import FLConfig, Simulator, Task, store as store_lib
from repro_torch.models import lenet
from repro_torch.utils.tree_math import tree_leaves

pytestmark = pytest.mark.gpu

BASE = dict(n_clients=8, cohort=4, k_micro=2, micro_batch=8, server_lr=0.5,
            local_lr=0.05, local_epochs=1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def world():
    spec, train, test = federated_splits("cifar10", n_clients=8, alpha=0.1,
                                         seed=0, scale=0.05)
    cfg = lenet.LeNetConfig(n_classes=spec.n_classes,
                            image_size=spec.image_size,
                            channels=spec.channels)
    task = Task(loss=lambda p, b: lenet.loss_fn(cfg, p, b),
                accuracy=lambda p, b: lenet.accuracy(cfg, p, b),
                head_keys=lenet.HEAD_KEYS)
    return dict(train=train, test=test, task=task,
                params=lenet.init(cfg, torch.Generator().manual_seed(0)))


def sim_of(world, **kw):
    return Simulator(world["task"], world["params"], world["train"],
                     FLConfig.make(**dict(BASE, **kw)), seed=0)


def assert_same(a, b):
    for k in a.params:
        assert torch.equal(a.params[k], b.params[k]), k
    sa, sb = a._get_state(), b._get_state()
    assert set(sa) == set(sb)
    for name in sa:
        for x, y in zip(tree_leaves(sa[name]), tree_leaves(sb[name])):
            assert torch.equal(x.cpu(), y.cpu()), name


@pytest.mark.parametrize("kw", [
    dict(method="fedncv", ncv_beta=1.0),
    dict(method="fedncv+"),
    dict(method="scaffold", staleness=2),
    dict(method="fedncv", codec="int8", fault="dropout", drop_rate=0.3,
         sampler="importance", staleness=1),
], ids=["fedncv", "fedncv+", "scaffold-k2", "int8-dropout-importance-k1"])
@pytest.mark.parametrize("prefetch", [True, False])
def test_host_store_on_the_card_is_the_device_store(cuda, world, kw,
                                                    prefetch):
    dev = sim_of(world, **kw)
    host = sim_of(world, store="host", prefetch=prefetch, **kw)
    dd, dh = dev.run_rounds(5), host.run_rounds(5)
    for k in dd:
        assert np.array_equal(dd[k], dh[k]), k
    assert_same(dev, host)
    assert host._host.get("data:images").is_pinned()
    assert all(x.is_pinned() for n in host._host_state_names
               for x in tree_leaves(host._host.get(n)))
    assert dev.evaluate(world["test"]) == host.evaluate(world["test"])
    host.close()


def test_staging_copies_on_a_side_stream_and_waits_by_event(cuda):
    st = store_lib.Staging(cuda, slots=2)
    seen = []
    for i in range(4):
        slot, out = st.buffers(dict(x=((1 << 20,), torch.float32)))
        assert out["x"].is_pinned()
        out["x"].fill_(float(i))
        staged = st.ship(slot, out)
        assert staged.event is not None
        seen.append(staged.ready()["x"].sum())
    assert [float(s) for s in seen] == [float(i << 20) for i in range(4)]
    back = st.fetch(dict(y=torch.full((8,), 3.0, device=cuda)))
    assert back["y"].device.type == "cpu" and float(back["y"].sum()) == 24
    assert st.bytes_in == 4 * 4 * (1 << 20) and st.bytes_out == 32


@pytest.mark.parametrize("store", ["device", "host"])
def test_checkpoint_resumes_bitwise_on_the_card(cuda, world, tmp_path,
                                                store):
    # int8 draws its uniforms from the device generator
    kw = dict(method="fedncv", ncv_beta=1.0, codec="int8", staleness=2,
              store=store)
    whole = sim_of(world, **kw)
    whole.run_rounds(6)
    first = sim_of(world, **kw)
    first.run_rounds(3)
    checkpoint.save_sim(str(tmp_path), first)
    resumed = sim_of(world, **kw)
    checkpoint.restore_sim(str(tmp_path), resumed)
    resumed.run_rounds(3)
    assert_same(whole, resumed)
    assert torch.equal(whole._ugen.get_state(), resumed._ugen.get_state())


def test_a_failed_staging_raises_at_the_round_on_the_card(cuda, world,
                                                          monkeypatch):
    host = sim_of(world, method="fedncv", store="host")

    def broken(*a, **k):
        raise RuntimeError("staging copy failed")
    monkeypatch.setattr(host, "_host_stage_batch", broken)
    with pytest.raises(RuntimeError, match="staging copy failed"):
        host.run_rounds(2)
    host.close()
