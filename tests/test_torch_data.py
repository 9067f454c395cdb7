"""The port's numpy data pipeline gives the reference's arrays, equal."""
import numpy as np
import pytest

from repro.data import dirichlet as jdir
from repro.data import synthetic as jsyn
from repro_torch.data import dirichlet as tdir
from repro_torch.data import synthetic as tsyn


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name,kw", [("cifar10", {}),
                                     ("emnist", dict(noise=1.2,
                                                     class_sep=0.8))])
def test_federated_splits_equal_reference(seed, name, kw):
    spec, train, test = tsyn.federated_splits(name, n_clients=12, alpha=0.1,
                                              seed=seed, scale=0.03, **kw)
    jspec, jtrain, jtest = jsyn.federated_splits(name, n_clients=12,
                                                 alpha=0.1, seed=seed,
                                                 scale=0.03, **kw)
    assert spec == tsyn.SPECS[name]
    assert (spec.n_classes, spec.image_size, spec.channels) == \
        (jspec.n_classes, jspec.image_size, jspec.channels)
    for ours, ref in ((train, jtrain), (test, jtest)):
        assert sorted(ours) == sorted(ref)
        for key in ref:
            assert ours[key].dtype == ref[key].dtype, key
            np.testing.assert_array_equal(ours[key], ref[key], err_msg=key)


def test_dirichlet_partition_equal_reference():
    labels = np.random.default_rng(4).integers(0, 10, 500)
    ours = tdir.dirichlet_partition(labels, 9, 0.1,
                                    np.random.default_rng(5))
    ref = jdir.dirichlet_partition(labels, 9, 0.1, np.random.default_rng(5))
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a, b)


def test_specs_equal_reference():
    assert {k: tuple(v.__dict__.values()) for k, v in tsyn.SPECS.items()} \
        == {k: tuple(v.__dict__.values()) for k, v in jsyn.SPECS.items()}
