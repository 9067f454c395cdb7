"""Synthetic datasets standing in for the paper's benchmarks (numpy only;
the same arrays as `src/repro/data/synthetic.py` for the same seed):

* `make_image_dataset` — Gaussian class-cluster images shaped like
  CIFAR-10/100, Tiny-ImageNet or EMNIST; learnable by LeNet-5 but not
  trivially separable (controlled by `noise`).
* `federated_splits` — dataset + Dirichlet partition + train/test split, the
  full Table-1 protocol in one call.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.data.dirichlet import dirichlet_partition


@dataclasses.dataclass(frozen=True)
class DatasetSpec:
    name: str
    n_classes: int
    image_size: int
    channels: int
    n_train: int
    n_test: int


# Shapes mirror the paper's Table 2 (counts scaled down for CI budgets).
SPECS = {
    "cifar10": DatasetSpec("cifar10", 10, 32, 3, 20_000, 4_000),
    "cifar100": DatasetSpec("cifar100", 100, 32, 3, 20_000, 4_000),
    "tiny-imagenet": DatasetSpec("tiny-imagenet", 200, 32, 3, 24_000, 4_000),
    "emnist": DatasetSpec("emnist", 62, 28, 1, 24_000, 4_000),
    "mnist": DatasetSpec("mnist", 10, 28, 1, 12_000, 2_000),
    "svhn": DatasetSpec("svhn", 10, 32, 3, 12_000, 2_000),
    "fmnist": DatasetSpec("fmnist", 10, 28, 1, 12_000, 2_000),
    "cinic10": DatasetSpec("cinic10", 10, 32, 3, 12_000, 2_000),
}


def make_image_dataset(spec: DatasetSpec, rng: np.random.Generator,
                       noise: float = 2.0, n_override=None,
                       class_sep: float = 0.35, label_noise: float = 0.08):
    """Gaussian class-cluster images, calibrated to LAND MID-RANGE accuracy
    for LeNet-5 within ~100 federated rounds (so methods differentiate):
    templates share a common base (classes overlap), per-sample jitter shifts
    each image, and a small label-noise floor caps attainable accuracy.
    """
    n = n_override or (spec.n_train + spec.n_test)
    s, c, k = spec.image_size, spec.channels, spec.n_classes
    # correlated low-rank class templates: shared base + small class delta
    shared = rng.standard_normal((1, 8, 8, c)).astype(np.float32)
    delta = rng.standard_normal((k, 8, 8, c)).astype(np.float32)
    base = shared + class_sep * delta
    templates = np.kron(base, np.ones((1, s // 8 + 1, s // 8 + 1, 1)))
    templates = templates[:, :s, :s, :] * 0.5
    labels = rng.integers(0, k, size=n).astype(np.int32)
    images = templates[labels]
    # per-sample spatial jitter (roll by up to 3 px) destroys pixel-exact cues
    shifts = rng.integers(-3, 4, size=(n, 2))
    for i in range(n):                        # vectorized-enough at our sizes
        images[i] = np.roll(images[i], tuple(shifts[i]), axis=(0, 1))
    images = images + noise * rng.standard_normal(
        (n, s, s, c)).astype(np.float32)
    flip = rng.random(n) < label_noise
    labels[flip] = rng.integers(0, k, size=int(flip.sum())).astype(np.int32)
    return images, labels


def federated_splits(name: str, n_clients: int, alpha: float = 0.1, seed=0,
                     scale: float = 1.0, **data_kw):
    """Returns (train_data, test_data) dicts compatible with fed.Simulator.

    data_kw forwards to make_image_dataset (noise / class_sep / label_noise)
    — tests use easier settings than the benchmark defaults.
    """
    spec = SPECS[name]
    rng = np.random.default_rng(seed)
    n_train = int(spec.n_train * scale)
    n_test = int(spec.n_test * scale)
    images, labels = make_image_dataset(
        spec, rng, n_override=n_train + n_test, **data_kw)
    tr_img, te_img = images[:n_train], images[n_train:]
    tr_lab, te_lab = labels[:n_train], labels[n_train:]
    tr_idx, tr_sizes = dirichlet_partition(tr_lab, n_clients, alpha, rng)
    # test split partitioned with the SAME label skew (per-client test sets,
    # as in the paper's personalization evaluation)
    te_idx, te_sizes = dirichlet_partition(te_lab, n_clients, alpha, rng)
    train = dict(images=tr_img, labels=tr_lab, client_idx=tr_idx,
                 client_sizes=tr_sizes)
    test = dict(images=te_img, labels=te_lab, client_idx=te_idx,
                client_sizes=te_sizes)
    return spec, train, test
