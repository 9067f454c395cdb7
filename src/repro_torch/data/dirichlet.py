"""Dirichlet(α) non-IID partitioner — the paper's heterogeneity protocol
(α = 0.1 in all headline experiments; Tan et al. 2023 methodology).

Each class's samples are split across clients by a Dirichlet(α) draw; small α
concentrates each class on few clients so |Y_i| <= |Y|.
"""
from __future__ import annotations

import numpy as np


def dirichlet_partition(labels: np.ndarray, n_clients: int, alpha: float,
                        rng: np.random.Generator, min_per_client: int = 2):
    """Returns (client_idx (M, n_max) int32 padded with -1, sizes (M,))."""
    labels = np.asarray(labels)
    classes = np.unique(labels)
    buckets: list[list[int]] = [[] for _ in range(n_clients)]
    for c in classes:
        idx_c = np.flatnonzero(labels == c)
        rng.shuffle(idx_c)
        props = rng.dirichlet([alpha] * n_clients)
        # split idx_c proportionally
        cuts = (np.cumsum(props) * len(idx_c)).astype(int)[:-1]
        for u, part in enumerate(np.split(idx_c, cuts)):
            buckets[u].extend(part.tolist())
    # guarantee a minimum shard size (move from the largest shards)
    order = np.argsort([len(b) for b in buckets])
    donors = list(order[::-1])
    for u in order:
        while len(buckets[u]) < min_per_client:
            d = donors[0]
            if len(buckets[d]) <= min_per_client:
                break
            buckets[u].append(buckets[d].pop())
    n_max = max(len(b) for b in buckets)
    out = np.full((n_clients, n_max), -1, np.int32)
    sizes = np.zeros((n_clients,), np.int32)
    for u, b in enumerate(buckets):
        out[u, :len(b)] = np.asarray(b, np.int32)
        sizes[u] = len(b)
    return out, sizes


def label_distribution(labels, client_idx, n_classes):
    """Per-client class histogram — used by tests to verify non-IID-ness."""
    m = client_idx.shape[0]
    hist = np.zeros((m, n_classes), np.int64)
    for u in range(m):
        sel = client_idx[u][client_idx[u] >= 0]
        if len(sel):
            hist[u] = np.bincount(labels[sel], minlength=n_classes)
    return hist