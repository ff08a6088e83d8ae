"""Client data partitioning, port of ``repro.fl.partition``: Dirichlet
non-IID and domain skew.

Plain numpy, so this copy reproduces the JAX package's partitions bit
for bit (same ``RandomState`` streams). ``dirichlet_partition`` is the
standard non-IID benchmark protocol (labels ~ Dir(alpha) per client);
``domain_partition`` assigns each client a dominant domain (PACS-style
heterogeneity). Both keep every sample exactly once.
"""
from __future__ import annotations

from typing import List

import numpy as np


def dirichlet_partition(labels: np.ndarray, n_clients: int, alpha: float,
                        seed: int = 0) -> List[np.ndarray]:
    rng = np.random.RandomState(seed)
    n_classes = int(labels.max()) + 1
    idx_by_class = [np.where(labels == c)[0] for c in range(n_classes)]
    for idx in idx_by_class:
        rng.shuffle(idx)
    client_idx: List[list] = [[] for _ in range(n_clients)]
    for c, idx in enumerate(idx_by_class):
        if len(idx) == 0:
            continue
        props = rng.dirichlet([alpha] * n_clients)
        cuts = (np.cumsum(props)[:-1] * len(idx)).astype(int)
        for i, part in enumerate(np.split(idx, cuts)):
            client_idx[i].extend(part.tolist())
    out = []
    for i in range(n_clients):
        a = np.asarray(sorted(client_idx[i]), np.int64)
        out.append(a)
    return out


def domain_partition(domains: np.ndarray, n_clients: int,
                     skew: float = 0.8, seed: int = 0) -> List[np.ndarray]:
    """Each client draws ``skew`` of its data from one dominant domain."""
    rng = np.random.RandomState(seed)
    n_dom = int(domains.max()) + 1
    pools = [list(np.where(domains == d)[0]) for d in range(n_dom)]
    for p in pools:
        rng.shuffle(p)
    n = len(domains)
    per = n // n_clients
    available = set(range(n))
    out = []
    for i in range(n_clients):
        dom = i % n_dom
        want_dom = int(per * skew)
        sel = []
        while pools[dom] and len(sel) < want_dom:
            j = pools[dom].pop()
            if j in available:
                sel.append(j)
                available.discard(j)
        rest = sorted(available)
        rng.shuffle(rest)
        for j in rest[:per - len(sel)]:
            sel.append(j)
            available.discard(j)
        out.append(np.asarray(sorted(sel), np.int64))
    return out


def class_histogram(labels: np.ndarray, idx: np.ndarray,
                    n_classes: int) -> np.ndarray:
    return np.bincount(labels[idx], minlength=n_classes)
