"""Non-IID client partitioners (paper §V-D, Table III): a copy of
``repro/data/noniid.py`` (numpy only), kept in the port so that
``repro_torch`` imports nothing of the JAX package.

The paper's Non-IID knob is "number of data classes per client"; we provide
that partitioner plus the standard Dirichlet one.
"""
from __future__ import annotations

import numpy as np


def partition_by_classes(labels: np.ndarray, n_clients: int,
                         classes_per_client: int, seed: int = 0
                         ) -> list[np.ndarray]:
    """Each client sees exactly `classes_per_client` classes (paper Table III)."""
    rng = np.random.default_rng(seed)
    classes = np.unique(labels)
    assignments = [rng.choice(classes, size=classes_per_client, replace=False)
                   for _ in range(n_clients)]
    by_class = {c: rng.permutation(np.nonzero(labels == c)[0]) for c in classes}
    cursors = {c: 0 for c in classes}
    # count how many clients want each class to split fairly
    want = {c: sum(int(c in a) for a in assignments) for c in classes}
    out = []
    for a in assignments:
        idx = []
        for c in a:
            pool = by_class[c]
            share = len(pool) // max(want[c], 1)
            lo = cursors[c]
            idx.append(pool[lo:lo + share])
            cursors[c] += share
        out.append(np.concatenate(idx) if idx else np.empty((0,), np.int64))
    return out


def dirichlet_partition(labels: np.ndarray, n_clients: int,
                        alpha: float = 0.5, seed: int = 0) -> list[np.ndarray]:
    rng = np.random.default_rng(seed)
    classes = np.unique(labels)
    out: list[list[int]] = [[] for _ in range(n_clients)]
    for c in classes:
        idx = rng.permutation(np.nonzero(labels == c)[0])
        props = rng.dirichlet(np.full(n_clients, alpha))
        cuts = (np.cumsum(props)[:-1] * len(idx)).astype(int)
        for client, part in enumerate(np.split(idx, cuts)):
            out[client].extend(part.tolist())
    return [np.asarray(sorted(x)) for x in out]
