"""Non-IID data partitioning (paper §G.1: Dirichlet with concentration α)."""
from __future__ import annotations

from typing import List

import numpy as np


def dirichlet_partition(
    labels: np.ndarray, n_clients: int, alpha: float = 1.0, seed: int = 0,
    min_per_client: int = 2,
) -> List[np.ndarray]:
    """Split sample indices among clients with Dirichlet(α) class mixtures."""
    rng = np.random.default_rng(seed)
    classes = np.unique(labels)
    client_idx: List[List[int]] = [[] for _ in range(n_clients)]
    for c in classes:
        idx = np.nonzero(labels == c)[0]
        rng.shuffle(idx)
        props = rng.dirichlet(np.full(n_clients, alpha))
        cuts = (np.cumsum(props) * len(idx)).astype(int)[:-1]
        for k, part in enumerate(np.split(idx, cuts)):
            client_idx[k].extend(part.tolist())
    # ensure every client has a floor of samples
    all_idx = np.arange(len(labels))
    out = []
    for k in range(n_clients):
        idx = np.asarray(client_idx[k], np.int64)
        if len(idx) < min_per_client:
            extra = rng.choice(all_idx, min_per_client - len(idx), replace=False)
            idx = np.concatenate([idx, extra])
        rng.shuffle(idx)
        out.append(idx)
    return out
