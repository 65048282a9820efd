"""Federated partitioners reproducing the paper's non-IID structures:

* ``partition_major`` — §4.1: each client gets one randomly-assigned major
  class contributing fraction ``p_major`` of its data, rest IID.
  (p_major = 1/n_classes is the IID setting.)
* ``partition_dirichlet`` — §4.3/4.4: class proportions per client drawn
  from Dirichlet(alpha) (Yurochkin et al. 2019).
"""
from __future__ import annotations

from typing import List

import numpy as np


def partition_major(
    rng: np.random.Generator,
    y: np.ndarray,
    n_clients: int,
    per_client: int,
    p_major: float,
    n_classes: int,
) -> List[np.ndarray]:
    """Returns per-client index arrays into the source dataset (disjoint)."""
    pools = {c: list(rng.permutation(np.where(y == c)[0])) for c in range(n_classes)}
    majors = rng.integers(0, n_classes, size=n_clients)
    out = []
    n_major = int(round(p_major * per_client))
    for k in range(n_clients):
        idx = []
        mc = int(majors[k])
        take = min(n_major, len(pools[mc]))
        idx.extend(pools[mc][:take])
        pools[mc] = pools[mc][take:]
        # remaining drawn IID from the other classes
        others = [c for c in range(n_classes) if c != mc and pools[c]]
        while len(idx) < per_client and others:
            c = int(rng.choice(others))
            idx.append(pools[c].pop())
            others = [c for c in others if pools[c]]
        out.append(np.array(idx[:per_client], dtype=np.int64))
    return out


def partition_dirichlet(
    rng: np.random.Generator,
    y: np.ndarray,
    n_clients: int,
    alpha: float,
) -> List[np.ndarray]:
    n_classes = int(y.max()) + 1
    idx_by_class = [rng.permutation(np.where(y == c)[0]) for c in range(n_classes)]
    client_idx: List[list] = [[] for _ in range(n_clients)]
    for c in range(n_classes):
        props = rng.dirichlet([alpha] * n_clients)
        cuts = (np.cumsum(props) * len(idx_by_class[c])).astype(int)[:-1]
        for k, part in enumerate(np.split(idx_by_class[c], cuts)):
            client_idx[k].extend(part.tolist())
    return [np.array(sorted(ix), dtype=np.int64) for ix in client_idx]
