"""Ragged (size-skewed) federated cohorts: port of ``client_lengths`` and
``pad_compatible`` from ``src/repro/data/ragged.py``, on torch tensors.

The paper's Dirichlet partitions (§4.3/4.4: Kvasir, the Camelyon
histology task) give every client its own number of examples. The port's
engine runs clients one at a time and takes each client's steps from its
own length, so a ragged cohort needs no padding here; ``pad_stack`` and
the masked sampler serve a stacked executor (ROADMAP.md Queue 1 item 5).

* :func:`client_lengths` — per-client example counts (the leading dim all
  of a client's leaves share).
* :func:`pad_compatible` — could the cohort be stacked with padding: one
  tree structure, and each leaf position agrees on dtype and trailing
  dims across clients (only the leading dim may differ).
"""
from __future__ import annotations

from typing import Any, Sequence

import numpy as np

from ..nn.modules import tree_leaves


def client_lengths(data: Sequence[Any]) -> np.ndarray:
    """int64[K] per-client example counts; raises when a client's leaves
    disagree on the leading (example) dim or one is a scalar."""
    out = []
    for k, d in enumerate(data):
        leaves = tree_leaves(d)
        if not leaves:
            raise ValueError(f"client {k} has an empty data pytree")
        ns = {x.shape[0] if getattr(x, "ndim", 0) else None for x in leaves}
        if len(ns) != 1 or None in ns:
            raise ValueError(
                f"client {k}'s leaves disagree on the leading (example) "
                f"dim: {sorted(tuple(x.shape) for x in leaves)}")
        out.append(leaves[0].shape[0])
    return np.asarray(out, np.int64)


def _structure(tree) -> Any:
    """The container skeleton of a tree, in the port's visiting order
    (dict keys sorted)."""
    if tree is None:
        return "none"
    if isinstance(tree, dict):
        return ("dict", tuple((k, _structure(tree[k])) for k in sorted(tree)))
    if isinstance(tree, (tuple, list)):
        return (type(tree).__name__, tuple(_structure(t) for t in tree))
    return "leaf"


def pad_compatible(data: Sequence[Any]) -> bool:
    """True iff the cohort could run on a stacked executor: one shared
    tree structure, and each leaf position agrees on dtype and trailing
    dims across clients (leading dims are free to differ)."""
    if len(data) == 0:
        return False
    try:
        if len({_structure(d) for d in data}) != 1:
            return False
        client_lengths(data)
        sigs = {tuple((x.dtype, tuple(x.shape[1:])) for x in tree_leaves(d))
                for d in data}
        return len(sigs) == 1
    except (ValueError, AttributeError):
        return False
