"""Ragged (size-skewed) federated cohorts: port of
``src/repro/data/ragged.py`` on torch tensors.

The paper's Dirichlet partitions (§4.3/4.4: Kvasir, the Camelyon
histology task) give every client its own number of examples. The loop
executor takes each client's data as it is; the stacked executor of
``repro_torch.core.engine`` pads the cohort to one ``[K, N_max, ...]``
stack (:func:`pad_stack`) and draws each client's batch indices below its
own length ``n_valid[k]``, so a padding row is never read, and in epoch
mode freezes a client once it has taken its ``n_k // B`` steps.

* :func:`client_lengths` — per-client example counts (the leading dim all
  of a client's leaves share).
* :func:`pad_compatible` — can the cohort be stacked with padding: one
  tree structure, and each leaf position agrees on dtype and trailing
  dims across clients (only the leading dim may differ).
* :func:`pad_stack` — the padded stack and the valid lengths.
"""
from __future__ import annotations

import math
from typing import Any, Sequence, Tuple

import numpy as np
import torch

from ..nn.modules import tree_leaves, tree_map


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


def pad_stack(data: Sequence[Any], fill: float = 0
              ) -> Tuple[Any, torch.Tensor]:
    """Stack a (possibly ragged) cohort into one ``[K, N_max, ...]`` tree.

    Returns ``(stacked, n_valid)`` with ``n_valid`` int64[K] on the data's
    device. A rectangular cohort stacks as it is (no padding rows,
    ``n_valid`` constant). ``fill`` is the padding value, which is never
    read: the tests pad with NaN to show it (an integer leaf takes its
    dtype's least value for a non-finite fill, a label no loss can index).
    A client without examples cannot be sampled and is refused."""
    n_valid = client_lengths(data)
    if (n_valid <= 0).any():
        raise ValueError(
            "clients with zero examples cannot be sampled: "
            f"per-client sizes {n_valid.tolist()}")
    n_max = int(n_valid.max())

    def pad(x):
        short = n_max - x.shape[0]
        if short == 0:
            return x
        value = fill
        if not x.is_floating_point() and not math.isfinite(fill):
            value = torch.iinfo(x.dtype).min
        return torch.cat([x, torch.full((short,) + tuple(x.shape[1:]), value,
                                        dtype=x.dtype, device=x.device)])

    padded = [tree_map(pad, d) for d in data]
    stacked = tree_map(lambda *xs: torch.stack(xs), padded[0], *padded[1:])
    device = tree_leaves(data[0])[0].device
    return stacked, torch.as_tensor(n_valid, dtype=torch.int64,
                                    device=device)
