"""Linear layers and parameter-tree utilities (port of the parts of
``src/repro/nn/modules.py`` the ProxyFL round uses).

Parameters are nested dicts of tensors with the reference's key paths and
leaf shapes; a linear weight is ``[d_in, d_out]`` and applies as ``x @ w``.
Leaves are visited as ``jax.tree_util`` visits a nested dict — keys sorted
at every level — so :func:`tree_flatten_vector` gives the same ``[D]`` wire
vector as the reference (for ``mlp``: fc1/b, fc1/w, fc2/b, fc2/w, fc3/b,
fc3/w).
"""
from __future__ import annotations

from typing import Any, Callable, List, Optional

import torch

Params = dict


def _children(tree) -> Optional[List]:
    """The ordered subtrees of a container node, or None for a leaf. Dicts
    go in sorted-key order, tuples (NamedTuples included) and lists in
    order; None is an empty subtree, as in jax.tree_util."""
    if isinstance(tree, dict):
        return [tree[k] for k in sorted(tree)]
    if isinstance(tree, (tuple, list)):
        return list(tree)
    return None


def tree_leaves(tree) -> List[torch.Tensor]:
    if tree is None:
        return []
    kids = _children(tree)
    if kids is None:
        return [tree]
    return [leaf for kid in kids for leaf in tree_leaves(kid)]


def tree_map(fn: Callable, tree, *rest) -> Any:
    """``fn`` over the leaves of ``tree`` (and the matching leaves of
    ``rest``), keeping the structure: dicts, tuples, NamedTuples, lists.
    Leaves are visited in :func:`tree_leaves` order."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, (tuple, list)):
        out = [tree_map(fn, t, *(r[i] for r in rest))
               for i, t in enumerate(tree)]
        return type(tree)(*out) if hasattr(tree, "_fields") else type(tree)(out)
    return fn(tree, *rest)


def init_linear(generator: torch.Generator, d_in: int, d_out: int,
                bias: bool = False, scale: float = 0.02,
                dtype=torch.float32) -> Params:
    p = {"w": scale * torch.randn((d_in, d_out), generator=generator,
                                  dtype=dtype, device=generator.device)}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=generator.device)
    return p


def linear(p: Params, x: torch.Tensor) -> torch.Tensor:
    y = x @ p["w"]
    if "b" in p:
        y = y + p["b"]
    return y


def tree_size(tree) -> int:
    return sum(int(x.numel()) for x in tree_leaves(tree))


def tree_bytes(tree) -> int:
    return sum(int(x.numel() * x.element_size()) for x in tree_leaves(tree))


def tree_flatten_vector(tree) -> torch.Tensor:
    """Concatenate every leaf into one 1-D vector (proxy wire format)."""
    leaves = tree_leaves(tree)
    if not leaves:
        return torch.zeros((0,))
    return torch.cat([x.reshape(-1) for x in leaves])


def tree_unflatten_vector(vec: torch.Tensor, like) -> Any:
    """Inverse of :func:`tree_flatten_vector` against the structure, shapes
    and dtypes of ``like``."""
    pieces = iter(torch.split(vec, [x.numel() for x in tree_leaves(like)]))
    return tree_map(
        lambda leaf: next(pieces).reshape(leaf.shape).to(leaf.dtype), like)


def tree_global_norm(tree) -> torch.Tensor:
    leaves = tree_leaves(tree)
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in leaves))
