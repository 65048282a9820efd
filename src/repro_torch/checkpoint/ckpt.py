"""Checkpointing: param and optimizer trees <-> ``.npz`` + path manifest
(port of ``src/repro/checkpoint/ckpt.py``).

Leaves are stored under '/'-joined key paths, the reference's convention
(dict keys in sorted order, sequences by ``[index]``, NamedTuple fields by
name, ``None`` no leaf), so a snapshot is inspectable with plain numpy and
the two frameworks read each other's files. Restoration matches leaves BY
KEY PATH, never by flatten order: a checkpoint whose key set disagrees
with the template raises a descriptive error listing the missing and
unexpected keys instead of loading values into the wrong slots.

A torch leaf is written from the host: bf16 (which numpy lacks) widened
to f32, losslessly, with ``"bfloat16"`` in the manifest as the reference
writes it; integer and bool leaves keep their width. On restore each leaf
takes the template leaf's dtype and device.
"""
from __future__ import annotations

import json
import os
from typing import Any, Callable, Dict, Iterator, Tuple

import numpy as np
import torch


def _path_items(tree, prefix: Tuple[str, ...] = ()) -> Iterator:
    """(path, leaf) pairs in the reference's flatten order: dict keys
    sorted, sequences by ``[index]``, NamedTuples by field name; None is an
    empty subtree."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _path_items(tree[k], prefix + (str(k),))
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for name, v in zip(tree._fields, tree):
            yield from _path_items(v, prefix + (name,))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _path_items(v, prefix + (f"[{i}]",))
    else:
        yield "/".join(prefix), tree


def flatten_with_paths(tree) -> Dict[str, Any]:
    """Leaf dict keyed by '/'-joined path; rejects ambiguous (colliding)
    key paths up front — a collision would otherwise drop a leaf and
    corrupt whichever restore consumed the checkpoint. The commitment
    layer (:mod:`repro_torch.core.commit`) flattens proxy trees with this
    same function, so a commitment computed from live state and one
    recomputed from the checkpoint agree by construction."""
    flat: Dict[str, Any] = {}
    for key, leaf in _path_items(tree):
        if key in flat:
            raise ValueError(
                f"pytree produces duplicate checkpoint key path {key!r}; "
                "rename the colliding nodes before checkpointing")
        flat[key] = leaf
    return flat


def _map_with_paths(fn: Callable[[str, Any], Any], tree,
                    prefix: Tuple[str, ...] = ()):
    """``tree`` with each leaf replaced by ``fn(path, leaf)``, keeping the
    structure (dicts, lists, tuples, NamedTuples; None stays None)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _map_with_paths(fn, v, prefix + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[_map_with_paths(fn, v, prefix + (name,))
                            for name, v in zip(tree._fields, tree)])
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_with_paths(fn, v, prefix + (f"[{i}]",))
                          for i, v in enumerate(tree))
    return fn("/".join(prefix), tree)


def dtype_name(v) -> str:
    """A leaf's dtype as numpy names it (``"float32"``, ``"bfloat16"``,
    ``"int32"``, ``"bool"``...), the manifest's vocabulary."""
    if isinstance(v, torch.Tensor):
        return str(v.dtype).removeprefix("torch.")
    return str(np.asarray(v).dtype)


def host_array(v) -> np.ndarray:
    """The array a leaf is stored as: a torch leaf detached and on the
    host, bf16 and other dtypes outside numpy's float/int/bool kinds
    widened to f32 (lossless for bf16)."""
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu()
        if v.dtype == torch.bfloat16:
            v = v.to(torch.float32)
        v = v.numpy()
    a = np.asarray(v)
    if a.dtype.kind not in "fiub" or str(a.dtype) == "bfloat16":
        # npz has no bf16/fp8 codecs; store widened (lossless into f32)
        a = a.astype(np.float32)
    return a


def _npz_path(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def manifest_path(path: str) -> str:
    return (path[:-4] if path.endswith(".npz") else path) + ".json"


def save_checkpoint(path: str, tree) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    flat = flatten_with_paths(tree)
    np.savez(_npz_path(path), **{k: host_array(v) for k, v in flat.items()})
    manifest = {k: {"shape": list(np.shape(v)), "dtype": dtype_name(v)}
                for k, v in flat.items()}
    with open(manifest_path(path), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)


def _like_leaf(arr: np.ndarray, leaf):
    """``arr`` in the template leaf's type, dtype and device."""
    if isinstance(leaf, torch.Tensor):
        # a copy keeps a 0-d leaf 0-d (ascontiguousarray would not)
        return torch.from_numpy(np.array(arr)).to(device=leaf.device,
                                                  dtype=leaf.dtype)
    if hasattr(leaf, "dtype"):
        return np.asarray(arr).astype(leaf.dtype)
    return np.asarray(arr)


def load_checkpoint(path: str, like) -> Any:
    """Restore into the structure of ``like``, matching leaves by key path.

    Raises ``KeyError`` when the checkpoint's key set and the template's
    disagree (listing the missing / unexpected paths) and ``ValueError``
    on a per-leaf shape mismatch.
    """
    keyed: Dict[str, Any] = {}
    for key, leaf in _path_items(like):
        if key in keyed:
            raise ValueError(
                f"restore template produces duplicate key path {key!r}")
        keyed[key] = leaf
    with np.load(_npz_path(path)) as npz:
        have = set(npz.files)
        missing = sorted(set(keyed) - have)
        unexpected = sorted(have - set(keyed))
        if missing or unexpected:
            raise KeyError(
                f"checkpoint {_npz_path(path)!r} does not match the restore "
                f"template: missing keys {missing or 'none'}, "
                f"unexpected keys {unexpected or 'none'}")

        def restore(key, leaf):
            arr = npz[key]
            if arr.shape != tuple(np.shape(leaf)):
                raise ValueError(
                    f"checkpoint leaf {key!r} has shape {arr.shape}, "
                    f"template expects {tuple(np.shape(leaf))}")
            return _like_leaf(arr, leaf)

        return _map_with_paths(restore, like)
