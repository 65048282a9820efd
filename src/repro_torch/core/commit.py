"""Per-round proxy commitments: the hash-chained audit trail (port of
``src/repro/core/commit.py``).

* Every RELEASED proxy is committed to by a **client commitment**: a
  sha256 over the sorted ``(leaf path, chunked leaf digest)`` pairs of its
  parameter tree, each leaf digest a sha256 over the sha256 digests of
  fixed-size chunks of the leaf's canonical bytes (bf16 and other exotic
  dtypes widened to f32, as the reference's checkpoint writes them).
* Snapshots form a **hash chain** ``h_t = H(h_{t-1} || round metadata ||
  client commitments)`` anchored at :data:`GENESIS`.
* Mismatches raise :class:`CommitmentError`, naming what is known of the
  round, the leaf and the client.

Everything is host-side ``hashlib`` and ``numpy`` over canonical bytes, so
identical params give string-equal digests in this package and in the
reference: a torch leaf goes ``.detach().cpu()``, bf16 widened to f32,
then to a contiguous numpy array; the leaf paths are the reference's
'/'-joined key paths
(:func:`repro_torch.checkpoint.ckpt.flatten_with_paths`). The engine's loop
backend verifies received proxies against their senders' declared
commitments under ``cfg.verify_commitments``
(:meth:`repro_torch.core.engine.FederationEngine._verified_exchange`).
:class:`repro_torch.checkpoint.FederationCheckpointer` stamps
``commitment``/``prev_commitment`` into every snapshot's ``.meta.json``,
appends one entry per snapshot (client commitments and leaf digests,
:func:`snapshot_client_digests` over the npz it wrote) to
``audit.jsonl`` with :func:`chain_step`, and replays the chain and
recomputes the restored round's digests before a restore.
"""
from __future__ import annotations

import hashlib
import json
from typing import Any, Dict, Optional, Tuple

import numpy as np

from ..checkpoint.ckpt import flatten_with_paths, host_array

# the chain's anchor: h_0's predecessor, a fixed public constant
GENESIS = "0" * 64

# leaves are digested in fixed 1 MiB chunks of their canonical bytes; the
# chunk size is part of the commitment's definition
CHUNK_BYTES = 1 << 20

# key-path namespace of the committed leaves inside a snapshot payload:
# clients/c0042/proxy/params/<leaf...> (private models are never committed)
CLIENT_KEY_FMT = "c{:04d}"
PROXY_PREFIX = "proxy/params/"


class CommitmentError(ValueError):
    """A proxy commitment failed verification.

    Distinct from a configuration mismatch's ``ValueError``; ``round`` is
    the first divergent round, ``leaf`` the offending leaf path within the
    client's proxy tree, ``client`` the client index, whichever are known.
    """

    def __init__(self, message: str, *, round: Optional[int] = None,
                 leaf: Optional[str] = None, client: Optional[int] = None):
        super().__init__(message)
        self.round = round
        self.leaf = leaf
        self.client = client


def canon_array(v) -> np.ndarray:
    """The canonical array a leaf is committed to: what
    :func:`repro_torch.checkpoint.ckpt.save_checkpoint` stores (a torch
    leaf on the host, bf16 and other exotic dtypes widened to f32),
    contiguous; byte-identical to the reference's canonical array of the
    same values, so live-state and npz-recomputed commitments agree."""
    return np.ascontiguousarray(host_array(v))


def leaf_digest(arr, chunk_bytes: int = CHUNK_BYTES) -> str:
    """Chunked sha256 digest of one leaf: a shape/dtype header, then the
    sha256 of every ``chunk_bytes`` slice of the canonical bytes."""
    a = canon_array(arr)
    outer = hashlib.sha256()
    outer.update(f"{a.dtype.str}|{a.shape}|{chunk_bytes}".encode())
    raw = a.tobytes()
    for off in range(0, max(len(raw), 1), chunk_bytes):
        outer.update(hashlib.sha256(raw[off:off + chunk_bytes]).digest())
    return outer.hexdigest()


def proxy_leaves(proxy_params) -> Dict[str, Any]:
    """``{leaf path: tensor}`` of a client's released proxy parameters,
    relative to the ``proxy/params/`` namespace."""
    return flatten_with_paths(proxy_params)


def client_commitment(proxy_params) -> Tuple[str, Dict[str, str]]:
    """Commitment of one client's released proxy: sha256 over the sorted
    ``(leaf path, leaf digest)`` pairs. Returns ``(digest, per-leaf
    digests)``."""
    leaves = {path: leaf_digest(a)
              for path, a in proxy_leaves(proxy_params).items()}
    blob = json.dumps(leaves, sort_keys=True).encode()
    return hashlib.sha256(blob).hexdigest(), leaves


def chain_step(prev: str, rounds_done: int, n_clients: int,
               client_digests: Dict[str, str]) -> str:
    """One link of the snapshot hash chain: ``h_t = H(h_{t-1} ||
    {rounds_done, n_clients} || client commitments)``; ``client_digests``
    maps ``c0042``-style client keys to :func:`client_commitment`
    digests."""
    blob = json.dumps({"prev": prev,
                       "meta": {"rounds_done": int(rounds_done),
                                "n_clients": int(n_clients)},
                       "clients": client_digests},
                      sort_keys=True).encode()
    return hashlib.sha256(blob).hexdigest()


def npz_client_leaves(arrays: Dict[str, Any], k: int) -> Dict[str, Any]:
    """Client ``k``'s committed proxy leaves of a flat snapshot mapping
    (an open ``np.load`` handle or a dict keyed by '/'-joined payload
    paths), keyed relative to ``proxy/params/``."""
    prefix = f"clients/{CLIENT_KEY_FMT.format(k)}/{PROXY_PREFIX}"
    return {key[len(prefix):]: arrays[key]
            for key in arrays if key.startswith(prefix)}


def snapshot_client_digests(arrays: Dict[str, Any], n_clients: int
                            ) -> Tuple[Dict[str, str],
                                       Dict[str, Dict[str, str]]]:
    """Per-client commitments of a whole snapshot's released proxies:
    ``(digests, leaf_digests)`` keyed by ``c0042``-style client keys."""
    digests: Dict[str, str] = {}
    leaves_out: Dict[str, Dict[str, str]] = {}
    for k in range(n_clients):
        ckey = CLIENT_KEY_FMT.format(k)
        digests[ckey], leaves_out[ckey] = client_commitment(
            npz_client_leaves(arrays, k))
    return digests, leaves_out
