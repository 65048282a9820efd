"""PushSum gossip on time-varying directed graphs (paper §3.4), synchronous
part; port of ``src/repro/core/gossip.py``.

The schedule functions (:func:`exponential_offsets`, :func:`gossip_shift`,
:func:`adjacency_matrix`, :func:`mix_matrix`) are numpy, copied verbatim, so
they are array-equal to the reference. The exchange itself runs on the
stacked ``[K, D]`` proxies: plain torch products, or the hand-written mix
kernel under ``use_pallas``.
"""
from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np
import torch

from ..kernels import fused_pushsum_mix


def exponential_offsets(n_clients: int) -> List[int]:
    """Peer offsets 2^0, 2^1, ..., 2^⌊log2(K-1)⌋ (Assran et al. 2019)."""
    if n_clients <= 1:
        return [0]
    return [2 ** p for p in range(int(math.floor(math.log2(n_clients - 1))) + 1)]


def gossip_shift(t: int, n_clients: int, topology: str = "exponential") -> int:
    if n_clients <= 1:
        return 0
    if topology == "exponential":
        offs = exponential_offsets(n_clients)
        return offs[t % len(offs)]
    if topology == "ring":
        return 1
    if topology == "full":
        return -1  # sentinel: dense averaging
    raise ValueError(topology)


def adjacency_matrix(t: int, n_clients: int, topology: str = "exponential",
                     self_weight: float = 0.5, active=None) -> np.ndarray:
    """Column-stochastic P^(t): column k holds the weights client k SENDS.

    ``active`` (bool mask, len K) drops clients out of the round (paper
    §3.4: the time-varying graph "can adapt to clients joining or dropping
    out"): inactive clients keep their own state (P_kk = 1) and neither
    send nor receive; the exponential/ring shift is applied on the ACTIVE
    subset so the graph stays connected. Column-stochasticity — and
    therefore PushSum's mass conservation and de-biased convergence to the
    average of the ACTIVE participants — is preserved.
    """
    K = n_clients
    if K == 1:
        return np.ones((1, 1))
    if active is None:
        active_idx = np.arange(K)
    else:
        active = np.asarray(active, bool)
        assert active.shape == (K,)
        active_idx = np.where(active)[0]
    A = len(active_idx)
    P = np.eye(K)  # inactive clients: identity column
    if A <= 1:
        return P
    shift = gossip_shift(t, A, topology)
    if shift == -1:  # dense uniform mixing among active
        for a_pos, k in enumerate(active_idx):
            P[k, k] = 0.0
            for b_pos, j in enumerate(active_idx):
                P[j, k] = 1.0 / A
    else:
        for a_pos, k in enumerate(active_idx):
            P[k, k] = self_weight
            peer = active_idx[(a_pos + shift) % A]
            P[peer, k] += 1.0 - self_weight
    assert np.allclose(P.sum(axis=0), 1.0)
    return P


def mix_matrix(mix: str, t: int, n_clients: int, topology: str = "exponential",
               active=None, self_weight: float = 0.5) -> np.ndarray:
    """Column-stochastic mixing matrix for ONE federated exchange.

    Every aggregation rule in the METHODS table is a K×K column-stochastic
    matrix applied to the stacked client vectors (plus PushSum de-biasing,
    which is the identity whenever the matrix keeps w at 1):

    * ``"pushsum"`` — the paper's §3.4 time-varying graph P^(t) (ProxyFL,
      AvgPush);
    * ``"mean"``    — uniform averaging among active clients (FedAvg, FML's
      central proxy server);
    * ``"ring"``    — cyclical weight transfer: a pure permutation, client k
      receives client k-1's model (CWT);
    * ``"none"``    — no exchange (Regular / Joint).

    ``active`` masks out dropped clients exactly as in
    :func:`adjacency_matrix`: they keep their own state (identity column)
    and neither send nor receive.
    """
    if mix == "none":
        return np.eye(n_clients)
    if mix == "pushsum":
        return adjacency_matrix(t, n_clients, topology, self_weight, active)
    if mix == "mean":
        return adjacency_matrix(t, n_clients, "full", self_weight, active)
    if mix == "ring":
        return adjacency_matrix(t, n_clients, "ring", 0.0, active)
    raise ValueError(mix)


# ---------------------------------------------------------------------------
# the stacked exchange: Θ^(t+1) = P^(t) Θ^(t)


def _as_matrix(P, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(P, dtype=like.dtype, device=like.device)


def pushsum_mix(thetas: torch.Tensor, weights: torch.Tensor, P, *,
                use_pallas: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """thetas: [K, D] stacked client vectors; weights: [K] de-bias weights.
    Returns mixed (thetas, weights) — NOT yet de-biased. ``use_pallas``
    routes through the mix kernel (f32 accumulation)."""
    if use_pallas:
        return fused_pushsum_mix(thetas, weights, P, debias=False)
    return _as_matrix(P, thetas) @ thetas, _as_matrix(P, weights) @ weights


def pushsum_mix_debiased(thetas: torch.Tensor, weights: torch.Tensor, P, *,
                         use_pallas: bool = False
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The engine's whole stacked exchange (Algorithm 1 lines 7-11):
    ``z' = (P·z) / (P·w)[:, None]``, ``w' = P·w`` — mix AND de-bias, plain
    torch or the mix kernel with the de-bias fused (``use_pallas``). The
    compressed exchange is not ported yet (ROADMAP.md Queue 1 item 16)."""
    if use_pallas:
        return fused_pushsum_mix(thetas, weights, P, debias=True)
    mixed = _as_matrix(P, thetas) @ thetas
    w2 = _as_matrix(P, weights) @ weights
    return mixed / w2[:, None], w2


def debias(thetas: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """θ_k / w_k (Algorithm 1 line 11)."""
    return thetas / weights[:, None]
