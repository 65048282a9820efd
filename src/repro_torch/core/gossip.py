"""PushSum gossip on time-varying directed graphs (paper §3.4): the
synchronous exchange, the async backend's stale (τ>0) exchange and the hier
backend's two-level factored exchange; port of ``src/repro/core/gossip.py``.

The schedule functions (:func:`exponential_offsets`, :func:`gossip_shift`,
:func:`adjacency_matrix`, :func:`mix_matrix`, the round-block schedules
:func:`shift_schedule`, :func:`adjacency_schedule`, :func:`mix_schedule`,
the stale split :func:`stale_mix_split`, :func:`stale_mix_schedule` and the
numpy oracle :func:`stale_gossip_reference`; the hier factoring
:func:`hier_layout`, :func:`hier_mix_split`, :func:`hier_mix_schedule` and
its oracle :func:`hier_gossip_reference`) are numpy, copied verbatim, so
they are array-equal to the reference. The exchanges run on the stacked
``[K, D]`` proxies: plain torch products, or the hand-written kernels under
``use_pallas`` (:func:`pushsum_mix_debiased` through the mix kernel,
:func:`stale_mix_apply` through the stale-mix kernel, the hier exchanges
:func:`hier_mix_debiased` and :func:`hier_stale_mix_apply` through the
shard-grid entry of the mix kernel), or the compressed
exchange of :mod:`repro_torch.core.compress` (plain torch, no kernel).
:func:`comm_cost_per_round` is the analytic communication model of fig. 4.
"""
from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np
import torch

from ..kernels import (fused_pushsum_mix, fused_pushsum_mix_blocks,
                       fused_stale_mix)
from .compress import compressed_pushsum_mix, compressed_stale_mix


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
                         use_pallas: bool = False, compress=None,
                         ef_state=None, noise=None):
    """The engine's whole stacked exchange (Algorithm 1 lines 7-11):
    ``z' = (P·z) / (P·w)[:, None]``, ``w' = P·w`` — mix AND de-bias, plain
    torch or the mix kernel with the de-bias fused (``use_pallas``).

    ``compress`` (a :class:`repro_torch.core.compress.CompressionSpec`)
    runs the compressed exchange instead: each sender transmits a
    compressed delta against its public copy ``ef_state`` [K, D] (int8
    rounds with ``noise``, U[0,1) of that shape), receivers mix the updated
    dense copies, and the call returns ``(z', w', ef_state')``. It is plain
    torch and ignores ``use_pallas``: the mix kernel implements the
    uncompressed chain only."""
    if compress is not None:
        return compressed_pushsum_mix(thetas, weights, P, ef_state, noise,
                                      compress)
    if use_pallas:
        return fused_pushsum_mix(thetas, weights, P, debias=True)
    mixed = _as_matrix(P, thetas) @ thetas
    w2 = _as_matrix(P, weights) @ weights
    return mixed / w2[:, None], w2


def stale_mix_apply(flat: torch.Tensor, w: torch.Tensor, kept, sent,
                    buf_t0: torch.Tensor, buf_w0: torch.Tensor, *,
                    use_pallas: bool = False, compress=None, ef_state=None,
                    noise=None):
    """One stale (async τ>0) exchange on the stacked proxies — the
    delayed-delivery counterpart of :func:`pushsum_mix_debiased` and the
    on-device application of :func:`stale_gossip_reference`'s round body:
    re-bias θ = z·w, emit ``send = sent @ θ``, merge ``kept·θ`` with the
    delivery ``buf_t0``/``buf_w0`` rotating out of the in-flight buffer,
    de-bias by the identically-delayed weights. Returns ``(z', send_t,
    w', send_w)``; the caller owns the buffer rotation. ``use_pallas``
    fuses the whole chain into one pass of the stale-mix kernel
    (:func:`repro_torch.kernels.fused_stale_mix`).

    ``compress``/``ef_state``/``noise`` send the in-flight transmission
    (delta coding of the numerator θ against its public copy) through the
    codec as in :func:`pushsum_mix_debiased`: the return grows a trailing
    ``ef_state'`` and ``use_pallas`` is ignored (the stale-mix kernel is
    uncompressed only)."""
    if compress is not None:
        return compressed_stale_mix(flat, w, kept, sent, buf_t0, buf_w0,
                                    ef_state, noise, compress)
    if use_pallas:
        return fused_stale_mix(flat, w, kept, sent, buf_t0, buf_w0)
    theta = flat * w[:, None]                  # raw PushSum numerator
    send_t = _as_matrix(sent, flat) @ theta
    send_w = _as_matrix(sent, w) @ w
    mixed = _as_matrix(kept, flat)[:, None] * theta + buf_t0
    w2 = _as_matrix(kept, w) * w + buf_w0
    return mixed / w2[:, None], send_t, w2, send_w


def debias(thetas: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """θ_k / w_k (Algorithm 1 line 11)."""
    return thetas / weights[:, None]


# ---------------------------------------------------------------------------
# block schedules: P^(t0), ..., P^(t0+T-1) precomputed for a round-block


def shift_schedule(t0: int, T: int, n_active: int,
                   topology: str = "exponential") -> np.ndarray:
    """int[T] gossip shifts for rounds t0..t0+T-1 over ``n_active`` peers
    (-1 is the dense sentinel, matching :func:`gossip_shift`)."""
    ts = np.arange(t0, t0 + T)
    if n_active <= 1:
        return np.zeros(T, np.int64)
    if topology == "exponential":
        offs = np.asarray(exponential_offsets(n_active))
        return offs[ts % len(offs)]
    if topology == "ring":
        return np.ones(T, np.int64)
    if topology == "full":
        return -np.ones(T, np.int64)
    raise ValueError(topology)


def adjacency_schedule(t0: int, T: int, n_clients: int,
                       topology: str = "exponential",
                       self_weight: float = 0.5, active=None) -> np.ndarray:
    """Stacked column-stochastic P^(t0..t0+T-1): float64[T, K, K], with
    ``P[i] == adjacency_matrix(t0 + i, ...)`` exactly.

    ``active`` is None (everyone, every round) or bool[T, K] — one §3.4
    membership row per round. Construction is vectorized: rounds sharing a
    membership pattern are built together with batched scatters (no
    per-client Python loops), so a round-block's whole schedule costs a
    handful of numpy ops instead of T × K loop iterations.
    """
    K = n_clients
    P = np.broadcast_to(np.eye(K), (T, K, K)).copy()
    if K == 1 or T == 0:
        return P
    ts = np.arange(t0, t0 + T)
    if active is None:
        groups = [(np.arange(K), np.arange(T))]
    else:
        active = np.asarray(active, bool)
        assert active.shape == (T, K), (active.shape, (T, K))
        patterns, inverse = np.unique(active, axis=0, return_inverse=True)
        groups = [(np.where(patterns[g])[0], np.where(inverse == g)[0])
                  for g in range(len(patterns))]
    for idx, rows in groups:
        A = len(idx)
        if A <= 1:
            continue  # inactive-heavy round: identity (already in place)
        if topology == "exponential":
            offs = np.asarray(exponential_offsets(A))
            shifts = offs[ts[rows] % len(offs)]
        elif topology == "ring":
            shifts = np.ones(len(rows), np.int64)
        elif topology == "full":
            shifts = -np.ones(len(rows), np.int64)
        else:
            raise ValueError(topology)
        dense = shifts == -1
        if dense.any():
            P[np.ix_(rows[dense], idx, idx)] = 1.0 / A
        sparse = np.where(~dense)[0]
        if len(sparse):
            r = np.repeat(rows[sparse], A)
            col = np.tile(idx, len(sparse))
            P[r, col, col] = self_weight
            pos = np.arange(A)
            peers = idx[(pos[None, :] + shifts[sparse, None]) % A]
            np.add.at(P, (r, peers.reshape(-1), col), 1.0 - self_weight)
    assert np.allclose(P.sum(axis=1), 1.0)  # column-stochastic, every round
    return P


def mix_schedule(mix: str, t0: int, T: int, n_clients: int,
                 topology: str = "exponential", active=None,
                 self_weight: float = 0.5) -> np.ndarray:
    """Stacked mixing matrices for one round-block: float64[T, K, K] with
    ``out[i] == mix_matrix(mix, t0 + i, ...)`` exactly (same mix -> graph
    mapping as :func:`mix_matrix`; ``active`` is None or bool[T, K])."""
    if mix == "none":
        return np.broadcast_to(np.eye(n_clients), (T, n_clients, n_clients)).copy()
    if mix == "pushsum":
        return adjacency_schedule(t0, T, n_clients, topology, self_weight,
                                  active)
    if mix == "mean":
        return adjacency_schedule(t0, T, n_clients, "full", self_weight,
                                  active)
    if mix == "ring":
        return adjacency_schedule(t0, T, n_clients, "ring", 0.0, active)
    raise ValueError(mix)


# ---------------------------------------------------------------------------
# stale gossip: the async backend's diag/off-diag split of P^(t)
#
# The staleness-τ variant (Assran et al. 2019's overlap trick) splits every
# column of P^(t) into the mass a client KEEPS (the diagonal) and the mass
# it SENDS (the off-diagonal rest): sends computed at round t stay in flight
# and are delivered at round t+τ. The split operates on the RAW PushSum
# numerators θ = z·w, so the de-bias weights account for the in-flight mass
# exactly, and total θ- and w-mass (clients + buffer) is conserved round by
# round (kept_k + Σ_j sent_{jk} = Σ_j P_{jk} = 1).


def stale_mix_split(P):
    """Diag/off-diag split of column-stochastic matrices (batched over any
    leading dims): returns ``(kept[..., K], sent[..., K, K])`` with
    ``P == sent + diag_embed(kept)`` exactly — ``kept[k]`` is the mass
    client k retains this round, column ``sent[:, k]`` the mass it puts in
    flight."""
    P = np.asarray(P)
    K = P.shape[-1]
    idx = np.arange(K)
    kept = P[..., idx, idx].copy()
    sent = P.copy()
    sent[..., idx, idx] = 0.0
    return kept, sent


def stale_mix_schedule(mix: str, t0: int, T: int, n_clients: int,
                       topology: str = "exponential", active=None,
                       self_weight: float = 0.5):
    """Stacked stale-mix split for one round-block: ``(kept[T, K],
    sent[T, K, K])`` with ``sent[i] + diag(kept[i]) == mix_matrix(mix,
    t0 + i, ...)`` exactly (same mix -> graph mapping, ``active`` is None
    or bool[T, K])."""
    return stale_mix_split(mix_schedule(mix, t0, T, n_clients, topology,
                                        active=active,
                                        self_weight=self_weight))


def stale_gossip_reference(z0, w0, Ps, staleness: int):
    """Numpy reference of the staleness-τ PushSum exchange — the executable
    spec the async engine backend is held to.

    ``z0``: [K, D] de-biased client vectors; ``w0``: [K] de-bias weights;
    ``Ps``: iterable of [K, K] column-stochastic matrices (one per round,
    §3.4 active masking already applied). Per round t:

    1. re-bias:  θ(t) = z(t) · w(t)  (raw PushSum numerators);
    2. send:     ``sent(t) @ θ(t)`` and ``sent(t) @ w(t)`` enter a τ-deep
       in-flight buffer (delivered at round t+τ; the buffer starts empty —
       for the first τ rounds nothing arrives and the de-bias weights
       shrink to account for the mass in flight);
    3. deliver:  the round-(t−τ) sends leave the buffer and merge into
       ``mixed = kept(t)·θ(t) + recv`` and ``w' = kept(t)·w(t) + recv_w``;
    4. de-bias:  z(t+1) = mixed / w'.

    τ=0 degenerates to the synchronous exchange ``P @ θ`` / ``P @ w``.
    Returns ``(z, w, buf_theta[τ, K, D], buf_w[τ, K])`` after ``len(Ps)``
    rounds; buffer row 0 is the next delivery. Σ w + Σ buf_w == Σ w0 and
    Σ z·w + Σ buf_theta == Σ z0·w0 after every round, for any τ and any
    §3.4 dropout trajectory."""
    z = np.asarray(z0, np.float64)
    w = np.asarray(w0, np.float64)
    K, D = z.shape
    tau = int(staleness)
    buf_t = np.zeros((tau, K, D))
    buf_w = np.zeros((tau, K))
    for P in Ps:
        kept, sent = stale_mix_split(np.asarray(P, np.float64))
        theta = z * w[:, None]
        if tau == 0:
            mixed = (sent + np.diag(kept)) @ theta
            w = (sent + np.diag(kept)) @ w
        else:
            send_t, send_w = sent @ theta, sent @ w
            mixed = kept[:, None] * theta + buf_t[0]
            w = kept * w + buf_w[0]
            buf_t = np.concatenate([buf_t[1:], send_t[None]])
            buf_w = np.concatenate([buf_w[1:], send_w[None]])
        z = mixed / w[:, None]
    return z, w, buf_t, buf_w


# ---------------------------------------------------------------------------
# hierarchical gossip: the hier backend's two-level factoring of P^(t)
#
# A cohort of S shards × L clients-per-shard runs the SAME flat column-
# stochastic schedule P^(t), factored by edge locality: the entries whose
# sender and receiver share a shard form a block-diagonal [S, L, L] part
# (S independent [L, L] × [L, D] products, the shard-grid mix kernel under
# ``use_pallas``), and the cross-shard entries a scaled partial permutation
# (each client receives from at most one peer in another shard per round
# under the exponential and ring graphs). P = blockdiag + cross with
# disjoint supports, so the factored exchange moves the same mass as the
# flat one. Staleness delays the cross part only: its deliveries ride a
# τ-deep in-flight buffer while the intra-shard exchange stays synchronous.


def hier_layout(n_clients: int, n_shards: int) -> Tuple[int, int]:
    """Validated two-level cohort layout ``(S, L)``: client k lives in
    shard ``k // L`` at local index ``k % L``. ``n_shards`` must divide the
    cohort evenly (one [S, L, L] block shape for every shard)."""
    S = 1 if n_shards is None else int(n_shards)
    if S < 1 or S > n_clients or n_clients % S:
        raise ValueError(
            f"n_shards={n_shards} must evenly divide n_clients="
            f"{n_clients} (two-level [shards × clients-per-shard] cohort)")
    return S, n_clients // S


def hier_mix_split(P, n_shards: int):
    """Factor one flat column-stochastic ``P`` [K, K] by edge locality:
    ``(blocks[S, L, L], src[K], scale[K])``, ``blocks[s]`` the part of P
    among shard s's clients (diagonal included), ``src[i]`` / ``scale[i]``
    client i's one cross-shard in-edge (``P[i, src[i]] == scale[i]``), or
    ``src[i] == i, scale[i] == 0`` when it has none. Exact:
    ``blockdiag(blocks) + scatter(src, scale) == P``. Raises when the cross
    part is not a scaled partial permutation (two or more cross-shard
    edges into or out of a client, as dense "full"/"mean" mixing has)."""
    P = np.asarray(P)
    K = P.shape[-1]
    S, L = hier_layout(K, n_shards)
    shard = np.arange(K) // L
    intra = shard[:, None] == shard[None, :]
    cross = np.where(intra, 0.0, P)
    if (np.count_nonzero(cross, axis=1) > 1).any() or \
            (np.count_nonzero(cross, axis=0) > 1).any():
        raise ValueError(
            "hier factoring needs at most one cross-shard edge per client "
            "per round (a scaled partial permutation); dense mixing "
            "(topology='full' / mix='mean') is not hier-factorable")
    blocks = np.where(intra, P, 0.0).reshape(S, L, S, L)
    blocks = blocks[np.arange(S), :, np.arange(S), :]          # [S, L, L]
    src = np.argmax(cross != 0.0, axis=1)
    has = cross[np.arange(K), src] != 0.0
    src = np.where(has, src, np.arange(K))
    scale = np.where(has, cross[np.arange(K), src], 0.0)
    return blocks, src.astype(np.int64), scale


def hier_mix_schedule(mix: str, t0: int, T: int, n_clients: int,
                      n_shards: int, topology: str = "exponential",
                      active=None, self_weight: float = 0.5):
    """:func:`hier_mix_split` of each round of a round-block's
    :func:`mix_schedule`, stacked: ``(blocks[T, S, L, L], src[T, K],
    scale[T, K])`` (``active`` is None or bool[T, K])."""
    Ps = mix_schedule(mix, t0, T, n_clients, topology, active=active,
                      self_weight=self_weight)
    parts = [hier_mix_split(Ps[i], n_shards) for i in range(T)]
    blocks = np.stack([p[0] for p in parts])
    src = np.stack([p[1] for p in parts])
    scale = np.stack([p[2] for p in parts])
    return blocks, src, scale


def _hier_intra(x: torch.Tensor, w: torch.Tensor, blocks, use_pallas: bool
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The block-diagonal half of one factored exchange: S independent
    [L, L] × [L, D] products over the stacked rows and the matching w mix,
    not de-biased; one launch of the shard-grid mix kernel under
    ``use_pallas``."""
    if use_pallas:
        return fused_pushsum_mix_blocks(x, w, blocks, debias=False)
    Pb = _as_matrix(blocks, x)
    S, L, _ = Pb.shape
    mixed = torch.einsum("sij,sjd->sid", Pb, x.reshape(S, L, -1))
    wm = torch.einsum("sij,sj->si", Pb.to(w.dtype), w.reshape(S, L))
    return mixed.reshape(x.shape), wm.reshape(w.shape)


def _cross(src, scale, like: torch.Tensor):
    return (torch.as_tensor(src, dtype=torch.int64, device=like.device),
            _as_matrix(scale, like))


def hier_mix_debiased(flat: torch.Tensor, w: torch.Tensor, blocks, src,
                      scale, *, use_pallas: bool = False
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One synchronous factored exchange, the two-level form of
    :func:`pushsum_mix_debiased`: the shard-local products plus the scaled
    cross-shard gather ``s·flat[src]``, then the de-bias. Every client has
    at most one cross-shard in-edge, so with P's entries 0, ½ and 1 each
    output is the flat exchange's one rounding, bit for bit."""
    mixed, wm = _hier_intra(flat, w, blocks, use_pallas)
    idx, s = _cross(src, scale, flat)
    mixed = mixed + s[:, None] * flat[idx]
    w2 = wm + s.to(w.dtype) * w[idx]
    return mixed / w2[:, None], w2


def hier_stale_mix_apply(flat: torch.Tensor, w: torch.Tensor, blocks, src,
                         scale, buf_t0: torch.Tensor, buf_w0: torch.Tensor,
                         *, use_pallas: bool = False):
    """One stale (τ>0) factored exchange: re-bias θ = z·w, mix the
    intra-shard part synchronously on the current θ, emit the cross-shard
    send ``scale·θ[src]`` (the caller pushes it into the τ-deep buffer and
    owns the rotation), merge the round-(t−τ) delivery ``buf_t0`` /
    ``buf_w0`` and de-bias by the identically delayed weights. Returns
    ``(z', send_t, w', send_w)``."""
    theta = flat * w[:, None]                  # raw PushSum numerator
    mixed, wm = _hier_intra(theta, w, blocks, use_pallas)
    idx, s = _cross(src, scale, flat)
    send_t = s[:, None] * theta[idx]
    send_w = s.to(w.dtype) * w[idx]
    w2 = wm + buf_w0
    return (mixed + buf_t0) / w2[:, None], send_t, w2, send_w


def hier_gossip_reference(z0, w0, Ps, n_shards: int, staleness: int = 0):
    """Numpy reference of the two-level (hier) PushSum exchange, the oracle
    of the hier backend. Per round, with ``blocks, src, scale =
    hier_mix_split(P, n_shards)``: re-bias θ = z·w; mix ``blockdiag(blocks)
    @ θ`` synchronously; deliver ``scale·θ[src]`` at once (τ = 0) or
    through a τ-deep buffer (τ > 0, the cross-shard mass only); z' = (mixed
    + delivery) / (w-mixed + w-delivery). Σ w + Σ buf_w and Σ z·w + Σ
    buf_theta are conserved every round; at τ = 0 it equals the flat
    :func:`stale_gossip_reference` at staleness 0. Returns ``(z, w,
    buf_theta[τ, K, D], buf_w[τ, K])``; buffer row 0 is the next
    delivery."""
    z = np.asarray(z0, np.float64)
    w = np.asarray(w0, np.float64)
    K, D = z.shape
    S, L = hier_layout(K, n_shards)
    tau = int(staleness)
    buf_t = np.zeros((tau, K, D))
    buf_w = np.zeros((tau, K))
    for P in Ps:
        blocks, src, scale = hier_mix_split(np.asarray(P, np.float64),
                                            n_shards)
        theta = z * w[:, None]
        mixed = np.einsum("sij,sjd->sid", blocks,
                          theta.reshape(S, L, D)).reshape(K, D)
        wm = np.einsum("sij,sj->si", blocks, w.reshape(S, L)).reshape(K)
        send_t = scale[:, None] * theta[src]
        send_w = scale * w[src]
        if tau == 0:
            arrive_t, arrive_w = send_t, send_w
        else:
            arrive_t, arrive_w = buf_t[0], buf_w[0]
            buf_t = np.concatenate([buf_t[1:], send_t[None]])
            buf_w = np.concatenate([buf_w[1:], send_w[None]])
        w = wm + arrive_w
        z = (mixed + arrive_t) / w[:, None]
    return z, w, buf_t, buf_w


# ---------------------------------------------------------------------------
# communication-cost model (paper Fig. 4 / Fig. 13)


def comm_cost_per_round(method: str, n_clients: int, model_bytes: int,
                        proxy_bytes: int, link_bandwidth: float = 50e9) -> float:
    """Analytic wall-clock communication time of ONE round (seconds).

    Centralized schemes serialize at the server: it receives K models and
    sends K back over one link (the bottleneck the paper measures).
    Decentralized schemes send/receive exactly one model per client in
    parallel. CWT passes one model around but rounds are serialized."""
    if method in ("fedavg",):
        return 2 * n_clients * model_bytes / link_bandwidth
    if method in ("fml",):
        return 2 * n_clients * proxy_bytes / link_bandwidth
    if method in ("avgpush", "cwt"):
        return 2 * model_bytes / link_bandwidth
    if method in ("proxyfl",):
        return 2 * proxy_bytes / link_bandwidth
    if method in ("regular", "joint"):
        return 0.0
    raise ValueError(method)
