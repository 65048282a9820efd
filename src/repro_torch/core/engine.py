"""FederationEngine — the executor of one federated round and of
round-blocks; port of the synchronous PushSum round, the async
(stale-gossip) backend and the hier (two-level) backend of
``src/repro/core/engine.py``, with §3.4 dropout.

One round has two parts (Algorithm 1). First every ACTIVE client runs its
local steps; a client dropped by the round's §3.4 mask
(:func:`active_mask`) keeps its state and reports NaN metrics. Then the
proxies are flattened, stacked into ``[K, D]`` and exchanged over
``mix_matrix(mix, t, K, topology, active)``, in which a dropped client
holds its own mass (identity column).

Executors
---------
* The **stacked executor** (``"vmap"``, ``"async"`` and ``"hier"`` on a
  homogeneous cohort whose engine comes from :func:`dml_engine`,
  :func:`single_model_engine` or the LLM train driver's ``make_engine``):
  the clients' states are stacked to a leading K dim at a block's entry,
  and each local step is ONE client step vmapped over the cohort
  (``torch.func.vmap``; the kernels' vmap rules launch their client
  routes, one launch a call for the whole cohort: the DP kernels' client
  grids, and in the LLM step's peer forwards rmsnorm's and the scan's
  client grids and attention folded over the clients), as the reference's
  ``_local_phase`` runs ``jax.vmap`` inside a ``lax.scan``. A ragged cohort is padded (:func:`repro_torch.data.ragged.
  pad_stack`); each client's batch indices are drawn below its own length,
  so padding is never read, and in epoch mode a client past its
  ``n_k // B`` steps keeps its state and Adam count frozen
  (:func:`_tree_where`). Metrics are each client's last executed step's.
  The exchange runs on the stacked proxies, and the state is unstacked to
  the per-client list at the block's exit: the public layout never
  changes.
* On a CUDA device the stacked round is captured once per shape key
  (step count, step mask, data shapes) into a ``torch.cuda.CUDAGraph``
  (the counterpart of the reference's jit cache of round programs): the
  key's first round runs eagerly on a side stream as the capture's
  warm-up, its second is captured there, and every later round is a
  replay: before each, the round's draws go into static ``[S, K, B]`` /
  ``[S, K, D]`` buffers and the exchange's inputs (P(t), or the stale or
  hier split) and the active mask into static inputs; the ``[T, K]``
  metrics stay on the device until the block's edge. A failed capture
  raises; it never falls back to eager execution. On the CPU the same
  round runs eagerly. Launch counters (:mod:`repro_torch.kernels`) count
  what a capture recorded once, then add it on every replay.
* The **loop** (``backend="loop"``, heterogeneous cohorts, and engines
  built from step functions that cannot be vmapped) runs the clients one
  at a time.

Backends
--------
* ``"auto"``, ``"vmap"`` or ``"loop"``: one de-biased PushSum exchange
  (:func:`repro_torch.core.gossip.pushsum_mix_debiased`, the mix kernel
  under ``cfg.use_pallas``). ``"vmap"`` and ``"loop"`` agree at the
  conformance ``close`` grade (batched products round otherwise).
* ``backend="async"`` with staleness τ = ``cfg.staleness`` > 0: the stale
  exchange (:func:`repro_torch.core.gossip.stale_mix_apply`, the stale-mix
  kernel under ``cfg.use_pallas``). Each client keeps ``kept(t)·θ`` of its
  raw numerator θ = z·w and puts ``sent(t) @ θ`` into a τ-deep in-flight
  buffer that rides next to the clients in the state; the delivery sent τ
  rounds earlier merges in. A dropped client keeps ``kept = 1``, sends
  nothing, and still merges the mail that arrives for it. At τ = 0 the
  async backend runs the synchronous exchange verbatim.
* ``backend="hier"``: a two-level cohort of S = ``cfg.n_shards`` shards of
  L = K / S clients (:func:`repro_torch.core.gossip.hier_layout`) runs the
  SAME P(t), factored by edge locality
  (:func:`repro_torch.core.gossip.hier_mix_split`): a block-diagonal
  [S, L, L] part, S shard-local products in one launch of the shard-grid
  mix kernel under ``cfg.use_pallas``, plus at most one scaled cross-shard
  edge into each client, a gather. Client states keep the flat per-client
  layout; the [S, L, D] view exists inside the exchange only. S = 1 runs
  the synchronous exchange verbatim, whatever τ. At τ = 0 and S > 1 the
  factored exchange (:func:`repro_torch.core.gossip.hier_mix_debiased`)
  equals the flat one bit for bit, since P's entries are 0, ½ and 1 and
  each client has at most one cross-shard in-edge. At τ = ``staleness`` >
  0 only the cross-shard sends are delayed, through a τ-deep buffer
  ``{"hier_buffer": [τ, K, D], "hier_w": [τ, K]}`` in the state wrapper
  (:func:`repro_torch.core.gossip.hier_stale_mix_apply`). As in the
  reference, hier refuses a heterogeneous cohort, dense mixing (``mix=
  "mean"`` or ``topology="full"``) at S > 1, the ring mix at τ > 0 and a
  compressed exchange at S > 1. The accountants step as on vmap, so
  epsilon depends on neither τ nor S.

* ``backend="shard_map"``: one client per rank of a ``torch.distributed``
  process group, the paper's deployment layout. ``mesh`` is a
  ``torch.distributed.device_mesh.DeviceMesh`` whose dim ``axis`` holds
  exactly K ranks (NCCL on the card, gloo only for ``device="cpu"``);
  every rank builds the engine and calls each method, rank r holding
  client r only: its state is the list ``[client r's state]``. Its local
  phase is the stacked executor on a local cohort of one (client r's
  draws, as the vmap backend makes them; on the card its round replays
  from a CUDA graph), and the exchange after it, outside the graph, is
  :func:`repro_torch.core.gossip.pushsum_gossip_shard`: (1 − sw)·(θ, w)
  sent to the peer the round's shift ahead in the active subset, one
  send/recv a round whatever K (sw = 0.5 for pushsum, 0 for the ring
  mix; ``mix="mean"`` a sum over the ranks), then the de-bias. The shift
  and the membership are fixed per round on the host; under dropout
  :meth:`FederationEngine.run_rounds` runs round by round, and a dropped
  rank skips its local phase. Metrics come back [K] (or [T, K]) on every
  rank through an all-gather, each rank steps all K accountants, and
  ``export_states``, ``stacked_params``, ``client_params`` and
  ``save_state`` gather the K clients (collectives: every rank calls
  them); the writer rank (rank 0) writes files, the others wait for its
  outcome. As in the reference, it refuses a heterogeneous cohort and a
  compressed exchange.

The async, hier and shard_map backends share the stacked local phase with
vmap verbatim (only the exchange differs), so async at τ = 0 and hier at
S > 1, τ = 0 equal vmap bit for bit, as does shard_map on the pushsum and
ring mixes (each mixed coordinate is two exact halvings and one rounded
sum, in either executor).

Round-blocks
------------
:meth:`FederationEngine.run_rounds` runs rounds ``t0 .. t0+T-1`` as one
block: the host sees the federation at the block's edge only (the
metrics, the unstacked state), and the accountants step once per block
over each client's active rounds. Every draw is seeded afresh from
``(seed, t, k, s)``, so any block size replays the per-round trajectory
bit for bit, and a resume at a block edge continues it.

Compressed exchange
-------------------
``cfg.compress`` ∈ {"topk", "int8"} (with ``cfg.compress_ratio`` for
top-k) sends every exchange through :mod:`repro_torch.core.compress`, sync
and async alike: each client transmits a compressed delta against its
PUBLIC COPY, which every receiver holds, and receivers mix the updated
dense copies. The copies ride in the state wrapper ``{"clients",
"ef_state": [K, D] f32}`` (beside the in-flight buffers at τ > 0), never
in the per-client trees a step function could drop, and warm-start at the
initial proxies (one uncompressed broadcast at set-up). The compressed
exchange is plain torch: no mix kernel launches, whatever
``cfg.use_pallas`` says, as in the reference. ``"none"`` keeps every
round as it was, unwrapped.

Commitments
-----------
Under ``cfg.verify_commitments`` the loop backend (``backend="loop"``)
checks each received proxy against its sender's declared commitment
before mixing (:meth:`FederationEngine._verified_exchange`); a proxy
tampered with in flight raises
:class:`repro_torch.core.commit.CommitmentError` naming the client and
round. ``transmit_tamper`` is the adversary hook the tests inject
(:func:`repro_torch.core.attacks.bitflip_proxy`). As in the reference,
only the loop backend verifies: ``"vmap"``, ``"async"`` and ``"hier"`` do
not.

Randomness
----------
The port cannot replay JAX's threefry streams, so it has one schedule of
its own: client k's local step s of round t draws its batch indices
(``randint(0, n_k)``, :func:`draw_batch_idx`) and then its DP noise from a
fresh ``torch.Generator`` on the engine's device, seeded from ``(seed,
ROUND_KEY_OFFSET + t, k, s)``, on the loop and the stacked executor alike
(the stacked executor draws for the live (k, s) pairs only, before the
round runs); client k's initial
params come from a CPU generator seeded from ``(seed, k)``, so they are the
same numbers on every device. A dropped client therefore shifts no one
else's draws. The int8 codec's U[0,1) block [K, D] of round t comes from a
generator of its own, seeded from ``(seed, ROUND_KEY_OFFSET + t,
COMPRESS_KEY_FOLD)``. The replay hooks ``draws(k, t, s) -> (batch_idx,
flat_noise)`` and ``codec_draws(t) -> noise`` replace the generators:
parity tests feed the reference's draws through them. The dropout masks
are the reference's own numpy draws, seeded from ``(cfg.seed, t)``.

Checkpoints
-----------
:meth:`FederationEngine.save_state` / :meth:`~FederationEngine.restore_state`
write and read the reference's snapshot payload (per-client states keyed
``c0000…``, ``rounds_done``, ``accountant_steps``, the base key's words
and ``base_key_set``; the in-flight buffers at τ > 0 and the public copies
under compression), so a snapshot moves between the two frameworks.
Every draw above is seeded afresh from ``(seed, t, k, s)`` or ``(seed,
t)``, so a resume needs no generator state and none is saved: round t of
a resumed run draws what round t of the uninterrupted run drew. The base
key is stored as the words of ``jax.random.PRNGKey(seed)``, ``[0, seed]``
for 0 ≤ seed < 2³² (:func:`seed_key_words`): a JAX run and a port run
under the same seed pass each other's key check, another seed is
refused.
"""
from __future__ import annotations

import gc
import inspect
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.func import vmap

from .. import resolve_device
from ..checkpoint.ckpt import load_checkpoint, save_checkpoint
from ..configs import ProxyFLConfig
from ..data.ragged import pad_compatible, pad_stack
from ..nn.modules import (tree_flatten_vector, tree_leaves, tree_map,
                          tree_size, tree_unflatten_vector)
from ..optim import Adam
from .commit import CommitmentError, client_commitment
from .compress import COMPRESS_KEY_FOLD, compress_spec
from .gossip import (hier_layout, hier_mix_debiased, hier_mix_split,
                     hier_stale_mix_apply, mix_matrix, pushsum_gossip_shard,
                     pushsum_mix_debiased, stale_mix_apply, stale_mix_split)

# round t's streams are seeded from (seed, ROUND_KEY_OFFSET + t, ...), apart
# from the per-client init streams (seed, k), as in the reference
ROUND_KEY_OFFSET = 10_000
BACKENDS = ("auto", "vmap", "loop", "async", "hier", "shard_map")
MIXES = ("pushsum", "mean", "ring", "none")
# (topology, self weight) of each mix on the shard_map exchange, as the
# reference's ``_mix_topology``: mean is dense averaging, CWT's ring hop
# keeps nothing of its own
_MIX_TOPOLOGY = {"mean": ("full", 0.5), "ring": ("ring", 0.0)}

StepFn = Callable[..., Tuple[Dict, Dict]]
InitFn = Callable[[torch.Generator], Dict]
SampleFn = Callable[..., Any]
DrawsFn = Callable[[int, int, int], Tuple[Any, Any]]
CodecDrawsFn = Callable[[int], Any]
TamperFn = Callable[[np.ndarray, int], np.ndarray]


def stream_seed(*words: int) -> int:
    """A 63-bit generator seed from integer words (numpy SeedSequence)."""
    state = np.random.SeedSequence([int(w) for w in words]).generate_state(
        1, np.uint64)
    return int(state[0]) & ((1 << 63) - 1)


def seed_key_words(seed: Optional[int]) -> np.ndarray:
    """uint32[2] base-key words a snapshot records for a run's ``seed``:
    those of ``jax.random.PRNGKey(seed)`` (threefry's ``[seed >> 32, seed
    & 0xFFFFFFFF]``, i.e. ``[0, seed]`` here), zeros for None. A seed
    outside [0, 2³²) has no such pair of words and is refused."""
    if seed is None:
        return np.zeros((2,), np.uint32)
    seed = int(seed)
    if not 0 <= seed < 1 << 32:
        raise ValueError(
            f"seed {seed} is outside [0, 2**32): a checkpoint records the "
            "base key as the two uint32 words of jax.random.PRNGKey(seed)")
    return np.asarray([0, seed], np.uint32)


def step_draws(seed: int, k: int, t: int, s: int, device,
               draws: Optional[DrawsFn] = None):
    """(generator, batch_idx, noise) of client k's local step s in round
    t: a fresh generator on ``device`` seeded from (seed, ROUND_KEY_OFFSET
    + t, k, s), or the replay hook's draws on the device."""
    if draws is None:
        gen = torch.Generator(device=device).manual_seed(
            stream_seed(seed, ROUND_KEY_OFFSET + t, k, s))
        return gen, None, None
    idx, noise = draws(k, t, s)
    idx = torch.as_tensor(np.array(idx), dtype=torch.int64, device=device)
    if noise is not None:
        noise = torch.as_tensor(np.array(noise), dtype=torch.float32,
                                device=device)
    return None, idx, noise


def active_mask(t: int, n_clients: int, cfg: ProxyFLConfig
                ) -> Optional[np.ndarray]:
    """Deterministic per-round §3.4 dropout schedule from the config.

    Returns None (everyone participates) when ``cfg.dropout_rate == 0``;
    otherwise a bool[K] mask drawn from a seed derived from (cfg.seed, t),
    re-sampled identically by every backend and across reruns."""
    if not cfg.dropout_rate:
        return None
    rng = np.random.default_rng(np.random.SeedSequence([cfg.seed, 7919, t]))
    act = rng.random(n_clients) >= cfg.dropout_rate
    floor = max(1, min(cfg.min_active, n_clients))
    if act.sum() < floor:
        act[rng.choice(n_clients, size=floor, replace=False)] = True
    return act


def block_spans(start: int, rounds: int, rounds_per_block: int, *cadences):
    """Yield ``(t0, n)`` round-block spans covering ``[start, rounds)``:
    blocks of at most ``rounds_per_block`` rounds, cut so that every
    multiple of each nonzero cadence (checkpoint_every, eval_every, ...)
    is a block edge, the one place a driver observes the federation (the
    reference's rule; :meth:`FederationEngine.run_rounds` runs each
    block)."""
    B = max(1, int(rounds_per_block or 1))
    t = start
    while t < rounds:
        n = min(B, rounds - t)
        for c in cadences:
            if c and c > 0:
                n = min(n, c - t % c)
        yield t, n
        t += n


def active_schedule(t0: int, n_rounds: int, n_clients: int,
                    cfg: ProxyFLConfig) -> Optional[np.ndarray]:
    """Block-level §3.4 membership: ``active_mask`` for each round of a
    block, stacked to bool[T, K]. None when no dropout is configured (the
    per-t masks are all None). The per-round draws are preserved exactly
    (seeded per (cfg.seed, t)), so a blocked run replays the identical
    dropout trajectory as the per-round path."""
    masks = [active_mask(t, n_clients, cfg)
             for t in range(t0, t0 + n_rounds)]
    if all(m is None for m in masks):
        return None
    return np.stack([np.ones(n_clients, bool) if m is None else m
                     for m in masks])


def draw_batch_idx(generator: Optional[torch.Generator], n: int,
                   batch_size: int, device, out=None) -> torch.Tensor:
    """A local step's batch indices: ``batch_size`` draws of U{0..n-1}
    with replacement from ``generator``, the first draw of a step's stream
    (the DP noise follows it); ``n`` is the client's own length, so a
    padded stack's padding is never drawn. Into ``out`` when given."""
    if out is not None:
        return torch.randint(0, n, (batch_size,), generator=generator,
                             out=out)
    return torch.randint(0, n, (batch_size,), generator=generator,
                         device=device)


def _to_device(a, dtype, device, out=None) -> torch.Tensor:
    """A host array on ``device``: a fresh tensor, or copied into ``out``
    without waiting (from pinned memory on a CUDA device, which the
    caching host allocator keeps until the copy has run)."""
    t = torch.as_tensor(np.array(a), dtype=dtype)
    if out is None:
        return t.to(device)
    if out.device.type == "cuda":
        return out.copy_(t.pin_memory(), non_blocking=True)
    return out.copy_(t)


def _sampler_accepts_n_valid(fn) -> bool:
    """True when ``fn`` can be called ``fn(data_k, generator, n_valid=...)``:
    the masked sampling a ragged cohort needs on the stacked executor. The
    parameter must be NAMED ``n_valid``, so a sampler whose third parameter
    means something else never receives a length."""
    try:
        sig = inspect.signature(fn)
    except (TypeError, ValueError):
        return False
    p = sig.parameters.get("n_valid")
    return p is not None and p.kind in (p.POSITIONAL_OR_KEYWORD,
                                        p.KEYWORD_ONLY)


def stack_states(states: Sequence[Dict]) -> Dict:
    """List of per-client state trees -> one tree with a leading K dim."""
    return tree_map(lambda *xs: torch.stack(xs), states[0], *states[1:])


def unstack_state(stacked: Dict, k: int) -> Dict:
    """Client k's state out of a stacked tree (views)."""
    return tree_map(lambda x: x[k], stacked)


def _tree_where(mask_k: torch.Tensor, new, old):
    """Per-client select over stacked trees (``mask_k`` bool[K])."""
    def sel(n, o):
        m = mask_k.reshape((mask_k.shape[0],) + (1,) * (n.dim() - 1))
        return torch.where(m, n, o)
    return tree_map(sel, new, old)


def _stack_metric_rows(rows: Sequence[Dict[str, np.ndarray]], n_clients: int
                       ) -> Dict[str, np.ndarray]:
    """Per-round metric dicts ([K] arrays) -> one [T, K] array per key
    (the union of keys, NaN where a round did not emit a metric)."""
    keys = set().union(*(r.keys() for r in rows)) if rows else set()
    nan = np.full(n_clients, np.nan)
    return {k: np.stack([np.asarray(r.get(k, nan), float) for r in rows])
            for k in sorted(keys)}


def _rebuild(like, leaves: Sequence[torch.Tensor]):
    """``like``'s structure (None subtrees kept) around ``leaves``."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)


def vmap_step(step: StepFn, stacked, batch, noise=None):
    """``step(state, batch, None, noise)`` of every client of a stacked
    cohort at once, under ``torch.func.vmap`` (the state's leaves
    flattened around the vmap, since ``torch.func`` takes no None leaf):
    ``(stacked state', stacked metrics)``. ``noise`` is [K, D] or None."""
    leaves = tree_leaves(stacked)

    def one(leaves_k, batch_k, noise_k):
        new, m = step(_rebuild(stacked, leaves_k), batch_k, None, noise_k)
        return tree_leaves(new), m

    if noise is None:
        new, m = vmap(lambda lv, b: one(lv, b, None))(leaves, batch)
    else:
        new, m = vmap(one)(leaves, batch, noise)
    return _rebuild(stacked, new), m


class _CapturedRound:
    """One stacked round captured into a CUDA graph on ``stream`` (the
    stream the key's first round ran on, eagerly, as the capture's
    warm-up): a static carry (the stacked clients and the wrapper's
    buffers), the static inputs the caller fills before each replay, and
    the launch counts the capture recorded, added to the counters on every
    replay. The capture leaves the counters as it found them."""

    def __init__(self, round_fn, carry, inputs, stream):
        from .. import kernels
        self.carry = tree_map(lambda x: x.clone(), carry)
        # the stacked data and step counts become the graph's own inputs,
        # reloaded when another dataset of the same shapes comes
        self.inputs = dict(inputs, data=tree_map(lambda x: x.clone(),
                                                 inputs["data"]),
                           steps=inputs["steps"].clone())
        self.data_of = inputs["data"]
        inputs = self.inputs
        before = kernels.count_state()
        self.graph = torch.cuda.CUDAGraph()
        # an engine holding graphs lives in a reference cycle, so an old
        # one is freed by the collector; its graph must not be destroyed
        # while this one captures
        gc.collect()
        gc.disable()
        try:
            with torch.cuda.graph(self.graph, stream=stream):
                new, self.last = round_fn(self.carry, self.inputs)
                # the round writes its carry back in place: replays chain
                for dst, src in zip(tree_leaves(self.carry),
                                    tree_leaves(new)):
                    dst.copy_(src)
        finally:
            gc.enable()
        after = kernels.count_state()
        self.delta = {k: after[k] - before[k] for k in after}
        kernels.set_counts(before)

    def load(self, carry) -> None:
        for dst, src in zip(tree_leaves(self.carry), tree_leaves(carry)):
            dst.copy_(src)

    def load_data(self, data_s, steps) -> None:
        """The graph reads ``data_s`` (a cohort's stacked data, of the
        captured shapes) and its step counts from now on."""
        if data_s is not self.data_of:
            for dst, src in zip(tree_leaves(self.inputs["data"]),
                                tree_leaves(data_s)):
                dst.copy_(src)
            self.inputs["steps"].copy_(steps)
            self.data_of = data_s

    def replay(self) -> Dict[str, torch.Tensor]:
        from .. import kernels
        self.graph.replay()
        kernels.add_counts(self.delta)
        return {k: v.clone() for k, v in self.last.items()}


def _per_client(fns, n_clients: int) -> List:
    """One function per client: ``fns`` itself when it is a list or tuple
    of ``n_clients``, else ``fns`` repeated."""
    if not isinstance(fns, (list, tuple)):
        return [fns] * n_clients
    if len(fns) != n_clients:
        raise ValueError(f"{len(fns)} functions for {n_clients} clients")
    return list(fns)


def _mesh_group(mesh, axis: str, n_clients: int, device):
    """The process group of ``mesh``'s dim ``axis`` for a shard_map engine
    of ``n_clients`` on ``device``, or the refusal: no mesh, a dim of
    another size, or a mesh whose device type or communication backend is
    not the engine's (NCCL for ``cuda``, gloo for ``cpu``)."""
    if mesh is None:
        raise ValueError("shard_map backend needs a mesh")
    names = mesh.mesh_dim_names or ()
    if axis not in names or mesh.size(names.index(axis)) != n_clients:
        raise ValueError(
            f"mesh axis {axis!r} must hold exactly {n_clients} devices")
    import torch.distributed as dist
    group = mesh.get_group(axis)
    want = torch.device(device).type
    comm = {"cuda": "nccl", "cpu": "gloo"}.get(want)
    if mesh.device_type != want or dist.get_backend(group) != comm:
        raise ValueError(
            f"a shard_map engine on {want!r} needs a {want} mesh on {comm}; "
            f"mesh axis {axis!r} is a {mesh.device_type} mesh on "
            f"{dist.get_backend(group)}")
    return group


class FederationEngine:
    """Executor of the federated round (see module docstring).

    ``step_fns`` holds one client's local update ``step(state, batch,
    generator, noise) -> (state, metrics)`` per client, or one for all;
    ``init_fns`` one client's initial state ``init(generator) -> state``
    (drawn on the CPU, moved to ``device``) the same way. A cohort whose
    clients hold different step functions (heterogeneous private
    architectures) runs on ``backend="loop"``, which ``"auto"`` picks for
    it; ``"vmap"``, ``"async"`` and ``"hier"`` refuse it, as in the
    reference.
    ``sample_fn(data_k, generator, idx=None) -> batch`` draws a local batch,
    or gathers ``idx`` when the replay hook supplies it. ``stackable``
    says that ``step_fns`` can run vmapped over the cohort (the factories
    set it): the homogeneous vmap, async and hier backends then run the
    stacked executor, which draws each step's indices itself
    (:func:`draw_batch_idx` with ``sample_fn.batch_size``), and, with
    ``noisy_steps``, the step's flat N(0, 1) noise over the proxy params
    after them. ``mix`` is the
    exchange rule of :func:`repro_torch.core.gossip.mix_matrix`;
    ``staleness`` the delivery delay τ of the async backend and of the hier
    backend's cross-shard edges (None reads ``cfg.staleness``; the
    synchronous backends ignore it); the hier shard count is
    ``cfg.n_shards``, which must divide ``n_clients``. ``draws`` and
    ``codec_draws`` are the replay hooks (module docstring). ``mesh`` (a
    ``DeviceMesh``) and its dim ``axis`` place ``backend="shard_map"``'s
    clients, one a rank (module docstring).

    Between calls the state is a list of per-client dicts, or the wrapper
    ``{"clients": [...], ["stale_theta": [τ, K, D], "stale_w": [τ, K],]
    ["hier_buffer":
    [τ, K, D], "hier_w": [τ, K],] ["ef_state": [K, D]]}`` on the async
    backend at τ>0 and the hier backend at τ>0 with S>1 (buffer row 0 is
    the next delivery) and wherever a compressed exchange runs (the public
    copies).
    """

    # private: run the stacked round eagerly on a CUDA device too (the
    # chip smoke test holds the captured round against it)
    _eager_stacked = False

    def __init__(self, cfg: ProxyFLConfig, *, n_clients: int,
                 step_fns, init_fns, sample_fn: SampleFn,
                 backend: str = "auto", mix: str = "pushsum", device="cuda",
                 draws: Optional[DrawsFn] = None, staleness=None,
                 codec_draws: Optional[CodecDrawsFn] = None,
                 stackable: bool = False, noisy_steps: bool = False,
                 mesh=None, axis: str = "clients"):
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r}")
        if mix not in MIXES:
            raise ValueError(f"unknown mix {mix!r}")
        self.cfg = cfg
        self.K = n_clients
        self.step_fns: List[StepFn] = _per_client(step_fns, n_clients)
        self.init_fns: List[InitFn] = _per_client(init_fns, n_clients)
        self.sample_fn = sample_fn
        homogeneous = all(f is self.step_fns[0] for f in self.step_fns)
        if backend == "auto":
            backend = "vmap" if homogeneous else "loop"
        if backend in ("vmap", "async", "hier", "shard_map") and \
                not homogeneous:
            raise ValueError(
                f"{backend} backend requires a homogeneous cohort; "
                "heterogeneous private architectures need backend='loop'")
        self._shard = backend == "shard_map"
        self._group = (_mesh_group(mesh, axis, n_clients, device)
                       if self._shard else None)
        self.device = resolve_device(device)
        self.backend = backend
        self.mix = mix
        self.mixing = mix != "none" and n_clients > 1
        self.staleness = 0
        if backend in ("async", "hier"):
            self.staleness = int(cfg.staleness if staleness is None
                                 else staleness)
            if self.staleness < 0:
                raise ValueError(f"staleness must be >= 0, got "
                                 f"{self.staleness}")
            if self.staleness and mix == "ring":
                raise ValueError(
                    f"{backend} staleness>0 is incompatible with the pure-"
                    "permutation ring mix (CWT): clients keep no self mass, "
                    "so a delayed delivery would leave them model-less for "
                    "the first τ rounds; use staleness=0 or a mix with a "
                    "positive diagonal (pushsum/mean)")
        # τ=0 runs the synchronous exchange verbatim on the unwrapped state
        self._stale = backend == "async" and self.staleness > 0
        # hier: S shards of K / S clients; S = 1 makes every edge
        # intra-shard, so the flat exchange runs verbatim
        self.n_shards = (hier_layout(n_clients, cfg.n_shards)[0]
                         if backend == "hier" else 1)
        self._hier = backend == "hier" and self.n_shards > 1
        if self._hier and self.mixing:
            topo = {"pushsum": cfg.topology, "mean": "full",
                    "ring": "ring"}[mix]
            if topo == "full":
                raise ValueError(
                    "hier with n_shards>1 needs a sparse exchange: dense "
                    "mixing (mix='mean' / topology='full') has O(K) "
                    "cross-shard edges per client, which no O(1) inter-"
                    "shard collective schedule can realize; use pushsum/"
                    "ring mixes or n_shards=1")
        self._hier_stale = self._hier and self.staleness > 0
        # the compressed exchange (None: the uncompressed one, unwrapped)
        self.compress = compress_spec(cfg)
        if self.compress is not None and self._shard:
            raise ValueError(
                "compressed gossip (cfg.compress != 'none') is not "
                "implemented for the shard_map ppermute exchange — the "
                "collective ships full-precision tensors; use the loop/"
                "vmap/async backends for compressed rounds")
        if self.compress is not None and self._hier:
            raise ValueError(
                "compressed gossip (cfg.compress != 'none') is not "
                "implemented for the hier factored exchange — the codec "
                "is wired to the dense matmul paths; use n_shards=1 (which "
                "runs the vmap programs verbatim) or the loop/vmap/async "
                "backends for compressed rounds")
        self._compressed = self.compress is not None and self.mixing
        self._wrapped = self._stale or self._compressed or self._hier_stale
        self.use_pallas = cfg.use_pallas
        self.draws = draws
        self.codec_draws = codec_draws
        # received proxies checked against their senders' commitments
        # (loop backend); transmit_tamper is the wire adversary the tests
        # inject, (flat [K, D] numpy, t) -> flat
        self.verify_commitments = bool(cfg.verify_commitments)
        self.transmit_tamper: Optional[TamperFn] = None
        self.accountants: List = [None] * n_clients
        # the stacked executor (module docstring): the homogeneous stacked
        # backends on vmappable step functions
        self.stacked = stackable and backend in ("vmap", "async", "hier",
                                                 "shard_map")
        if self._shard and not stackable:
            raise ValueError(
                "the shard_map backend runs the stacked executor on each "
                "rank's client: its step functions must run under "
                "torch.func.vmap (stackable=True, as the engine factories "
                "set it)")
        if self.stacked and not hasattr(sample_fn, "batch_size"):
            raise ValueError("the stacked executor draws batch indices "
                             "itself: sample_fn needs a batch_size")
        self.noisy_steps = noisy_steps
        self._masked_sampler = _sampler_accepts_n_valid(sample_fn)
        # padded stacked copies of the data, keyed by the data's identity
        # (alternating datasets each keep theirs)
        self._data_cache: "OrderedDict" = OrderedDict()
        self._data_cache_max = 4
        self._stack_misses = 0
        # on a CUDA device, the side stream of each shape key's first,
        # eager round, and the round captured on it at the key's next round
        self._warm: Dict[Tuple, Any] = {}
        self._graphs: Dict[Tuple, _CapturedRound] = {}
        # the clients this process runs: all of them, or on shard_map the
        # rank's own; the exchange runs inside the stacked round, or on
        # shard_map after it, across the ranks
        self.rank = 0
        self._local = list(range(n_clients))
        if self._shard:
            import torch.distributed as dist
            self.rank = dist.get_rank(self._group)
            self._local = [self.rank]
            if self.device.type == "cuda" and self.device.index is None:
                self.device = torch.device("cuda",
                                           torch.cuda.current_device())
            # bring the communicator up with every rank joining: a round
            # under dropout may start with a send/recv between two ranks
            # only, which would hang NCCL's lazy start-up
            dist.all_reduce(torch.zeros(1, device=self.device),
                            group=self._group)
        self._mix_in_round = self.mixing and not self._shard

    # -- state construction / access ---------------------------------------

    def _clients_of(self, state) -> List[Dict]:
        return state["clients"] if self._wrapped else state

    def init_states(self, seed: int):
        """Per-client init from a CPU generator seeded from (seed, k); at
        τ>0 also the empty in-flight buffer, the async one or the hier
        cross-shard one (nothing arrives for τ rounds); with compression the
        public copies, warm-started at the initial proxies in f32."""
        states = []
        for k in self._local:
            gen = torch.Generator().manual_seed(stream_seed(seed, k))
            states.append(tree_map(lambda x: x.to(self.device),
                                   self.init_fns[k](gen)))
        if not self._wrapped:
            return states
        state: Dict[str, Any] = {"clients": states}
        proxy = states[0]["proxy"]["params"]
        for keys, on in ((("stale_theta", "stale_w"), self._stale),
                         (("hier_buffer", "hier_w"), self._hier_stale)):
            if on:
                state[keys[0]] = torch.zeros(
                    (self.staleness, self.K, tree_size(proxy)),
                    dtype=tree_flatten_vector(proxy).dtype,
                    device=self.device)
                state[keys[1]] = torch.zeros(
                    (self.staleness, self.K), dtype=states[0]["w"].dtype,
                    device=self.device)
        if self._compressed:
            state["ef_state"] = torch.stack(
                [tree_flatten_vector(s["proxy"]["params"])
                 for s in states]).to(torch.float32)
        return state

    def export_states(self, state) -> List[Dict]:
        """The K per-client states (on shard_map gathered from the ranks:
        a collective)."""
        if self._shard:
            return self._all_gather_tree(self._clients_of(state)[0])
        return list(self._clients_of(state))

    def stacked_params(self, state, role: str = "proxy"):
        """The cohort's ``role`` params with a leading K dim (one
        architecture across the cohort; on shard_map a collective)."""
        if self._shard:
            trees = self._all_gather_tree(state[0][role]["params"])
        else:
            trees = [s[role]["params"] for s in self._clients_of(state)]
        return tree_map(lambda *xs: torch.stack(xs), trees[0], *trees[1:])

    def client_params(self, state, k: int, role: str = "proxy"):
        """Client k's ``role`` params (on shard_map broadcast from rank k
        to every rank: a collective)."""
        if self._shard:
            return self._broadcast_tree(state[0][role]["params"], k)
        return self._clients_of(state)[k][role]["params"]

    # -- shard_map: collectives over the ranks -------------------------------

    def _all_gather_tree(self, tree) -> List:
        """Each rank's ``tree`` (one structure and shape on every rank),
        as a list of K trees, rank order, on every rank."""
        import torch.distributed as dist
        parts = []
        for x in tree_leaves(tree):
            got = [torch.empty_like(x) for _ in range(self.K)]
            dist.all_gather(got, x.contiguous(), group=self._group)
            parts.append(got)
        return [_rebuild(tree, [p[k] for p in parts]) for k in range(self.K)]

    def _broadcast_tree(self, tree, k: int):
        """Rank k's ``tree`` on every rank."""
        import torch.distributed as dist
        src = dist.get_global_rank(self._group, k)
        out = [x.clone() if self.rank == k else torch.empty_like(x)
               for x in tree_leaves(tree)]
        for x in out:
            dist.broadcast(x, src=src, group=self._group)
        return _rebuild(tree, out)

    def run_on_writer(self, fn: Callable[[], Any]) -> Any:
        """``fn()`` on the one process that writes files (shard_map: rank
        0; every other backend: this process), its outcome shared with
        every rank: the others wait for it and raise when it raised.
        Returns ``fn``'s result on the writer, None elsewhere."""
        if not self._shard:
            return fn()
        import torch.distributed as dist
        out, failure, err = None, None, [None]
        if self.rank == 0:
            try:
                out = fn()
            except Exception as e:      # shared, then raised on every rank
                failure, err = e, [f"{type(e).__name__}: {e}"]
        dist.broadcast_object_list(
            err, src=dist.get_global_rank(self._group, 0), group=self._group)
        if failure is not None:
            raise failure
        if err[0] is not None:
            raise RuntimeError(f"the writer rank failed: {err[0]}")
        return out

    def _gather_metrics(self, local: Dict[str, np.ndarray], T: int
                        ) -> Dict[str, np.ndarray]:
        """[T, 1] metrics of each rank (none from a rank whose client sat
        out every round) -> [T, K] on every rank, NaN where a client did
        not step."""
        import torch.distributed as dist
        every: List[Dict[str, np.ndarray]] = [None] * self.K
        dist.all_gather_object(every, local, group=self._group)
        out = {}
        for key in (k for m in every for k in m):
            if key in out:
                continue
            like = next(m[key] for m in every if key in m)
            out[key] = np.concatenate(
                [m.get(key, np.full((T, 1), np.nan, like.dtype))
                 for m in every], axis=1)
        return out

    def _exchange_shard(self, clients: Dict, t: int, act) -> None:
        """Round t's exchange of the rank's stacked client (a cohort of
        one), in place: :func:`pushsum_gossip_shard` of its flat proxy and
        weight, then the de-bias, written back into ``clients``."""
        topo, sw = _MIX_TOPOLOGY.get(self.mix, (self.cfg.topology, 0.5))
        theta = tree_leaves(clients["proxy"]["params"])
        flat = torch.cat([x.reshape(1, -1) for x in theta], dim=1)
        w = clients["w"]
        mixed, w2 = pushsum_gossip_shard(flat, w.to(flat.dtype), t,
                                         self._group, self.K, topo, sw, act)
        unb = mixed / w2[:, None]
        for x, piece in zip(theta, torch.split(
                unb, [x[0].numel() for x in theta], dim=1)):
            x.copy_(piece.reshape(x.shape))
        w.copy_(w2)

    def attach_accountants(self, accountants: Sequence) -> None:
        assert len(accountants) == self.K
        self.accountants = list(accountants)

    # -- checkpointing -------------------------------------------------------

    def _ckpt_payload(self, state, t: int, seed: Optional[int],
                      clients: Optional[List[Dict]] = None) -> Dict:
        """The reference's snapshot tree: per-client states (``clients``,
        else ``export_states(state)``), the round counter, per-client
        accountant step counts, the base key's words and whether a key was
        recorded. The same method produces the restore template, so save
        and restore always agree on structure."""
        if clients is None:
            clients = self.export_states(state)
        clients = {f"c{k:04d}": s for k, s in enumerate(clients)}
        steps = np.asarray([a.steps if a is not None else 0
                            for a in self.accountants], np.int32)
        payload = {"clients": clients,
                   "rounds_done": np.asarray(t + 1, np.int32),
                   "accountant_steps": steps,
                   "base_key": seed_key_words(seed),
                   # explicit flag: seed 0's key words are all zeros, so
                   # the words alone cannot mean "no key recorded"
                   "base_key_set": np.asarray(seed is not None, np.uint8)}
        if self._stale:
            # the in-flight buffer is federation state: rounds t+1..t+τ
            # deliver sends recorded here (a τ-mismatched or sync snapshot
            # fails the key/shape match with a descriptive error)
            payload["stale_theta"] = state["stale_theta"]
            payload["stale_w"] = state["stale_w"]
        if self._hier_stale:
            # the hier cross-shard buffer, under the reference's keys (τ=0
            # and n_shards=1 snapshots carry none: plain vmap payloads)
            payload["hier_buffer"] = state["hier_buffer"]
            payload["hier_w"] = state["hier_w"]
        if self._compressed:
            # the public copies too: round t+1 transmits C(m − ef_state)
            # and receivers mix ef_state itself (a resume across a
            # compression change is refused by the config fingerprint)
            payload["compress_ef_state"] = state["ef_state"]
        return payload

    def save_state(self, path: str, state, t: int,
                   seed: Optional[int] = None) -> str:
        """Write a complete-federation snapshot after completed round ``t``
        of a run under base ``seed`` (see
        :mod:`repro_torch.checkpoint.federation`). On shard_map every rank
        calls it: the clients are gathered, the writer rank writes."""
        payload = self._ckpt_payload(state, t, seed)
        self.run_on_writer(lambda: save_checkpoint(path, payload))
        return path

    def restore_state(self, path: str, like=None, seed: Optional[int] = None
                      ) -> Tuple[Any, int]:
        """Bit-exact inverse of :meth:`save_state`; returns ``(state,
        rounds_done)`` in this engine's layout, each leaf in the
        template's dtype and on its device. ``like`` is a template state
        (default: a throwaway ``init_states(0)``; at LLM sizes pass the
        run's own). Attached accountants get their step counters back;
        ``seed`` is checked against the recorded base key. On shard_map
        each rank reads the snapshot and keeps its own client."""
        if like is None:
            like = self.init_states(0)
        template = self._ckpt_payload(
            like, 0, None, clients=(self._clients_of(like) * self.K
                                    if self._shard else None))
        loaded = load_checkpoint(path, template)
        clients = [loaded["clients"][f"c{k:04d}"] for k in self._local]
        state: Any = clients
        if self._wrapped:
            state = {"clients": clients}
            if self._stale:
                state["stale_theta"] = loaded["stale_theta"]
                state["stale_w"] = loaded["stale_w"]
            if self._hier_stale:
                state["hier_buffer"] = loaded["hier_buffer"]
                state["hier_w"] = loaded["hier_w"]
            if self._compressed:
                state["ef_state"] = loaded["compress_ef_state"]
        rounds_done = int(loaded["rounds_done"])
        steps = np.asarray(loaded["accountant_steps"])
        for k, acc in enumerate(self.accountants):
            if acc is not None:
                acc.steps = int(steps[k])
        saved_key = np.asarray(loaded["base_key"], np.uint32)
        if seed is not None and bool(loaded["base_key_set"]) and \
                not np.array_equal(saved_key, seed_key_words(seed)):
            raise ValueError(
                f"checkpoint {path!r} was written under a different base RNG "
                "key; resuming would change the round key schedule")
        return state, rounds_done

    # -- round execution ----------------------------------------------------

    def n_steps(self, data_k) -> int:
        """Local steps of a client a round: ``cfg.local_steps``, or one
        epoch, n_k // B, with n_k the leading dim of the first leaf of its
        data (an ``(x, y)`` pair, a dict, or a bare token tensor)."""
        if self.cfg.local_steps:
            return self.cfg.local_steps
        n = tree_leaves(data_k)[0].shape[0]
        return max(1, n // self.cfg.batch_size)

    def run_round(self, state, data: Sequence, t: int, seed: int,
                  active=None) -> Tuple[Any, Dict[str, np.ndarray]]:
        """One full round: local steps on every ACTIVE client, then one
        exchange. ``seed`` is the run's base seed (round t's streams derive
        from it); ``active`` (bool[K]) overrides the round's §3.4 mask
        :func:`active_mask`. Returns the new state and each metric of every
        client's last step as a [K] array, NaN for dropped clients."""
        if active is None:
            active = active_mask(t, self.K, self.cfg)
        act = None if active is None else np.asarray(active, bool)
        if act is not None and act.shape != (self.K,):
            raise ValueError(f"active must be bool[{self.K}], got "
                             f"{act.shape}")
        if self.stacked:
            state, ms = self._run_stacked(
                state, data, t, 1, seed, None if act is None else act[None])
            return state, {k: v[0] for k, v in ms.items()}
        states = list(self._clients_of(state))
        last: List[Optional[Dict]] = [None] * self.K
        for k in range(self.K):
            if act is not None and not act[k]:
                continue   # dropped: no steps, state kept
            s = states[k]
            m: Dict = {}
            # a masked sampler gets the client's length as the stacked
            # executor passes it, so one whose ``n_valid`` has no default
            # runs on the loop too (where the leaves share one example axis)
            dims = {x.shape[0] for x in tree_leaves(data[k])}
            kw = ({"n_valid": dims.pop()} if self._masked_sampler
                  and len(dims) == 1 else {})
            for i in range(self.n_steps(data[k])):
                gen, idx, noise = step_draws(seed, k, t, i, self.device,
                                             self.draws)
                batch = self.sample_fn(data[k], gen, idx, **kw)
                s, m = self.step_fns[k](s, batch, gen, noise)
            states[k] = s
            last[k] = m
        if not self.mixing:
            state = dict(state, clients=states) if self._wrapped else states
        else:
            state = self._exchange(states, t, act, state, seed)
        for k, acc in enumerate(self.accountants):
            if acc is not None and (act is None or act[k]):
                acc.step(self.n_steps(data[k]))
        return state, self._collate(last)

    @staticmethod
    def _collate(last: List[Optional[Dict]]) -> Dict[str, np.ndarray]:
        """Per-client metric dicts to [K] arrays; NaN where a client did
        not step."""
        done = [k for k, m in enumerate(last) if m is not None]
        if not done:
            return {}
        out = {}
        for key in sorted(last[done[0]]):
            vals = torch.stack([last[k][key] for k in done]).cpu().numpy()
            out[key] = np.full(len(last), np.nan, vals.dtype)
            out[key][done] = vals
        return out

    def _flat_proxies(self, states: List[Dict]):
        flat = torch.stack([tree_flatten_vector(s["proxy"]["params"])
                            for s in states])
        w = torch.stack([s["w"] for s in states]).to(flat.dtype)
        return flat, w

    @staticmethod
    def _with_proxies(states: List[Dict], unb: torch.Tensor,
                      w2: torch.Tensor) -> List[Dict]:
        like = states[0]["proxy"]["params"]
        return [dict(s, proxy=dict(s["proxy"],
                                   params=tree_unflatten_vector(unb[k], like)),
                     w=w2[k].to(s["w"].dtype))
                for k, s in enumerate(states)]

    def _mix_inputs(self, t: int, act, seed: int, D: int,
                    out: Optional[Dict] = None) -> Dict[str, torch.Tensor]:
        """Round t's exchange inputs on the device: P(t), or the stale
        split (kept, sent) or the hier split (blocks, src, scale), and the
        int8 codec's U[0,1) block over [K, D] proxies. Into ``out``'s
        tensors when given (a captured round's static inputs), else
        fresh."""
        P = mix_matrix(self.mix, t, self.K, self.cfg.topology, act)
        if self._stale:
            kept, sent = stale_mix_split(P)
            host = {"kept": (kept, torch.float32),
                    "sent": (sent, torch.float32)}
        elif self._hier:
            blocks, src, scale = hier_mix_split(P, self.n_shards)
            host = {"blocks": (blocks, torch.float32),
                    "src": (src, torch.int64), "scale": (scale, torch.float32)}
        else:
            host = {"P": (P, torch.float32)}
        fresh = out is None
        out = {} if fresh else out
        for key, (a, dt) in host.items():
            out[key] = _to_device(a, dt, self.device,
                                  None if fresh else out[key])
        if self._compressed and self.compress.mode == "int8":
            K = self.K
            if self.codec_draws is not None:
                out["codec"] = _to_device(
                    np.array(self.codec_draws(t)), torch.float32,
                    self.device, None if fresh else out["codec"])
            else:
                gen = torch.Generator(device=self.device).manual_seed(
                    stream_seed(seed, ROUND_KEY_OFFSET + t,
                                COMPRESS_KEY_FOLD))
                if fresh:
                    out["codec"] = torch.rand((K, D), generator=gen,
                                              dtype=torch.float32,
                                              device=self.device)
                else:
                    torch.rand((K, D), generator=gen, out=out["codec"])
        return out

    def _mix(self, flat: torch.Tensor, w: torch.Tensor, carry: Dict,
             inp: Dict[str, torch.Tensor]):
        """The exchange of the stacked [K, D] proxies and [K] weights on
        round inputs ``inp`` (:meth:`_mix_inputs`): returns ``(z', w',
        buffers')`` with ``buffers'`` the wrapper's entries other than the
        clients (the in-flight buffers rotated, the public copies
        advanced). One definition for the loop and the stacked executor."""
        out = {k: v for k, v in carry.items() if k != "clients"}
        codec = dict(compress=self.compress, ef_state=carry["ef_state"],
                     noise=inp.get("codec")) if self._compressed else {}
        if self._stale:
            buf_t, buf_w = carry["stale_theta"], carry["stale_w"]
            res = stale_mix_apply(flat, w, inp["kept"], inp["sent"],
                                  buf_t[0], buf_w[0],
                                  use_pallas=self.use_pallas, **codec)
            unb, send_t, w2, send_w = res[:4]
            if self._compressed:
                out["ef_state"] = res[4]
            out.update(stale_theta=torch.cat([buf_t[1:], send_t[None]]),
                       stale_w=torch.cat([buf_w[1:],
                                          send_w[None].to(buf_w.dtype)]))
            return unb, w2, out
        if self._hier:
            args = (flat, w, inp["blocks"], inp["src"], inp["scale"])
            if not self._hier_stale:
                unb, w2 = hier_mix_debiased(*args, use_pallas=self.use_pallas)
                return unb, w2, out
            buf_t, buf_w = carry["hier_buffer"], carry["hier_w"]
            unb, send_t, w2, send_w = hier_stale_mix_apply(
                *args, buf_t[0], buf_w[0], use_pallas=self.use_pallas)
            out.update(hier_buffer=torch.cat([buf_t[1:], send_t[None]]),
                       hier_w=torch.cat([buf_w[1:],
                                         send_w[None].to(buf_w.dtype)]))
            return unb, w2, out
        res = pushsum_mix_debiased(flat, w, inp["P"],
                                   use_pallas=self.use_pallas, **codec)
        if self._compressed:
            out["ef_state"] = res[2]
        return res[0], res[1], out

    def _exchange(self, states: List[Dict], t: int, act=None, state=None,
                  seed: int = 0):
        """The loop executor's exchange: the per-client proxies stacked to
        [K, D] (checked against their commitments on the loop backend),
        :meth:`_mix`, and the new client list, or the new wrapper
        (``state`` carries the wrapper's buffers, ``seed`` the codec
        stream's)."""
        flat, w = self._flat_proxies(states)
        if self.backend == "loop" and (self.verify_commitments
                                       or self.transmit_tamper is not None):
            flat = self._verified_exchange(flat, states, t)
        carry = state if self._wrapped else {}
        unb, w2, out = self._mix(flat, w, carry, self._mix_inputs(
            t, act, seed, flat.shape[1]))
        clients = self._with_proxies(states, unb, w2)
        return dict(out, clients=clients) if self._wrapped else clients

    def _verified_exchange(self, flat: torch.Tensor, states: List[Dict],
                           t: int) -> torch.Tensor:
        """The loop backend's commitment-checked wire hop: each sender
        declares the commitment of the proxy it releases, the stacked wire
        payload passes the adversary hook (``transmit_tamper``), and every
        received row, rebuilt into a tree, must hash to its sender's
        declaration, else :class:`CommitmentError` names the client and
        round before anything is mixed. The untampered payload comes back
        bit for bit."""
        declared = [client_commitment(s["proxy"]["params"])[0]
                    for s in states]
        flat_np = flat.detach().cpu().numpy()
        if self.transmit_tamper is not None:
            flat_np = np.asarray(self.transmit_tamper(np.array(flat_np), t))
            assert flat_np.shape == tuple(flat.shape), (
                "transmit_tamper must preserve the [K, D] wire shape")
        if self.verify_commitments:
            like = states[0]["proxy"]["params"]
            for k in range(self.K):
                received, _ = client_commitment(tree_unflatten_vector(
                    torch.as_tensor(flat_np[k]), like))
                if received != declared[k]:
                    raise CommitmentError(
                        f"received proxy of client {k} at round {t} does "
                        f"not match its declared commitment (declared "
                        f"{declared[k]!r}, recomputed {received!r}) — the "
                        "proxy was tampered with in flight; refusing to "
                        "mix it", round=t, client=k)
        return torch.as_tensor(flat_np, dtype=flat.dtype, device=flat.device)

    def run_rounds(self, state, data: Sequence, t0: int, n_rounds: int,
                   seed: int) -> Tuple[Any, Dict[str, np.ndarray]]:
        """Rounds ``t0 .. t0+n_rounds-1`` as one round-block: on the
        stacked executor the host sees only the block's edge (module
        docstring), on the loop the rounds run one by one. Dropout replays
        the per-round masks (:func:`active_schedule`); the accountants step
        once per block over each client's active rounds, which lands on the
        per-round counters. Each metric comes back stacked to [n_rounds, K]
        (NaN for a client that did not step)."""
        if n_rounds < 1:
            raise ValueError(f"a block has at least one round, got "
                             f"{n_rounds}")
        # shard_map under dropout runs round by round, as in the reference
        # (its per-round exchange schedules follow the membership)
        if self.stacked and not (self._shard and self.cfg.dropout_rate):
            return self._run_stacked(
                state, data, t0, n_rounds, seed,
                active_schedule(t0, n_rounds, self.K, self.cfg))
        rows = []
        for t in range(t0, t0 + n_rounds):
            state, m = self.run_round(state, data, t, seed)
            rows.append(m)
        return state, _stack_metric_rows(rows, self.K)

    def client_steps(self, data: Sequence) -> np.ndarray:
        """int64[K] local steps of each client a round: ``cfg.local_steps``
        for all, or each client's epoch ``n_k // B`` (the stacked
        executor's step mask)."""
        return np.asarray([self.n_steps(d) for d in data], np.int64)

    # -- the stacked executor -----------------------------------------------

    def _stack_data(self, data: Sequence):
        """``(stacked, lengths, steps)`` of the clients this process runs
        (all of ``data``, or the rank's own on shard_map, whose other
        entries are read for their lengths only): the padded stacked
        device copy and those clients' lengths and step counts (host), kept
        in a small LRU keyed by the data's identity, so alternating
        datasets (train and fine-tune) each keep theirs. A cohort that
        cannot be stacked, or a ragged one without a masked sampler, is
        refused."""
        ck = id(data)
        cached = self._data_cache.get(ck)
        if cached is not None and cached[0] is data:
            self._data_cache.move_to_end(ck)
            return cached[1:]
        self._stack_misses += 1
        held = data
        data = [held[k] for k in self._local]
        if not pad_compatible(data):
            raise ValueError(
                "the stacked executor (vmap, async, hier) needs per-client "
                "data trees of one structure whose leaves share one example "
                "axis, dtypes and trailing dims (ragged leading dims are "
                "padded and mask-sampled); use backend='loop' for "
                "incompatible trees")
        stacked, n_valid = pad_stack(data)
        lengths = n_valid.cpu().numpy()
        if (lengths != lengths[0]).any() and not self._masked_sampler:
            raise ValueError(
                "ragged per-client datasets on the stacked path need a "
                "masked sampler: sample_fn must accept (data_k, generator, "
                "n_valid) so padding is never drawn (see "
                "repro_torch.core.engine.classifier_sampler)")
        entry = (held, stacked, lengths, self.client_steps(data))
        self._data_cache[ck] = entry
        while len(self._data_cache) > self._data_cache_max:
            self._data_cache.popitem(last=False)
        return entry[1:]

    def _vstep(self, stacked, batch, noise, step=None):
        """One local step of every client at once: the client step (or
        ``step``) vmapped over the cohort (:func:`vmap_step`)."""
        return vmap_step(step or self.step_fns[0], stacked, batch, noise)

    def _round_fn(self, S: int, step_masked: bool):
        """The stacked round as a function of ``(carry, inputs) -> (carry',
        last)``: S vmapped local steps (a client past its step count, or
        dropped, keeps its state), the last executed step's metrics of each
        client (NaN for a dropped one) and the exchange. Reads nothing on
        the host, so a CUDA graph can hold it. On shard_map the cohort is
        the rank's client and the exchange runs after the round."""
        K = len(self._local)
        sample = self.sample_fn

        def round_fn(carry, inp):
            stacked = carry["clients"]
            act, data_s, steps_dev = inp["act"], inp["data"], inp["steps"]
            st, ms = stacked, []
            for s in range(S):
                batch = vmap(lambda d, i: sample(d, None, i))(
                    data_s, inp["idx"][s])
                st2, m = self._vstep(st, batch, inp["noise"][s]
                                     if "noise" in inp else None)
                if step_masked:
                    st2 = _tree_where(act & (s < steps_dev), st2, st)
                st, ms = st2, ms + [m]
            last_i = torch.clamp(steps_dev - 1, 0, S - 1)
            cols = torch.arange(K, device=steps_dev.device)
            last = {key: torch.where(
                act, torch.stack([m[key] for m in ms])[last_i, cols],
                float("nan")) for key in ms[0]}
            trained = _tree_where(act, st, stacked)
            out = dict(carry, clients=trained)
            if self._mix_in_round:
                theta = trained["proxy"]["params"]
                flat = torch.cat([x.reshape(K, -1) for x in
                                  tree_leaves(theta)], dim=1)
                w = trained["w"]
                unb, w2, bufs = self._mix(flat, w.to(flat.dtype), out, inp)
                pieces = iter(torch.split(
                    unb, [x[0].numel() for x in tree_leaves(theta)], dim=1))
                theta2 = tree_map(lambda x: next(pieces).reshape(
                    x.shape).to(x.dtype), theta)
                out = dict(bufs, clients=dict(
                    trained, proxy=dict(trained["proxy"], params=theta2),
                    w=w2.to(w.dtype)))
            return out, last

        return round_fn

    def _round_inputs(self, t: int, act: np.ndarray, lengths: np.ndarray,
                      steps: np.ndarray, S: int, D: int, seed: int,
                      out: Optional[Dict] = None) -> Dict[str, torch.Tensor]:
        """Round t's inputs of the stacked round: the batch indices [S, K,
        B] and DP noise [S, K, D] of every live (client, step) pair (zeros
        elsewhere, never used), drawn as the loop draws them, the active
        mask and the exchange's inputs; into ``out`` when given. ``act``
        is bool[K], ``lengths`` and ``steps`` those of the clients this
        process runs (K of them, or the rank's one on shard_map)."""
        dev, K, B = self.device, len(self._local), self.sample_fn.batch_size
        fresh = out is None
        if fresh:
            out = {"idx": torch.zeros((S, K, B), dtype=torch.int64,
                                      device=dev),
                   "act": torch.zeros((K,), dtype=torch.bool, device=dev)}
            if self.noisy_steps:
                out["noise"] = torch.zeros((S, K, D), dtype=torch.float32,
                                           device=dev)
        idx, noise = out["idx"], out.get("noise")
        for s in range(S):
            for j, k in enumerate(self._local):
                if not (act[k] and s < steps[j]):
                    idx[s, j].zero_()
                    if noise is not None:
                        noise[s, j].zero_()
                    continue
                if self.draws is not None:
                    i, n = self.draws(k, t, s)
                    _to_device(i, torch.int64, dev, idx[s, j])
                    if noise is not None:
                        _to_device(n, torch.float32, dev, noise[s, j])
                    continue
                gen = torch.Generator(device=dev).manual_seed(
                    stream_seed(seed, ROUND_KEY_OFFSET + t, k, s))
                draw_batch_idx(gen, int(lengths[j]), B, dev, out=idx[s, j])
                if noise is not None:
                    torch.randn((D,), generator=gen, out=noise[s, j])
        _to_device(act[self._local], torch.bool, dev, out["act"])
        if self._mix_in_round:
            out.update(self._mix_inputs(t, act, seed, D,
                                        out=None if fresh else out))
        return out

    def _run_stacked(self, state, data: Sequence, t0: int, T: int,
                     seed: int, act_sched: Optional[np.ndarray]):
        """Rounds ``t0 .. t0+T-1`` on the stacked executor: stack at the
        block's entry, T rounds (replays of the captured round on a CUDA
        device), unstack at its exit; the [T, K] metrics come to the host
        once, and the accountants step once. On shard_map each round's
        exchange follows its local phase, which a rank whose client sat the
        round out skips, and the metrics are gathered from the ranks."""
        data_s, lengths, steps = self._stack_data(data)
        S = int(steps.max())
        step_masked = bool((steps != steps[0]).any())
        act_stack = (np.ones((T, self.K), bool) if act_sched is None
                     else np.asarray(act_sched, bool))
        clients = stack_states(self._clients_of(state))
        carry = dict(state, clients=clients) if self._wrapped \
            else {"clients": clients}
        D = sum(x[0].numel() for x in tree_leaves(clients["proxy"]["params"]))
        steps_dev = torch.as_tensor(steps, device=self.device)
        # one graph for every dataset of the same shapes, as one compiled
        # round serves them in the reference
        key = (S, step_masked) + tuple((tuple(x.shape), x.dtype)
                                       for x in tree_leaves(data_s))
        graph = self._graphs.get(key)
        round_fn = None if graph else self._round_fn(S, step_masked)
        rows: List[Optional[Dict]] = []
        in_graph = False     # the live carry is the graph's static one
        for i, t in enumerate(range(t0, t0 + T)):
            act = act_stack[i]
            if self._shard and not act[self._local].any():
                rows.append(None)     # the rank's client sits the round out
            elif graph is not None:
                if not in_graph:
                    graph.load(carry)
                    graph.load_data(data_s, steps_dev)
                    in_graph = True
                self._round_inputs(t, act, lengths, steps, S, D, seed,
                                   out=graph.inputs)
                rows.append(graph.replay())
            else:
                inp = dict(self._round_inputs(t, act, lengths, steps, S, D,
                                              seed),
                           data=data_s, steps=steps_dev)
                if self.device.type != "cuda" or self._eager_stacked:
                    carry, last = round_fn(carry, inp)
                elif key not in self._warm:
                    # the key's first round runs eagerly on a side stream:
                    # the capture's warm-up (library set-up) is a real round
                    side = self._warm[key] = torch.cuda.Stream(
                        device=self.device)
                    side.wait_stream(torch.cuda.current_stream(self.device))
                    with torch.cuda.stream(side):
                        carry, last = round_fn(carry, inp)
                    now = torch.cuda.current_stream(self.device)
                    now.wait_stream(side)
                    for x in tree_leaves((carry, last)):
                        x.record_stream(now)     # made on side, used on now
                else:
                    graph = self._graphs[key] = _CapturedRound(
                        round_fn, carry, inp, self._warm[key])
                    in_graph = True
                    last = graph.replay()
                rows.append(last)
            if self._shard and self.mixing:
                # on the current stream, after the replay or the side
                # stream's round, outside the graph
                self._exchange_shard(
                    (graph.carry if in_graph else carry)["clients"], t,
                    None if act_sched is None else act)
        if in_graph:
            carry = tree_map(lambda x: x.clone(), graph.carry)
        clients = carry.pop("clients")
        per_client = [unstack_state(clients, j)
                      for j in range(len(self._local))]
        state = dict(carry, clients=per_client) if self._wrapped \
            else per_client
        done = [r for r in rows if r is not None]
        metrics = {}
        if done:
            nan = {k: torch.full_like(v, float("nan"))
                   for k, v in done[0].items()}
            metrics = {k: torch.stack([(r or nan)[k] for r in rows]).cpu()
                       .numpy() for k in done[0]}
        if self._shard:
            metrics = self._gather_metrics(metrics, T)
            steps = self.client_steps(data)
        for k, acc in enumerate(self.accountants):
            if acc is not None:
                n_active = int(act_stack[:, k].sum())
                if n_active:
                    acc.step(n_active * int(steps[k]))
        return state, metrics


# ---------------------------------------------------------------------------
# factories: classifier-scale engines built from ModelSpecs


def classifier_sampler(batch_size: int) -> SampleFn:
    """Uniform-with-replacement batch draw from (x, y)
    (:func:`draw_batch_idx`); ``idx`` (the replay hook's indices, or the
    stacked executor's) replaces the draw. ``n_valid`` bounds the draw on
    a padded client (default: its whole leading dim), so the loop and the
    stacked executor draw the same indices on a ragged cohort."""

    def sample(data_k, generator, idx=None, n_valid=None):
        x, y = data_k
        if idx is None:
            idx = draw_batch_idx(generator, x.shape[0] if n_valid is None
                                 else int(n_valid), batch_size, x.device)
        return x[idx], y[idx]

    sample.batch_size = batch_size
    return sample


def _dml_state_step(private_spec, proxy_spec, cfg: ProxyFLConfig) -> StepFn:
    from .protocol import dml_step_fn
    raw = dml_step_fn(private_spec, proxy_spec, cfg)

    def step(state, batch, generator, noise=None):
        phi, opt_phi, theta, opt_theta, m = raw(
            state["private"]["params"], state["private"]["opt"],
            state["proxy"]["params"], state["proxy"]["opt"], batch,
            generator, noise)
        return {"private": {"params": phi, "opt": opt_phi},
                "proxy": {"params": theta, "opt": opt_theta},
                "w": state["w"]}, m

    return step


def _dml_state_init(private_spec, proxy_spec, cfg: ProxyFLConfig) -> InitFn:
    opt = Adam(lr=cfg.lr, weight_decay=cfg.weight_decay)

    def init(generator):
        phi = private_spec.init(generator)
        theta = proxy_spec.init(generator)
        return {"private": {"params": phi, "opt": opt.init(phi)},
                "proxy": {"params": theta, "opt": opt.init(theta)},
                "w": torch.ones((), dtype=torch.float32)}

    return init


def dml_engine(private_specs: Tuple, proxy_spec, cfg: ProxyFLConfig,
               backend: str = "auto", mix: str = "pushsum", device="cuda",
               draws: Optional[DrawsFn] = None,
               codec_draws: Optional[CodecDrawsFn] = None,
               mesh=None, axis: str = "clients") -> FederationEngine:
    """Engine for the two-model (private + proxy DML) family: ProxyFL
    (mix="pushsum") and FML (mix="mean"). Heterogeneous private
    architectures (``private_specs`` not all equal) give each client its
    own step and init functions, and ``backend="auto"`` then runs them on
    the loop backend; the proxy is one architecture, so the exchange is
    the same. ``mesh`` and ``axis`` are the shard_map backend's."""
    if all(s == private_specs[0] for s in private_specs):
        step_fns = _dml_state_step(private_specs[0], proxy_spec, cfg)
        init_fns = _dml_state_init(private_specs[0], proxy_spec, cfg)
    else:
        step_fns = [_dml_state_step(s, proxy_spec, cfg)
                    for s in private_specs]
        init_fns = [_dml_state_init(s, proxy_spec, cfg)
                    for s in private_specs]
    return FederationEngine(
        cfg, n_clients=len(private_specs), step_fns=step_fns,
        init_fns=init_fns, sample_fn=classifier_sampler(cfg.batch_size),
        backend=backend, mix=mix, device=device, draws=draws,
        codec_draws=codec_draws, stackable=True,
        noisy_steps=cfg.dp.enabled, mesh=mesh, axis=axis)


def _ce_state_step(spec, cfg: ProxyFLConfig, dp: bool) -> StepFn:
    from .protocol import ce_step_fn
    raw = ce_step_fn(spec, cfg, dp)

    def step(state, batch, generator, noise=None):
        params, opt, loss = raw(state["proxy"]["params"],
                                state["proxy"]["opt"], batch, generator,
                                noise)
        return {"proxy": {"params": params, "opt": opt},
                "w": state["w"]}, {"loss": loss}

    return step


def _ce_state_init(spec, cfg: ProxyFLConfig) -> InitFn:
    opt = Adam(lr=cfg.lr, weight_decay=cfg.weight_decay)

    def init(generator):
        params = spec.init(generator)
        return {"proxy": {"params": params, "opt": opt.init(params)},
                "w": torch.ones((), dtype=torch.float32)}

    return init


def single_model_engine(spec, cfg: ProxyFLConfig, dp: bool,
                        mix: str = "mean", backend: str = "auto",
                        n_clients: int = 0, device="cuda",
                        draws: Optional[DrawsFn] = None,
                        codec_draws: Optional[CodecDrawsFn] = None,
                        mesh=None, axis: str = "clients"
                        ) -> FederationEngine:
    """Engine for the single-model baselines: FedAvg (mix="mean"), AvgPush
    ("pushsum"), CWT ("ring"), Regular and Joint ("none"). The model lives
    in the exchanged ``proxy`` slot of the state ``{"proxy": {"params",
    "opt"}, "w"}``; ``dp`` runs its step under DP-SGD. ``n_clients`` (0:
    ``cfg.n_clients``) is the cohort size; ``mesh`` and ``axis`` are the
    shard_map backend's."""
    return FederationEngine(
        cfg, n_clients=n_clients or cfg.n_clients,
        step_fns=_ce_state_step(spec, cfg, dp),
        init_fns=_ce_state_init(spec, cfg),
        sample_fn=classifier_sampler(cfg.batch_size), backend=backend,
        mix=mix, device=device, draws=draws, codec_draws=codec_draws,
        stackable=True, noisy_steps=dp, mesh=mesh, axis=axis)
