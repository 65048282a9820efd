"""FederationEngine — the executor of one federated round; port of the
synchronous PushSum round, the async (stale-gossip) backend and the hier
(two-level) backend of ``src/repro/core/engine.py``, with §3.4 dropout.

One round has two parts (Algorithm 1). First every ACTIVE client runs its
local steps: this port loops over clients and steps in Python, one client
at a time, on the engine's device; a client dropped by the round's §3.4
mask (:func:`active_mask`) skips them, keeps its state and reports NaN
metrics. Then the proxies are flattened, stacked into ``[K, D]`` and
exchanged over ``mix_matrix(mix, t, K, topology, active)``, in which a
dropped client holds its own mass (identity column):

* ``backend`` ``"auto"``, ``"vmap"`` or ``"loop"``: one de-biased PushSum
  exchange (:func:`repro_torch.core.gossip.pushsum_mix_debiased`, the mix
  kernel under ``cfg.use_pallas``). All three run the per-client loop: the
  reference's ``loop`` and ``vmap`` backends agree at the conformance
  ``close`` grade, and a batched executor over clients is later work
  (ROADMAP.md Queue 1 item 5).
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
only the loop backend verifies: ``"vmap"`` (which this port also runs
client by client) and ``"async"`` do not.

Randomness
----------
The port cannot replay JAX's threefry streams, so it has one schedule of
its own: client k's local step s of round t draws its batch indices and
then its DP noise from a fresh ``torch.Generator`` on the engine's device,
seeded from ``(seed, ROUND_KEY_OFFSET + t, k, s)``; client k's initial
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

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..checkpoint.ckpt import load_checkpoint, save_checkpoint
from ..configs import ProxyFLConfig
from ..nn.modules import (tree_flatten_vector, tree_leaves, tree_map,
                          tree_size, tree_unflatten_vector)
from ..optim import Adam
from .commit import CommitmentError, client_commitment
from .compress import COMPRESS_KEY_FOLD, compress_spec
from .gossip import (hier_layout, hier_mix_debiased, hier_mix_split,
                     hier_stale_mix_apply, mix_matrix, pushsum_mix_debiased,
                     stale_mix_apply, stale_mix_split)

# round t's streams are seeded from (seed, ROUND_KEY_OFFSET + t, ...), apart
# from the per-client init streams (seed, k), as in the reference
ROUND_KEY_OFFSET = 10_000
BACKENDS = ("auto", "vmap", "loop", "async", "hier")
MIXES = ("pushsum", "mean", "ring", "none")
_UNPORTED_BACKENDS = {"shard_map": 12}

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
    is a block edge, the one place a driver observes the federation. The
    reference's rule; its engine runs a block as one program, this port's
    :meth:`FederationEngine.run_rounds` runs the block's rounds one by
    one."""
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


def _per_client(fns, n_clients: int) -> List:
    """One function per client: ``fns`` itself when it is a list or tuple
    of ``n_clients``, else ``fns`` repeated."""
    if not isinstance(fns, (list, tuple)):
        return [fns] * n_clients
    if len(fns) != n_clients:
        raise ValueError(f"{len(fns)} functions for {n_clients} clients")
    return list(fns)


def _refuse_unported(backend: str) -> None:
    if backend in _UNPORTED_BACKENDS:
        raise NotImplementedError(
            f"backend {backend!r} is not ported yet (ROADMAP.md Queue 1 item "
            f"{_UNPORTED_BACKENDS[backend]})")
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}")


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
    or gathers ``idx`` when the replay hook supplies it. ``mix`` is the
    exchange rule of :func:`repro_torch.core.gossip.mix_matrix`;
    ``staleness`` the delivery delay τ of the async backend and of the hier
    backend's cross-shard edges (None reads ``cfg.staleness``; the
    synchronous backends ignore it); the hier shard count is
    ``cfg.n_shards``, which must divide ``n_clients``. ``draws`` and
    ``codec_draws`` are the replay hooks (module docstring).

    The state is a list of per-client dicts, or the wrapper ``{"clients":
    [...], ["stale_theta": [τ, K, D], "stale_w": [τ, K],] ["hier_buffer":
    [τ, K, D], "hier_w": [τ, K],] ["ef_state": [K, D]]}`` on the async
    backend at τ>0 and the hier backend at τ>0 with S>1 (buffer row 0 is
    the next delivery) and wherever a compressed exchange runs (the public
    copies).
    """

    def __init__(self, cfg: ProxyFLConfig, *, n_clients: int,
                 step_fns, init_fns, sample_fn: SampleFn,
                 backend: str = "auto", mix: str = "pushsum", device="cuda",
                 draws: Optional[DrawsFn] = None, staleness=None,
                 codec_draws: Optional[CodecDrawsFn] = None):
        _refuse_unported(backend)
        if mix not in MIXES:
            raise ValueError(f"unknown mix {mix!r}")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.K = n_clients
        self.step_fns: List[StepFn] = _per_client(step_fns, n_clients)
        self.init_fns: List[InitFn] = _per_client(init_fns, n_clients)
        self.sample_fn = sample_fn
        homogeneous = all(f is self.step_fns[0] for f in self.step_fns)
        if backend == "auto":
            backend = "vmap" if homogeneous else "loop"
        if backend in ("vmap", "async", "hier") and not homogeneous:
            raise ValueError(
                f"{backend} backend requires a homogeneous cohort; "
                "heterogeneous private architectures need backend='loop'")
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

    # -- state construction / access ---------------------------------------

    def _clients_of(self, state) -> List[Dict]:
        return state["clients"] if self._wrapped else state

    def init_states(self, seed: int):
        """Per-client init from a CPU generator seeded from (seed, k); at
        τ>0 also the empty in-flight buffer, the async one or the hier
        cross-shard one (nothing arrives for τ rounds); with compression the
        public copies, warm-started at the initial proxies in f32."""
        states = []
        for k in range(self.K):
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
        return list(self._clients_of(state))

    def stacked_params(self, state, role: str = "proxy"):
        """The cohort's ``role`` params with a leading K dim (one
        architecture across the cohort)."""
        trees = [s[role]["params"] for s in self._clients_of(state)]
        return tree_map(lambda *xs: torch.stack(xs), trees[0], *trees[1:])

    def client_params(self, state, k: int, role: str = "proxy"):
        """Client k's ``role`` params."""
        return self._clients_of(state)[k][role]["params"]

    def attach_accountants(self, accountants: Sequence) -> None:
        assert len(accountants) == self.K
        self.accountants = list(accountants)

    # -- checkpointing -------------------------------------------------------

    def _ckpt_payload(self, state, t: int, seed: Optional[int]) -> Dict:
        """The reference's snapshot tree: per-client states, the round
        counter, per-client accountant step counts, the base key's words
        and whether a key was recorded. The same method produces the
        restore template, so save and restore always agree on structure."""
        clients = {f"c{k:04d}": s
                   for k, s in enumerate(self.export_states(state))}
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
        :mod:`repro_torch.checkpoint.federation`)."""
        save_checkpoint(path, self._ckpt_payload(state, t, seed))
        return path

    def restore_state(self, path: str, like=None, seed: Optional[int] = None
                      ) -> Tuple[Any, int]:
        """Bit-exact inverse of :meth:`save_state`; returns ``(state,
        rounds_done)`` in this engine's layout, each leaf in the
        template's dtype and on its device. ``like`` is a template state
        (default: a throwaway ``init_states(0)``; at LLM sizes pass the
        run's own). Attached accountants get their step counters back;
        ``seed`` is checked against the recorded base key."""
        if like is None:
            like = self.init_states(0)
        loaded = load_checkpoint(path, self._ckpt_payload(like, 0, None))
        clients = [loaded["clients"][f"c{k:04d}"] for k in range(self.K)]
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
        states = list(self._clients_of(state))
        last: List[Optional[Dict]] = [None] * self.K
        for k in range(self.K):
            if act is not None and not act[k]:
                continue   # dropped: no steps, state kept
            s = states[k]
            m: Dict = {}
            for i in range(self.n_steps(data[k])):
                gen, idx, noise = step_draws(seed, k, t, i, self.device,
                                             self.draws)
                batch = self.sample_fn(data[k], gen, idx)
                s, m = self.step_fns[k](s, batch, gen, noise)
            states[k] = s
            last[k] = m
        if not self.mixing:
            state = dict(state, clients=states) if self._wrapped else states
        elif self._stale:
            state = self._exchange_stale(states, state, t, act, seed)
        elif self._hier:
            state = self._exchange_hier(states, state, t, act)
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

    def _codec_noise(self, seed: int, t: int, shape) -> Optional[torch.Tensor]:
        """Round t's U[0,1) block for the int8 codec (None for top-k, which
        draws nothing): from its own generator on the engine's device, or
        the ``codec_draws`` replay hook."""
        if self.compress.mode != "int8":
            return None
        if self.codec_draws is not None:
            return torch.as_tensor(np.array(self.codec_draws(t)),
                                   dtype=torch.float32, device=self.device)
        gen = torch.Generator(device=self.device).manual_seed(
            stream_seed(seed, ROUND_KEY_OFFSET + t, COMPRESS_KEY_FOLD))
        return torch.rand(tuple(shape), generator=gen, dtype=torch.float32,
                          device=self.device)

    def _exchange(self, states: List[Dict], t: int, act=None, state=None,
                  seed: int = 0):
        """The de-biased PushSum mix of the stacked [K, D] proxies; returns
        the new client list, or with compression the new wrapper (``state``
        carries the public copies, ``seed`` the codec stream's)."""
        P = mix_matrix(self.mix, t, self.K, self.cfg.topology, act)
        flat, w = self._flat_proxies(states)
        if self.backend == "loop" and (self.verify_commitments
                                       or self.transmit_tamper is not None):
            flat = self._verified_exchange(flat, states, t)
        if not self._compressed:
            unb, w2 = pushsum_mix_debiased(flat, w, P,
                                           use_pallas=self.use_pallas)
            return self._with_proxies(states, unb, w2)
        unb, w2, ef_state = pushsum_mix_debiased(
            flat, w, P, use_pallas=self.use_pallas, compress=self.compress,
            ef_state=state["ef_state"],
            noise=self._codec_noise(seed, t, flat.shape))
        return dict(state, clients=self._with_proxies(states, unb, w2),
                    ef_state=ef_state)

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

    def _exchange_stale(self, states: List[Dict], state: Dict, t: int,
                        act=None, seed: int = 0) -> Dict:
        """The stale exchange: keep, send into the buffer, merge the
        delivery rotating out of row 0, de-bias; returns the new wrapper
        (with compression, its public copies advanced too)."""
        kept, sent = stale_mix_split(
            mix_matrix(self.mix, t, self.K, self.cfg.topology, act))
        kept = torch.as_tensor(kept, dtype=torch.float32, device=self.device)
        sent = torch.as_tensor(sent, dtype=torch.float32, device=self.device)
        flat, w = self._flat_proxies(states)
        buf_t, buf_w = state["stale_theta"], state["stale_w"]
        out = dict(state)
        if self._compressed:
            unb, send_t, w2, send_w, out["ef_state"] = stale_mix_apply(
                flat, w, kept, sent, buf_t[0], buf_w[0],
                use_pallas=self.use_pallas, compress=self.compress,
                ef_state=state["ef_state"],
                noise=self._codec_noise(seed, t, flat.shape))
        else:
            unb, send_t, w2, send_w = stale_mix_apply(
                flat, w, kept, sent, buf_t[0], buf_w[0],
                use_pallas=self.use_pallas)
        out.update(clients=self._with_proxies(states, unb, w2),
                   stale_theta=torch.cat([buf_t[1:], send_t[None]]),
                   stale_w=torch.cat([buf_w[1:],
                                      send_w[None].to(buf_w.dtype)]))
        return out

    def _hier_split(self, t: int, act=None):
        """Round t's factored schedule ``(blocks [S, L, L], src [K], scale
        [K])`` on the engine's device."""
        blocks, src, scale = hier_mix_split(
            mix_matrix(self.mix, t, self.K, self.cfg.topology, act),
            self.n_shards)
        return (torch.as_tensor(blocks, dtype=torch.float32,
                                device=self.device),
                torch.as_tensor(src, dtype=torch.int64, device=self.device),
                torch.as_tensor(scale, dtype=torch.float32,
                                device=self.device))

    def _exchange_hier(self, states: List[Dict], state, t: int, act=None):
        """The factored exchange at S > 1: synchronous at τ = 0 (returns the
        new client list), else the intra-shard mix with the cross-shard
        sends through the τ-deep buffer, rotated like the async one
        (returns the new wrapper)."""
        blocks, src, scale = self._hier_split(t, act)
        flat, w = self._flat_proxies(states)
        if not self._hier_stale:
            unb, w2 = hier_mix_debiased(flat, w, blocks, src, scale,
                                        use_pallas=self.use_pallas)
            return self._with_proxies(states, unb, w2)
        buf_t, buf_w = state["hier_buffer"], state["hier_w"]
        unb, send_t, w2, send_w = hier_stale_mix_apply(
            flat, w, blocks, src, scale, buf_t[0], buf_w[0],
            use_pallas=self.use_pallas)
        return dict(state, clients=self._with_proxies(states, unb, w2),
                    hier_buffer=torch.cat([buf_t[1:], send_t[None]]),
                    hier_w=torch.cat([buf_w[1:],
                                      send_w[None].to(buf_w.dtype)]))

    def run_rounds(self, state, data: Sequence, t0: int, n_rounds: int,
                   seed: int) -> Tuple[Any, Dict[str, np.ndarray]]:
        """Rounds ``t0 .. t0+n_rounds-1``, one at a time (round-blocks are
        later work); each metric comes back stacked to [n_rounds, K]."""
        rows = []
        for t in range(t0, t0 + n_rounds):
            state, m = self.run_round(state, data, t, seed)
            rows.append(m)
        return state, {k: np.stack([r[k] for r in rows]) for k in rows[0]}


# ---------------------------------------------------------------------------
# factories: classifier-scale engines built from ModelSpecs


def classifier_sampler(batch_size: int) -> SampleFn:
    """Uniform-with-replacement batch draw from (x, y); ``idx`` (the replay
    hook's indices) replaces the draw."""

    def sample(data_k, generator, idx=None):
        x, y = data_k
        if idx is None:
            idx = torch.randint(0, x.shape[0], (batch_size,),
                                generator=generator, device=x.device)
        return x[idx], y[idx]

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
               codec_draws: Optional[CodecDrawsFn] = None
               ) -> FederationEngine:
    """Engine for the two-model (private + proxy DML) family: ProxyFL
    (mix="pushsum") and FML (mix="mean"). Heterogeneous private
    architectures (``private_specs`` not all equal) give each client its
    own step and init functions, and ``backend="auto"`` then runs them on
    the loop backend; the proxy is one architecture, so the exchange is
    the same."""
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
        codec_draws=codec_draws)


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
                        codec_draws: Optional[CodecDrawsFn] = None
                        ) -> FederationEngine:
    """Engine for the single-model baselines: FedAvg (mix="mean"), AvgPush
    ("pushsum"), CWT ("ring"), Regular and Joint ("none"). The model lives
    in the exchanged ``proxy`` slot of the state ``{"proxy": {"params",
    "opt"}, "w"}``; ``dp`` runs its step under DP-SGD. ``n_clients`` (0:
    ``cfg.n_clients``) is the cohort size."""
    return FederationEngine(
        cfg, n_clients=n_clients or cfg.n_clients,
        step_fns=_ce_state_step(spec, cfg, dp),
        init_fns=_ce_state_init(spec, cfg),
        sample_fn=classifier_sampler(cfg.batch_size), backend=backend,
        mix=mix, device=device, draws=draws, codec_draws=codec_draws)
