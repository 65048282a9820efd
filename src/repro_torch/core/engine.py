"""FederationEngine — the executor of one federated round; port of the
synchronous PushSum round of ``src/repro/core/engine.py``.

One round has two parts (Algorithm 1). First every client runs its local
steps: this slice loops over clients and steps in Python, one client at a
time, on the engine's device. Then the proxies are flattened, stacked into
``[K, D]`` and mixed by one de-biased PushSum exchange
(:func:`repro_torch.core.gossip.pushsum_mix_debiased`, the mix kernel under
``cfg.use_pallas``). ``backend`` accepts ``"auto"``, ``"vmap"`` and
``"loop"``, which all run this per-client loop: the reference's ``loop``
and ``vmap`` backends agree at the conformance ``close`` grade, and a
batched executor over clients is later work (ROADMAP.md Queue 1 item 10).

Randomness
----------
The port cannot replay JAX's threefry streams, so it has one schedule of
its own: client k's local step s of round t draws its batch indices and
then its DP noise from a fresh ``torch.Generator`` on the engine's device,
seeded from ``(seed, ROUND_KEY_OFFSET + t, k, s)``; client k's initial
params come from a CPU generator seeded from ``(seed, k)``, so they are the
same numbers on every device. The replay hook ``draws(k, t, s) ->
(batch_idx, flat_noise)`` replaces the generator: parity tests feed the
reference's draws through it.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..configs import ProxyFLConfig
from ..nn.modules import tree_flatten_vector, tree_map, tree_unflatten_vector
from ..optim import Adam
from .gossip import mix_matrix, pushsum_mix_debiased

# round t's streams are seeded from (seed, ROUND_KEY_OFFSET + t, ...), apart
# from the per-client init streams (seed, k), as in the reference
ROUND_KEY_OFFSET = 10_000
_UNPORTED_BACKENDS = {"shard_map": 18, "async": 14, "hier": 15}

StepFn = Callable[..., Tuple[Dict, Dict]]
InitFn = Callable[[torch.Generator], Dict]
SampleFn = Callable[..., Any]
DrawsFn = Callable[[int, int, int], Tuple[Any, Any]]


def stream_seed(*words: int) -> int:
    """A 63-bit generator seed from integer words (numpy SeedSequence)."""
    state = np.random.SeedSequence([int(w) for w in words]).generate_state(
        1, np.uint64)
    return int(state[0]) & ((1 << 63) - 1)


def _refuse_unported(cfg: ProxyFLConfig, backend: str) -> None:
    if backend in _UNPORTED_BACKENDS:
        raise NotImplementedError(
            f"backend {backend!r} is not ported yet (ROADMAP.md Queue 1 item "
            f"{_UNPORTED_BACKENDS[backend]})")
    if backend not in ("auto", "vmap", "loop"):
        raise ValueError(f"unknown backend {backend!r}")
    for on, what, item in ((cfg.dropout_rate, "dropout_rate (§3.4)", 10),
                           (cfg.compress != "none", "compress", 16),
                           (cfg.verify_commitments, "verify_commitments", 13)):
        if on:
            raise NotImplementedError(
                f"ProxyFLConfig.{what} is not ported yet (ROADMAP.md Queue 1 "
                f"item {item})")


class FederationEngine:
    """Executor of the synchronous federated round (see module docstring).

    ``step_fn(state, batch, generator, noise) -> (state, metrics)`` is one
    client's local update; ``init_fn(generator) -> state`` one client's
    initial state (drawn on the CPU, moved to ``device``);
    ``sample_fn(data_k, generator, idx=None) -> batch`` draws a local batch,
    or gathers ``idx`` when the replay hook supplies it.
    """

    def __init__(self, cfg: ProxyFLConfig, *, n_clients: int,
                 step_fn: StepFn, init_fn: InitFn, sample_fn: SampleFn,
                 backend: str = "auto", device="cuda",
                 draws: Optional[DrawsFn] = None):
        _refuse_unported(cfg, backend)
        self.device = resolve_device(device)
        self.cfg = cfg
        self.K = n_clients
        self.step_fn, self.init_fn, self.sample_fn = step_fn, init_fn, sample_fn
        self.use_pallas = cfg.use_pallas
        self.draws = draws
        self.accountants: List = [None] * n_clients

    # -- state construction / access ---------------------------------------

    def init_states(self, seed: int) -> List[Dict]:
        """Per-client init from a CPU generator seeded from (seed, k)."""
        states = []
        for k in range(self.K):
            gen = torch.Generator().manual_seed(stream_seed(seed, k))
            states.append(tree_map(lambda x: x.to(self.device),
                                   self.init_fn(gen)))
        return states

    def export_states(self, state) -> List[Dict]:
        return list(state)

    def stacked_params(self, state, role: str = "proxy"):
        """The cohort's ``role`` params with a leading K dim."""
        trees = [s[role]["params"] for s in state]
        return tree_map(lambda *xs: torch.stack(xs), trees[0], *trees[1:])

    def attach_accountants(self, accountants: Sequence) -> None:
        assert len(accountants) == self.K
        self.accountants = list(accountants)

    # -- round execution ----------------------------------------------------

    def n_steps(self, data_k) -> int:
        if self.cfg.local_steps:
            return self.cfg.local_steps
        return max(1, data_k[0].shape[0] // self.cfg.batch_size)

    def _step_draws(self, seed: int, k: int, t: int, s: int):
        """(generator, batch_idx, noise) of client k's step s in round t:
        a fresh generator, or the replay hook's draws on the device."""
        if self.draws is None:
            gen = torch.Generator(device=self.device).manual_seed(
                stream_seed(seed, ROUND_KEY_OFFSET + t, k, s))
            return gen, None, None
        idx, noise = self.draws(k, t, s)
        idx = torch.as_tensor(np.array(idx), dtype=torch.int64,
                              device=self.device)
        if noise is not None:
            noise = torch.as_tensor(np.array(noise), dtype=torch.float32,
                                    device=self.device)
        return None, idx, noise

    def run_round(self, state: List[Dict], data: Sequence, t: int, seed: int
                  ) -> Tuple[List[Dict], Dict[str, np.ndarray]]:
        """One full round: local steps on every client, then one exchange.
        ``seed`` is the run's base seed (round t's streams derive from it).
        Returns the new state and each metric of every client's last step
        as a [K] array."""
        states = list(state)
        last: List[Dict] = []
        for k in range(self.K):
            s = states[k]
            m: Dict = {}
            for i in range(self.n_steps(data[k])):
                gen, idx, noise = self._step_draws(seed, k, t, i)
                batch = self.sample_fn(data[k], gen, idx)
                s, m = self.step_fn(s, batch, gen, noise)
            states[k] = s
            last.append(m)
        if self.K > 1:
            states = self._exchange(states, t)
        for k, acc in enumerate(self.accountants):
            if acc is not None:
                acc.step(self.n_steps(data[k]))
        metrics = {key: torch.stack([m[key] for m in last]).cpu().numpy()
                   for key in sorted(last[0])}
        return states, metrics

    def _exchange(self, states: List[Dict], t: int) -> List[Dict]:
        """The de-biased PushSum mix of the stacked [K, D] proxies."""
        P = mix_matrix("pushsum", t, self.K, self.cfg.topology)
        flat = torch.stack([tree_flatten_vector(s["proxy"]["params"])
                            for s in states])
        w = torch.stack([s["w"] for s in states]).to(flat.dtype)
        unb, w2 = pushsum_mix_debiased(flat, w, P, use_pallas=self.use_pallas)
        like = states[0]["proxy"]["params"]
        return [dict(s, proxy=dict(s["proxy"],
                                   params=tree_unflatten_vector(unb[k], like)),
                     w=w2[k].to(s["w"].dtype))
                for k, s in enumerate(states)]

    def run_rounds(self, state: List[Dict], data: Sequence, t0: int,
                   n_rounds: int, seed: int
                   ) -> Tuple[List[Dict], Dict[str, np.ndarray]]:
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
               backend: str = "auto", device="cuda",
               draws: Optional[DrawsFn] = None) -> FederationEngine:
    """Engine for ProxyFL: private + proxy DML per client, PushSum on the
    proxies. Homogeneous cohorts only in this slice."""
    if any(s != private_specs[0] for s in private_specs):
        raise NotImplementedError(
            "heterogeneous private architectures are not ported yet "
            "(ROADMAP.md Queue 1 item 10)")
    return FederationEngine(
        cfg, n_clients=len(private_specs),
        step_fn=_dml_state_step(private_specs[0], proxy_spec, cfg),
        init_fn=_dml_state_init(private_specs[0], proxy_spec, cfg),
        sample_fn=classifier_sampler(cfg.batch_size), backend=backend,
        device=device, draws=draws)
