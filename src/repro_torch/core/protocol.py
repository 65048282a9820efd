"""ProxyFL — Algorithm 1 of the paper, the client steps and evaluation;
port of the parts of ``src/repro/core/protocol.py`` the federated rounds
use.

A *ModelSpec* abstracts a classifier as ``init(generator) -> params`` /
``apply(params, x) -> logits``. Each ProxyFL / FML client holds a private
model (trained WITHOUT DP, Eq. 4) and a proxy model (trained WITH DP-SGD,
Eq. 5/7): :func:`dml_step_fn`. The single-model baselines (FedAvg,
AvgPush, CWT, Regular, Joint) take a plain cross-entropy step on one
model: :func:`ce_step_fn`.

The functional API over :class:`ClientState` records: :func:`init_client`,
:func:`local_round` (one client's local steps, on the engine's per-step
streams or the replay hook's draws), :func:`gossip_proxies` (one PushSum
exchange, the mix kernel under ``cfg.use_pallas``) and
:func:`proxyfl_round` (both, through a loop-backend engine).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch
from torch.func import vmap

from .. import resolve_device
from ..configs import ProxyFLConfig
from ..nn.losses import cross_entropy, dml_loss
from ..nn.modules import (tree_flatten_vector, tree_leaves, tree_map,
                          tree_unflatten_vector)
from ..optim import Adam
from .accountant import PrivacyAccountant
from .dp import dp_adam_update, dp_gradient, non_dp_gradient
from .engine import classifier_sampler, dml_engine, step_draws
from .gossip import mix_matrix, pushsum_mix_debiased

Params = Any


@dataclass(frozen=True)
class ModelSpec:
    name: str
    init: Callable[[torch.Generator], Params]
    apply: Callable[[Params, torch.Tensor], torch.Tensor]


@dataclass
class ClientState:
    private_params: Params
    private_opt: Any
    proxy_params: Params
    proxy_opt: Any
    w: float = 1.0  # PushSum de-bias weight (Algorithm 1)
    accountant: Optional[PrivacyAccountant] = None


def dml_step_fn(private_spec: ModelSpec, proxy_spec: ModelSpec,
                cfg: ProxyFLConfig):
    """One joint DML step (Algorithm 1 lines 3-5): private non-DP update of
    Eq. (4), proxy DP-SGD update of Eq. (5)/(7).

    ``step(phi, opt_phi, theta, opt_theta, batch, generator, noise=None)``.
    Both updates use the STEP-START params: the proxy loss distils from the
    old φ and the private loss from the old θ, never θ'. ``noise`` is the
    proxy's flat N(0, 1) draws; absent, they come from ``generator``."""
    opt = Adam(lr=cfg.lr, weight_decay=cfg.weight_decay)

    def private_loss(phi, batch, theta):
        x, y = batch
        peer = proxy_spec.apply(theta, x)
        return dml_loss(private_spec.apply(phi, x), peer, y, cfg.alpha)

    def proxy_loss(theta, batch, phi):
        x, y = batch
        peer = private_spec.apply(phi, x)
        return dml_loss(proxy_spec.apply(theta, x), peer, y, cfg.beta)

    def step(phi, opt_phi, theta, opt_theta, batch, generator=None,
             noise=None):
        def proxy_of(t, b):
            return proxy_loss(t, b, phi)

        if cfg.dp.enabled and cfg.use_pallas:
            theta2, opt_theta2, m_theta = dp_adam_update(
                proxy_of, theta, opt_theta, batch, opt=opt,
                clip_norm=cfg.dp.clip_norm,
                noise_multiplier=cfg.dp.noise_multiplier, noise=noise,
                generator=generator)
        else:
            if cfg.dp.enabled:
                g_theta, m_theta = dp_gradient(
                    proxy_of, theta, batch, clip_norm=cfg.dp.clip_norm,
                    noise_multiplier=cfg.dp.noise_multiplier, noise=noise,
                    generator=generator, vectorized=cfg.dp.vectorized)
            else:
                g_theta, m_theta = non_dp_gradient(proxy_of, theta, batch)
            theta2, opt_theta2 = opt.update(g_theta, opt_theta, theta)
        g_phi, m_phi = non_dp_gradient(
            lambda p, b: private_loss(p, b, theta), phi, batch)
        phi2, opt_phi2 = opt.update(g_phi, opt_phi, phi)
        return phi2, opt_phi2, theta2, opt_theta2, {
            "private_loss": m_phi["loss"], "proxy_loss": m_theta["loss"]}

    return step


def ce_step_fn(spec: ModelSpec, cfg: ProxyFLConfig, dp: bool):
    """Plain CE step of the single-model methods (FedAvg/AvgPush/CWT/...):
    the fused clip → noise → Adam chain under DP with ``cfg.use_pallas``,
    else the DP gradient (or the plain one without DP) and an Adam step.

    ``step(params, opt, batch, generator=None, noise=None) -> (params',
    opt', loss)``; ``noise`` is the flat N(0, 1) draw, as for
    :func:`dml_step_fn`."""
    opt = Adam(lr=cfg.lr, weight_decay=cfg.weight_decay)

    def loss(params, batch):
        x, y = batch
        return cross_entropy(spec.apply(params, x), y)

    def step(params, opt_state, batch, generator=None, noise=None):
        if dp and cfg.use_pallas:
            params2, opt_state2, m = dp_adam_update(
                loss, params, opt_state, batch, opt=opt,
                clip_norm=cfg.dp.clip_norm,
                noise_multiplier=cfg.dp.noise_multiplier, noise=noise,
                generator=generator)
        else:
            if dp:
                g, m = dp_gradient(
                    loss, params, batch, clip_norm=cfg.dp.clip_norm,
                    noise_multiplier=cfg.dp.noise_multiplier, noise=noise,
                    generator=generator, vectorized=cfg.dp.vectorized)
            else:
                g, m = non_dp_gradient(loss, params, batch)
            params2, opt_state2 = opt.update(g, opt_state, params)
        return params2, opt_state2, m["loss"]

    return step


# ---------------------------------------------------------------------------
# the functional API over ClientState records


def gossip_proxies(clients: List[ClientState], t: int, cfg: ProxyFLConfig,
                   active=None) -> None:
    """Algorithm 1 lines 7-11, in place: the proxies (one architecture)
    stack into Θ ∈ R^{K×D} and one de-biased PushSum mix over P^(t)
    (:func:`repro_torch.core.gossip.mix_matrix`, ``cfg.topology``)
    updates every proxy and de-bias weight; the mix kernel runs under
    ``cfg.use_pallas``. ``active`` drops clients out of the exchange
    (§3.4)."""
    K = len(clients)
    if K <= 1:
        return
    like = clients[0].proxy_params
    thetas = torch.stack([tree_flatten_vector(c.proxy_params)
                          for c in clients])
    ws = torch.as_tensor(np.asarray([c.w for c in clients]),
                         dtype=thetas.dtype, device=thetas.device)
    P = mix_matrix("pushsum", t, K, cfg.topology, active)
    unbiased, w2 = pushsum_mix_debiased(thetas, ws, P,
                                        use_pallas=cfg.use_pallas)
    for k, c in enumerate(clients):
        c.proxy_params = tree_unflatten_vector(unbiased[k], like)
        c.w = float(w2[k])


def init_client(generator: torch.Generator, private_spec: ModelSpec,
                proxy_spec: ModelSpec, cfg: ProxyFLConfig,
                n_local: int, device="cuda") -> ClientState:
    """A fresh client on ``device``: private then proxy params drawn from
    ``generator`` (the engine's init order; a CPU generator, as the
    engine's, gives the engine's values) and then moved, Adam states, and
    under DP an accountant sampling at ``cfg.dp.sample_rate`` or
    B / n_local."""
    dev = resolve_device(device)
    opt = Adam(lr=cfg.lr, weight_decay=cfg.weight_decay)
    phi = tree_map(lambda x: x.to(dev), private_spec.init(generator))
    theta = tree_map(lambda x: x.to(dev), proxy_spec.init(generator))
    acc = None
    if cfg.dp.enabled:
        q = cfg.dp.sample_rate or min(1.0, cfg.batch_size / max(n_local, 1))
        acc = PrivacyAccountant(cfg.dp.noise_multiplier, q, cfg.dp.delta)
    return ClientState(phi, opt.init(phi), theta, opt.init(theta), 1.0, acc)


def local_round(client: ClientState, spec_pair, data, t: int,
                cfg: ProxyFLConfig, *, seed: int = 0, k: int = 0,
                draws=None) -> Dict[str, float]:
    """One client's local optimization for round t (Algorithm 1 lines
    2-5), in place: ``cfg.local_steps`` DML steps (else one epoch, n //
    B). Step s draws its batch and DP noise from the engine's stream of
    client ``k`` (seeded from (seed, t, k, s)), or from the replay hook
    ``draws(k, t, s) -> (batch_idx, flat_noise)``; so a client here takes
    the steps the engine's client k takes in round t. The accountant
    steps once a step. Returns the last step's metrics."""
    private_spec, proxy_spec = spec_pair
    x, _ = data
    step = dml_step_fn(private_spec, proxy_spec, cfg)
    sample = classifier_sampler(cfg.batch_size)
    device = tree_leaves(client.proxy_params)[0].device
    n_steps = cfg.local_steps or max(1, x.shape[0] // cfg.batch_size)
    phi, opt_phi = client.private_params, client.private_opt
    theta, opt_theta = client.proxy_params, client.proxy_opt
    last: Dict = {}
    for s in range(n_steps):
        gen, idx, noise = step_draws(seed, k, t, s, device, draws)
        phi, opt_phi, theta, opt_theta, last = step(
            phi, opt_phi, theta, opt_theta, sample(data, gen, idx), gen,
            noise)
        if client.accountant is not None:
            client.accountant.step()
    client.private_params, client.private_opt = phi, opt_phi
    client.proxy_params, client.proxy_opt = theta, opt_theta
    return {key: float(v) for key, v in last.items()}


def proxyfl_round(clients: List[ClientState], spec_pairs, datasets, t: int,
                  cfg: ProxyFLConfig, *, seed: int = 0, active=None,
                  draws=None) -> List[Dict[str, float]]:
    """One full ProxyFL round across all clients: local DML steps, then
    the PushSum exchange. A loop-backend engine (the one that takes
    heterogeneous private architectures) on the clients' device runs it,
    with the run's base ``seed`` and the replay hook ``draws``; the
    :class:`ClientState` list is updated in place. Returns each client's
    last-step metrics (NaN for a dropped client)."""
    device = tree_leaves(clients[0].proxy_params)[0].device
    engine = dml_engine(tuple(p for p, _ in spec_pairs), spec_pairs[0][1],
                        cfg, backend="loop", device=device, draws=draws)
    states = [
        {"private": {"params": c.private_params, "opt": c.private_opt},
         "proxy": {"params": c.proxy_params, "opt": c.proxy_opt},
         "w": torch.as_tensor(c.w, dtype=torch.float32, device=device)}
        for c in clients]
    engine.attach_accountants([c.accountant for c in clients])
    states, metrics = engine.run_round(states, list(datasets), t, seed,
                                       active=active)
    for c, s in zip(clients, states):
        c.private_params, c.private_opt = (s["private"]["params"],
                                           s["private"]["opt"])
        c.proxy_params, c.proxy_opt = s["proxy"]["params"], s["proxy"]["opt"]
        c.w = float(s["w"])
    return [{m: float(v[k]) for m, v in metrics.items()}
            for k in range(len(clients))]


def evaluate(spec: ModelSpec, params, x: torch.Tensor, y: torch.Tensor,
             batch: int = 512) -> float:
    """Test accuracy of one model; the correct-count stays on the device
    until the single host read at the end."""
    correct = torch.zeros((), dtype=torch.int64, device=x.device)
    with torch.no_grad():
        for i in range(0, x.shape[0], batch):
            logits = spec.apply(params, x[i:i + batch])
            correct += torch.sum(torch.argmax(logits, -1) == y[i:i + batch])
    return int(correct) / x.shape[0]


def evaluate_batched(spec: ModelSpec, stacked_params, x: torch.Tensor,
                     y: torch.Tensor, batch: int = 512) -> List[float]:
    """Test accuracy of every client at once: ``stacked_params`` carry a
    leading client dim and the test set is shared. Correct-counts
    accumulate on the device as one [K] tensor, read once at the end."""
    apply = vmap(spec.apply, in_dims=(0, None))
    correct = None
    with torch.no_grad():
        for i in range(0, x.shape[0], batch):
            logits = apply(stacked_params, x[i:i + batch])
            c = torch.sum(torch.argmax(logits, -1) == y[None, i:i + batch],
                          dim=1)
            correct = c if correct is None else correct + c
    return [float(c) / x.shape[0] for c in correct.cpu()]
