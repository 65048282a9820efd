"""ProxyFL — Algorithm 1 of the paper, the client steps and evaluation;
port of the parts of ``src/repro/core/protocol.py`` the federated rounds
use.

A *ModelSpec* abstracts a classifier as ``init(generator) -> params`` /
``apply(params, x) -> logits``. Each ProxyFL / FML client holds a private
model (trained WITHOUT DP, Eq. 4) and a proxy model (trained WITH DP-SGD,
Eq. 5/7): :func:`dml_step_fn`. The single-model baselines (FedAvg,
AvgPush, CWT, Regular, Joint) take a plain cross-entropy step on one
model: :func:`ce_step_fn`.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, List, Optional

import torch
from torch.func import vmap

from ..configs import ProxyFLConfig
from ..nn.losses import cross_entropy, dml_loss
from ..optim import Adam
from .accountant import PrivacyAccountant
from .dp import dp_adam_update, dp_gradient, non_dp_gradient

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
