"""The federated run (port of ``run_federated`` in
``src/repro/core/baselines.py``). This port runs ``method="proxyfl"``:
private + proxy DML per client, DP-SGD on the proxies, PushSum on the
exponential graph, with §3.4 dropout (``cfg.dropout_rate``) and the
``"async"`` stale-gossip backend (``cfg.staleness``). The other six
methods are later work (ROADMAP.md Queue 1 item 1).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..configs import ProxyFLConfig
from .accountant import PrivacyAccountant
from .engine import dml_engine
from .protocol import ClientState, ModelSpec, evaluate_batched

METHODS = ("proxyfl", "fml", "fedavg", "avgpush", "cwt", "regular", "joint")


def _accountants(cfg: ProxyFLConfig, sizes: Sequence[int]
                 ) -> List[Optional[PrivacyAccountant]]:
    if not cfg.dp.enabled:
        return [None] * len(sizes)
    return [PrivacyAccountant(
        cfg.dp.noise_multiplier,
        cfg.dp.sample_rate or min(1.0, cfg.batch_size / max(n, 1)),
        cfg.dp.delta) for n in sizes]


def run_federated(
    method: str,
    private_specs: Sequence[ModelSpec],
    proxy_spec: ModelSpec,
    client_data: Sequence[Tuple[torch.Tensor, torch.Tensor]],
    test_data: Tuple[torch.Tensor, torch.Tensor],
    cfg: ProxyFLConfig,
    *,
    seed: int = 0,
    eval_every: int = 1,
    use_pallas: Optional[bool] = None,
    backend: Optional[str] = None,
    device="cuda",
) -> Dict:
    """Run ``cfg.rounds`` rounds of ``method`` on ``device``; return
    ``{"history", "epsilon", "clients"}`` as the reference does.

    ``history`` holds one row per evaluation (every ``eval_every`` rounds
    and after the last): ``{"round", "private_acc", "proxy_acc"}`` with one
    test accuracy per client. ``use_pallas`` overrides ``cfg.use_pallas``
    (None keeps the config). The engine backend is ``backend``, else
    ``cfg.backend``, else ``"auto"``; ``"async"`` delays delivery by
    ``cfg.staleness`` rounds and is never chosen by ``"auto"``."""
    if method not in METHODS:
        raise ValueError(f"unknown method {method!r}")
    if method != "proxyfl":
        raise NotImplementedError(
            f"method {method!r} is not ported yet (ROADMAP.md Queue 1 item "
            "1)")
    dev = resolve_device(device)
    if use_pallas is not None:
        cfg = dataclasses.replace(cfg, use_pallas=use_pallas)
    K = len(client_data)
    data = [(x.to(dev), y.to(dev)) for x, y in client_data]
    xt, yt = (t.to(dev) for t in test_data)
    engine = dml_engine(tuple(private_specs[:K]), proxy_spec, cfg,
                        backend=backend or cfg.backend or "auto", device=dev)
    accs = _accountants(cfg, [d[0].shape[0] for d in data])
    engine.attach_accountants(accs)
    state = engine.init_states(seed)
    history: List[Dict] = []
    for t in range(cfg.rounds):
        state, _ = engine.run_round(state, data, t, seed)
        done = t + 1
        if (eval_every > 0 and done % eval_every == 0) or done == cfg.rounds:
            history.append({
                "round": done,
                "private_acc": evaluate_batched(
                    private_specs[0], engine.stacked_params(state, "private"),
                    xt, yt),
                "proxy_acc": evaluate_batched(
                    proxy_spec, engine.stacked_params(state, "proxy"), xt,
                    yt)})
    clients = [ClientState(s["private"]["params"], s["private"]["opt"],
                           s["proxy"]["params"], s["proxy"]["opt"],
                           float(s["w"]), accs[k])
               for k, s in enumerate(engine.export_states(state))]
    return {"history": history,
            "epsilon": [a.epsilon() if a else None for a in accs],
            "clients": clients}


def final_mean_acc(result: Dict, which: str = "auto") -> float:
    row = result["history"][-1]
    if which == "auto":
        which = "private_acc" if "private_acc" in row else "acc"
    return float(np.mean(row[which]))
