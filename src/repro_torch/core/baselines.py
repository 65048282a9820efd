"""All comparison methods of the paper (§4.1), run by the port's
:class:`repro_torch.core.engine.FederationEngine` (port of
``src/repro/core/baselines.py``):

* **ProxyFL** — private + proxy DML per client, DP-SGD on the proxies,
  PushSum on the exponential graph (engine mix="pushsum").
* **FML** (Shen et al. 2020) — the same two models, proxies averaged at a
  central server (mix="mean").
* **FedAvg** (McMahan et al. 2017) — centralized mean of the single client
  models (mix="mean").
* **AvgPush** — decentralized FedAvg: PushSum of the single model
  (mix="pushsum").
* **CWT** (Chang et al. 2018) — cyclical weight transfer around the ring
  (mix="ring").
* **Regular** — local training only (mix="none").
* **Joint** — the pooled-data upper bound: one client holding every
  client's data (mix="none").

As in the paper, the single-model methods train their one model with
DP-SGD; ProxyFL and FML apply it to the proxies only. Every method runs
with §3.4 dropout (``cfg.dropout_rate``), on the ``"async"``
stale-gossip backend (``cfg.staleness``), which refuses CWT at τ > 0, and
on the two-level ``"hier"`` backend (``n_shards``; the reference's
refusals: FML and FedAvg's dense mean at S > 1, CWT at τ > 0, compression
at S > 1).
ProxyFL and FML take heterogeneous private architectures (fig. 5b) on the
loop backend, and every method takes ragged (size-skewed) cohorts. The
compressed exchange (``cfg.compress``) and commitment verification
(``cfg.verify_commitments``, with the ``transmit_tamper`` adversary) ride
in on the config. ``checkpoint_dir`` snapshots the federation and
``resume`` continues it bit for bit (:mod:`repro_torch.checkpoint`, the
reference's files). Round-blocks (``rounds_per_block``) come with the
fused blocks of ROADMAP.md Queue 1 item 5.
"""
from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..checkpoint.federation import FederationCheckpointer, config_fingerprint
from ..configs import ProxyFLConfig
from ..data.ragged import pad_compatible
from .accountant import PrivacyAccountant
from .engine import dml_engine, single_model_engine
from .protocol import ClientState, ModelSpec, evaluate, evaluate_batched

METHODS = ("proxyfl", "fml", "fedavg", "avgpush", "cwt", "regular", "joint")

# engine exchange rule per single-model method
_SINGLE_MIX = {"fedavg": "mean", "avgpush": "pushsum", "cwt": "ring",
               "regular": "none", "joint": "none"}


@dataclass
class SingleModelClient:
    params: object
    opt: object
    accountant: Optional[PrivacyAccountant] = None


def _resolve_backend(backend, cfg: ProxyFLConfig, client_data) -> str:
    """``backend``, else ``cfg.backend``, else ``"auto"``, as the
    reference resolves it: ``"auto"`` on per-client data trees that could
    not be padded together (other structures, dtypes or trailing dims)
    means the loop; ``"async"`` and ``"hier"`` refuse them, since their
    exchanges have no loop fallback that would keep their semantics."""
    backend = backend or cfg.backend or "auto"
    if backend == "auto" and not pad_compatible(client_data):
        return "loop"
    if backend in ("async", "hier") and not pad_compatible(client_data):
        raise ValueError(
            f"backend='{backend}' runs on the stacked path and needs "
            "identical or pad-compatible per-client data trees; genuinely "
            "incompatible trees have no "
            f"{'two-level' if backend == 'hier' else 'stale-gossip'} "
            "execution (backend='loop' would silently change the exchange "
            "semantics)")
    return backend


def _eval_clients(engine, state, specs, role: str, xt, yt) -> List[float]:
    """Test accuracy of every client's ``role`` model: batched over the
    stacked params when the cohort shares one architecture, else client by
    client."""
    specs = (list(specs) if isinstance(specs, (list, tuple))
             else [specs] * engine.K)
    if all(s == specs[0] for s in specs):
        return evaluate_batched(specs[0], engine.stacked_params(state, role),
                                xt, yt)
    return [evaluate(specs[k], engine.client_params(state, k, role), xt, yt)
            for k in range(engine.K)]


def _accountants(cfg: ProxyFLConfig, sizes: Sequence[int]
                 ) -> List[Optional[PrivacyAccountant]]:
    if not cfg.dp.enabled:
        return [None] * len(sizes)
    return [PrivacyAccountant(
        cfg.dp.noise_multiplier,
        cfg.dp.sample_rate or min(1.0, cfg.batch_size / max(n, 1)),
        cfg.dp.delta) for n in sizes]


def _checkpointer(checkpoint_dir, checkpoint_every, method: str,
                  cfg: ProxyFLConfig, seed: int,
                  private_specs: Sequence[ModelSpec], proxy_spec: ModelSpec,
                  K: int) -> Optional[FederationCheckpointer]:
    """Per-(method, seed) checkpoint directory under ``checkpoint_dir``,
    fingerprinted (config + model identities, the reference's extras) so
    a resume under a different configuration or architecture refuses."""
    if not checkpoint_dir:
        return None
    fp = config_fingerprint(cfg, method=method, seed=seed, n_clients=K,
                            private=[s.name for s in private_specs[:K]],
                            proxy=proxy_spec.name)
    return FederationCheckpointer(
        os.path.join(checkpoint_dir, f"{method}_s{seed}"),
        every=checkpoint_every or 1, fingerprint=fp,
        verify=cfg.verify_commitments)


def _eval_row(engine, state, round_no: int, roles, xt, yt) -> Dict:
    """One history row: ``roles`` is a list of (history key, spec(s),
    engine role) triples."""
    row: Dict = {"round": round_no}
    for key, specs, role in roles:
        row[key] = _eval_clients(engine, state, specs, role, xt, yt)
    return row


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
    checkpoint_dir: Optional[str] = None,
    checkpoint_every: int = 0,
    resume: bool = False,
    n_shards: Optional[int] = None,
    device="cuda",
    transmit_tamper=None,
) -> Dict:
    """Run ``cfg.rounds`` rounds of ``method`` on ``device``; return
    ``{"history", "epsilon", "clients"}`` as the reference does.

    ``history`` holds one row per evaluation (every ``eval_every`` rounds
    and after the last) with one test accuracy per client: ``{"round",
    "private_acc", "proxy_acc"}`` for ProxyFL and FML, ``{"round", "acc"}``
    for the single-model methods, whose model is ``proxy_spec`` (all
    clients share one architecture, the constraint ProxyFL removes).
    ``clients`` holds a :class:`ClientState` or a
    :class:`SingleModelClient` per client. Joint pools every client's data,
    in client order, into one client that takes ``cfg.local_steps × K``
    steps a round when ``cfg.local_steps`` is set, else one epoch of the
    pooled set; its one accountant samples at B / n_pooled.

    ``private_specs`` may name other architectures per client (ProxyFL
    and FML); their private accuracies are then evaluated client by
    client. Clients may hold different numbers of examples: each takes
    ``n_k // B`` steps a round (at least one) in epoch mode, and its
    accountant samples at B / n_k.

    ``use_pallas`` overrides ``cfg.use_pallas`` (None keeps the config).
    The engine backend is ``backend``, else ``cfg.backend``, else
    ``"auto"`` (:func:`_resolve_backend`); ``"async"`` delays delivery by
    ``cfg.staleness`` rounds and is never chosen by ``"auto"``.
    ``n_shards`` overrides ``cfg.n_shards`` (None keeps the config): the
    shard count of ``backend="hier"``'s [n_shards × clients-per-shard]
    factored exchange, whose cross-shard edges ``cfg.staleness`` delays;
    the other backends ignore it.

    ``cfg.compress`` (``"topk"`` or ``"int8"``) compresses whatever the
    method exchanges (proxies for ProxyFL and FML, the model for the
    others); Regular and Joint exchange nothing. ``cfg.verify_commitments``
    checks received proxies against their senders' commitments before
    mixing on the loop backend; ``transmit_tamper`` injects a wire
    adversary there (``(flat [K, D] numpy, t) -> flat``, e.g.
    :func:`repro_torch.core.attacks.bitflip_proxy`).

    ``checkpoint_dir`` snapshots the
    complete federation every ``checkpoint_every`` rounds (0: every round)
    under ``<dir>/<method>_s<seed>``, in the reference's files;
    ``resume=True`` restarts from the newest snapshot there and replays the
    remaining rounds bit-identically to an uninterrupted run (``history``
    then covers the resumed rounds only, or holds one final row when the
    snapshot is already at the horizon)."""
    if method not in METHODS:
        raise ValueError(f"unknown method {method!r}")
    dev = resolve_device(device)
    if use_pallas is not None:
        cfg = dataclasses.replace(cfg, use_pallas=use_pallas)
    if n_shards is not None:
        cfg = dataclasses.replace(cfg, n_shards=int(n_shards))
    backend = _resolve_backend(backend, cfg, client_data)
    K = len(client_data)
    ckpt = _checkpointer(checkpoint_dir, checkpoint_every, method, cfg,
                         seed, private_specs, proxy_spec, K)
    data = [(x.to(dev), y.to(dev)) for x, y in client_data]
    xt, yt = (t.to(dev) for t in test_data)

    if method in ("proxyfl", "fml"):
        engine = dml_engine(
            tuple(private_specs[:K]), proxy_spec, cfg, backend=backend,
            mix="pushsum" if method == "proxyfl" else "mean", device=dev)
        roles = [("private_acc", list(private_specs[:K]), "private"),
                 ("proxy_acc", proxy_spec, "proxy")]
    else:
        if method == "joint":
            data = [(torch.cat([d[0] for d in data]),
                     torch.cat([d[1] for d in data]))]
            if cfg.local_steps:
                cfg = dataclasses.replace(cfg,
                                          local_steps=cfg.local_steps * K)
        engine = single_model_engine(
            proxy_spec, cfg, cfg.dp.enabled, mix=_SINGLE_MIX[method],
            backend=backend, n_clients=len(data), device=dev)
        roles = [("acc", proxy_spec, "proxy")]
    accs = _accountants(cfg, [d[0].shape[0] for d in data])
    engine.attach_accountants(accs)
    # assigned unconditionally, so that no earlier run's adversary can
    # reach this run's exchange
    engine.transmit_tamper = transmit_tamper
    state = engine.init_states(seed)
    start = 0
    if ckpt is not None and resume:
        restored = ckpt.restore_latest(engine, like=state, seed=seed)
        if restored is not None:
            state, start = restored
    history: List[Dict] = []
    for t in range(start, cfg.rounds):
        state, _ = engine.run_round(state, data, t, seed)
        if ckpt is not None:
            ckpt.maybe_save(engine, state, t, seed=seed)
        done = t + 1
        if (eval_every > 0 and done % eval_every == 0) or done == cfg.rounds:
            history.append(_eval_row(engine, state, done, roles, xt, yt))
    if not history:
        # a resume landed at (or past) the horizon: no round ran, but
        # callers still expect a final evaluation row
        history.append(_eval_row(engine, state, start, roles, xt, yt))
    states = engine.export_states(state)
    if method in ("proxyfl", "fml"):
        clients: List = [
            ClientState(s["private"]["params"], s["private"]["opt"],
                        s["proxy"]["params"], s["proxy"]["opt"],
                        float(s["w"]), accs[k])
            for k, s in enumerate(states)]
    else:
        clients = [SingleModelClient(s["proxy"]["params"], s["proxy"]["opt"],
                                     accs[k])
                   for k, s in enumerate(states)]
    return {"history": history,
            "epsilon": [a.epsilon() if a else None for a in accs],
            "clients": clients}


def final_mean_acc(result: Dict, which: str = "auto") -> float:
    row = result["history"][-1]
    if which == "auto":
        which = "private_acc" if "private_acc" in row else "acc"
    return float(np.mean(row[which]))
