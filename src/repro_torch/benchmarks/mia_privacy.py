"""Empirical validation of the DP guarantee by membership inference, on
the port (port of ``benchmarks/mia_privacy.py``).

A ProxyFL federation on the MNIST stand-in, then the loss-threshold MIA
(Yeom et al.) on (a) each client's RELEASED proxy, DP-SGD-trained, the
only artifact an adversary sees, (b) the same proxy trained without DP,
and (c) the PRIVATE model (never released), against each client's own
training half. Expected: the DP proxy's AUC near 0.5, the private model's
above it. Members and non-members come from the same skewed local
distribution: each client's examples are shuffled with numpy
``default_rng(7)`` and halved, as in the reference.

    python -m repro_torch.benchmarks.mia_privacy [--full] [--device cpu]
        [--rounds N] [--train-factor F]

prints one JSON row per client and a mean row. Quick: 4 clients, 4
rounds, 0.3 of the data; ``--full``: 8 clients, 30 rounds, all the data;
both at σ = 2, C = 0.5, B = 25 (ε ≈ 2 at full).
"""
from __future__ import annotations

from typing import Dict, Iterator, List

import numpy as np
import torch

from ..configs import DPConfig, ProxyFLConfig
from ..core.attacks import loss_threshold_mia
from ..core.baselines import run_federated
from .common import cut, driver_main, federation_data, spec_of


def experiment(full: bool = False, device="cuda", *, rounds=None,
               n_train_factor=None) -> Dict:
    """The two federations (DP on and off) on each client's training
    half: ``{"members", "holdouts", "spec", "results": {dp: result}}``."""
    n = 8 if full else 4
    client_data, test, d = federation_data(
        "mnist", n, 0,
        n_train_factor=cut(1.0 if full else 0.3, n_train_factor),
        device=device)
    members, holdouts = [], []
    rng = np.random.default_rng(7)
    for x, y in client_data:
        # shuffle before halving: partition_major places the major class
        # first, so a raw half-split would measure class composition
        perm = torch.as_tensor(rng.permutation(x.shape[0]), device=x.device)
        x, y = x[perm], y[perm]
        h = x.shape[0] // 2
        members.append((x[:h], y[:h]))
        holdouts.append((x[h:], y[h:]))
    spec = spec_of("mlp", d["shape"], d["n_classes"])
    results = {}
    for dp in (True, False):
        cfg = ProxyFLConfig(n_clients=n,
                            rounds=cut(30 if full else 4, rounds),
                            batch_size=25, use_pallas=True,
                            dp=DPConfig(enabled=dp, noise_multiplier=2.0,
                                        clip_norm=0.5))
        results[dp] = run_federated("proxyfl", [spec] * n, spec, members,
                                    test, cfg, eval_every=cfg.rounds,
                                    device=device)
    return dict(members=members, holdouts=holdouts, spec=spec,
                results=results)


def rows_of(exp: Dict) -> List[Dict]:
    """One row per client (the three AUCs and its epsilon) and a mean."""
    spec, results = exp["spec"], exp["results"]
    rows = []
    for k, (members, holdout) in enumerate(zip(exp["members"],
                                               exp["holdouts"])):
        def auc(dp, which):
            return loss_threshold_mia(
                spec.apply, getattr(results[dp]["clients"][k], which),
                members, holdout)
        rows.append({"client": k,
                     "mia_auc_proxy_dp": round(auc(True, "proxy_params"), 4),
                     "mia_auc_proxy_no_dp": round(
                         auc(False, "proxy_params"), 4),
                     "mia_auc_private_nonreleased": round(
                         auc(True, "private_params"), 4),
                     "epsilon": round(results[True]["epsilon"][k], 3)})
    mean = {key: round(float(np.mean([r[key] for r in rows])), 4)
            for key in ("mia_auc_proxy_dp", "mia_auc_proxy_no_dp",
                        "mia_auc_private_nonreleased")}
    rows.append({"client": "mean", **mean, "epsilon": rows[0]["epsilon"]})
    return rows


def iter_rows(full: bool = False, device="cuda", *, rounds=None,
              n_train_factor=None) -> Iterator[Dict]:
    yield from rows_of(experiment(full, device, rounds=rounds,
                                  n_train_factor=n_train_factor))


def run(full: bool = False, device="cuda"):
    return list(iter_rows(full, device))


if __name__ == "__main__":
    driver_main(__doc__, iter_rows)
