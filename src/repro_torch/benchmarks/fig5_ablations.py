"""Paper fig. 5 (and fig. 12) on the port: ablations on the MNIST stand-in
(port of ``benchmarks/fig5_ablations.py``).

(a) the non-IID skew sweep over ``p_major``, (b) heterogeneous private
architectures (one client each of mlp, lenet5, cnn1 and cnn2 with an mlp
proxy, beside the Regular baseline of each architecture), (c) DP on and
off, (d) the DML weight α (fig. 12).

    python -m repro_torch.benchmarks.fig5_ablations [--full] [--device cpu]
        [--rounds N] [--train-factor F]

prints one JSON row as each run finishes, with the reference's keys. The
quick configuration is the reference's (4 clients, 3 rounds, seed 0, 0.4
of the data); ``--full`` the paper's (8 clients, 30 rounds, 5 seeds; the
α sweep and (b) at 4 clients). ``--rounds`` and ``--train-factor`` cut
every run (a tiny size on the CPU).
"""
from __future__ import annotations

from typing import Dict, Iterator

import numpy as np

from ..configs import DPConfig, ProxyFLConfig
from ..core.baselines import run_federated
from .common import cut, driver_main, federation_data, iter_methods, spec_of

ALL_METHODS = ("proxyfl", "fml", "avgpush", "fedavg", "cwt", "regular",
               "joint")
HETERO_ARCHS = ("mlp", "lenet5", "cnn1", "cnn2")


def _skew(full, device, rounds, n_train_factor) -> Iterator[Dict]:
    for pm in ((0.1, 0.3, 0.5, 0.8) if full else (0.1, 0.8)):
        for m in ALL_METHODS if full else ("proxyfl", "regular", "joint"):
            for r in iter_methods(
                    "mnist", (m,), n_clients=8 if full else 4,
                    rounds=cut(30 if full else 3, rounds),
                    seeds=range(5) if full else (0,), p_major=pm,
                    n_train_factor=cut(1.0 if full else 0.4, n_train_factor),
                    device=device):
                yield dict(r, sweep="skew", p_major=pm)


def hetero_setup(full: bool, device="cuda", rounds=None,
                 n_train_factor=None):
    """Fig. 5b's run: ``(client data, test set, the four private specs,
    the mlp proxy's spec, config)`` on 4 clients, B = 250, DP on."""
    n = 4
    client_data, test, d = federation_data(
        "mnist", n, 0, n_train_factor=cut(1.0 if full else 0.4,
                                          n_train_factor), device=device)
    specs = [spec_of(a, d["shape"], d["n_classes"]) for a in HETERO_ARCHS]
    proxy = spec_of("mlp", d["shape"], d["n_classes"])
    cfg = ProxyFLConfig(n_clients=n, rounds=cut(30 if full else 3, rounds),
                        batch_size=250, use_pallas=True,
                        dp=DPConfig(enabled=True))
    return client_data, test, specs, proxy, cfg


def _hetero(full, device, rounds, n_train_factor) -> Iterator[Dict]:
    """Each client a different private architecture (fig. 5b), then the
    Regular baseline of each architecture on the same data."""
    client_data, test, specs, proxy, cfg = hetero_setup(
        full, device, rounds, n_train_factor)
    n = len(specs)
    res = run_federated("proxyfl", specs, proxy, client_data, test, cfg,
                        eval_every=cfg.rounds, device=device)
    row = res["history"][-1]
    for k, a in enumerate(HETERO_ARCHS):
        yield {"sweep": "hetero", "arch": a, "method": "proxyfl",
               "acc_mean": float(row["private_acc"][k])}
    for k, a in enumerate(HETERO_ARCHS):
        r = run_federated("regular", [specs[k]] * n, specs[k], client_data,
                          test, cfg, eval_every=cfg.rounds, device=device)
        yield {"sweep": "hetero", "arch": a, "method": "regular",
               "acc_mean": float(np.mean(r["history"][-1]["acc"]))}


def _dp_onoff(full, device, rounds, n_train_factor) -> Iterator[Dict]:
    for dp in (True, False):
        for r in iter_methods(
                "mnist", ("proxyfl", "fedavg", "regular", "joint"),
                n_clients=8 if full else 4,
                rounds=cut(30 if full else 3, rounds),
                seeds=range(5) if full else (0,), dp=dp,
                n_train_factor=cut(1.0 if full else 0.4, n_train_factor),
                device=device):
            yield dict(r, sweep="dp")


def _alpha(full, device, rounds, n_train_factor) -> Iterator[Dict]:
    for a in ((0.1, 0.3, 0.5, 0.7, 0.9) if full else (0.1, 0.9)):
        for r in iter_methods(
                "mnist", ("proxyfl",), n_clients=4,
                rounds=cut(30 if full else 3, rounds),
                seeds=range(5) if full else (0,), alpha=a,
                n_train_factor=cut(1.0 if full else 0.4, n_train_factor),
                device=device):
            yield dict(r, sweep="alpha", alpha=a)


def iter_rows(full: bool = False, device="cuda", *, rounds=None,
              n_train_factor=None) -> Iterator[Dict]:
    for sweep in (_skew, _hetero, _dp_onoff, _alpha):
        yield from sweep(full, device, rounds, n_train_factor)


def run(full: bool = False, device="cuda"):
    return list(iter_rows(full, device))


if __name__ == "__main__":
    driver_main(__doc__, iter_rows)
