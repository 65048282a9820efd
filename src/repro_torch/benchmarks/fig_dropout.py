"""The §3.4 dropout sweep on the port: final accuracy against the
per-round dropout rate (port of ``benchmarks/fig_dropout.py``).

The paper claims the time-varying PushSum graph adapts to clients joining
and dropping out: learning should degrade gracefully, not collapse, as the
dropout rate grows. ProxyFL runs without DP through ``bench_methods(
dropout_rate=...)`` over a grid of rates; each rate gives its private and
its proxy row, rate 0.0 being the everyone-participates reference.

    python -m repro_torch.benchmarks.fig_dropout [--full] [--device cpu]
        [--rounds N] [--train-factor F]

Quick: 4 clients, 6 rounds, seed 0, 0.25 of the data, rates 0, 0.3 and
0.6; ``--full``: 8 clients, 30 rounds, seeds 0-2, all the data, rates 0,
0.2, 0.4 and 0.6.
"""
from __future__ import annotations

from typing import Dict, Iterator

from .common import cut, driver_main, iter_methods


def iter_rows(full: bool = False, device="cuda", *, rounds=None,
              n_train_factor=None) -> Iterator[Dict]:
    for rate in (0.0, 0.2, 0.4, 0.6) if full else (0.0, 0.3, 0.6):
        for r in iter_methods(
                "mnist", ("proxyfl",), n_clients=8 if full else 4,
                rounds=cut(30 if full else 6, rounds),
                seeds=(0, 1, 2) if full else (0,), dp=False,
                n_train_factor=cut(1.0 if full else 0.25, n_train_factor),
                dropout_rate=rate, device=device):
            yield {
                "dropout_rate": rate,
                "which": ("proxy" if r["method"].endswith("-proxy")
                          else "private"),
                **{k: r[k] for k in ("dataset", "method", "acc_mean",
                                     "acc_std", "rounds", "clients")},
            }


def run(full: bool = False, device="cuda"):
    return list(iter_rows(full, device))


if __name__ == "__main__":
    driver_main(__doc__, iter_rows)
