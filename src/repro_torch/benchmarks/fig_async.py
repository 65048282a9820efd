"""Async stale gossip on the port: final accuracy and rounds/s against the
staleness τ (port of ``benchmarks/fig_async.py``).

The synchronous PushSum exchange blocks every client on its in-neighbour's
current proxy, so one straggler stalls the cohort; the ``async`` backend
merges proxy mass sent τ rounds earlier instead (Assran et al. 2019), so
communication can hide behind the next τ rounds of local steps. The mix
then reads τ-round-old proxies, and consensus, with it the proxy's
accuracy, can lag. For τ ∈ {0, 1, 2, 4}: the final mean proxy and private
accuracy of a ProxyFL federation on the mnist stand-in (4 clients, 12
rounds, seed 0, a fifth of the data; ``--full``: 8 clients, 30 rounds,
seeds 0-2, all of it), 2 local steps of batch 64, DP off, the kernels on
(``REPRO_BENCH_PALLAS=0`` for the plain path), τ = 0 on the sync (vmap)
backend, which the async backend at τ = 0 equals bit for bit; each row
with ``acc_delta_vs_sync`` and rounds/s on seed 0's cohort (best of 3
passes from a fresh state, after a warm-up pass), beside the card as
``nvidia-smi`` names it, with its power limit.

The reference runs each federation, and times each pass, as one compiled
round-block (``rounds_per_block=rounds``); any block size gives its
trajectory bit for bit, so here the rounds run one at a time, and the
rounds/s column measures the per-round loop until fused blocks land
(ROADMAP.md Queue 1 item 5).

    python -m repro_torch.benchmarks.fig_async [--full] [--device cpu]
        [--rounds N] [--train-factor F]

One JSON row a line, and all of them in ``REPRO_BENCH_ASYNC_JSON``
(default ``fig_async.json`` in the working directory).
"""
from __future__ import annotations

import argparse
import json
from typing import Dict, List, Optional

import numpy as np

from .. import resolve_device
from ..configs import DPConfig, ProxyFLConfig
from ..core.baselines import run_federated
from ..core.engine import dml_engine
from ..launch.serve import device_label
from .common import (FULL, _env_flag, federation_data, spec_of, time_rounds,
                     write_rows)

STALENESS = (0, 1, 2, 4)


def run(full: bool = FULL, device="cuda", *, rounds: Optional[int] = None,
        n_train_factor: Optional[float] = None) -> List[Dict]:
    dev = resolve_device(device)
    card = device_label(dev)
    use_pallas = _env_flag("REPRO_BENCH_PALLAS", default=True)
    n_clients = 8 if full else 4
    rounds = rounds or (30 if full else 12)
    seeds = (0, 1, 2) if full else (0,)
    dataset = "mnist"
    rows = []
    sync_proxy = None
    for tau in STALENESS:
        accs, paccs = [], []
        backend = "vmap" if tau == 0 else "async"
        for seed in seeds:
            client_data, test, d = federation_data(
                dataset, n_clients, seed, device=dev,
                n_train_factor=n_train_factor or (1.0 if full else 0.2))
            spec = spec_of("mlp", d["shape"], d["n_classes"])
            cfg = ProxyFLConfig(
                n_clients=n_clients, rounds=rounds, local_steps=2,
                batch_size=64, seed=seed, staleness=tau,
                use_pallas=use_pallas, dp=DPConfig(enabled=False))
            res = run_federated(
                "proxyfl", [spec] * n_clients, spec, client_data, test,
                cfg, seed=seed, eval_every=rounds, backend=backend,
                device=dev)
            row = res["history"][-1]
            accs.extend(row["private_acc"])
            paccs.extend(row["proxy_acc"])
            if seed == seeds[0]:
                eng = dml_engine((spec,) * n_clients, spec, cfg,
                                 backend=backend, device=dev)
                sec = time_rounds(eng, client_data, 0, rounds, fresh=True)
        proxy_mean = float(np.mean(paccs))
        if tau == 0:
            sync_proxy = proxy_mean
        rows.append({
            "dataset": dataset, "clients": n_clients, "rounds": rounds,
            "staleness": tau,
            "backend": "vmap (sync ref)" if tau == 0 else "async",
            "proxy_acc_mean": proxy_mean,
            "proxy_acc_std": float(np.std(paccs)),
            "private_acc_mean": float(np.mean(accs)),
            "acc_delta_vs_sync": proxy_mean - sync_proxy,
            "sec_per_round": sec, "rounds_per_sec": 1.0 / sec,
            "rounds_per_block": 1, "use_pallas": use_pallas, "card": card,
        })
    write_rows(rows, "REPRO_BENCH_ASYNC_JSON", "fig_async.json")
    return rows


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--full", action="store_true",
                    help="8 clients, 30 rounds, seeds 0-2, all the data")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--rounds", type=int, help="rounds of every run")
    ap.add_argument("--train-factor", type=float,
                    help="share of each client's examples")
    args = ap.parse_args(argv)
    for row in run(args.full or FULL, args.device, rounds=args.rounds,
                   n_train_factor=args.train_factor):
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
