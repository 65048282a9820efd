"""Accuracy against bytes of the compressed proxy exchange on the port
(port of ``benchmarks/fig_compress.py``).

ProxyFL runs at K ∈ {4, 8, 16} on the synthetic MNIST cohort under each
wire format of :mod:`repro_torch.core.compress` (``"none"``, ``"topk"``
at ratio 0.25, ``"int8"``; error feedback on), beside an uncompressed
FedAvg, and every row pairs the final private and proxy accuracies with
the bytes of its exchange: per-client bytes a round (one proxy out and one
in for the decentralized schemes), bottleneck-node bytes a round (the
server for FedAvg), and each client's traffic over the run. The claim the
rows serve (``scripts/check_comm_claim.py``): top-k at ratio 0.25 moves at
least 4x fewer bytes than full precision with the proxy within 2 points
at 20 rounds for K ≤ 8; K = 16 is reported, not gated. The public copies
warm-start at the initial proxies (one uncompressed broadcast at set-up,
left out of the per-round bytes). DP is off, as in the reference: the
figure isolates what the codec costs.

The rows are also written as JSON (``REPRO_BENCH_COMPRESS_JSON``, default
``fig_compress.json`` in the working directory).
``REPRO_BENCH_COMPRESS_TINY=1`` shrinks the grid to one slice (K = 4, 2
rounds, 0.05 of the data) that runs every codec end to end; the gate then
checks bytes only.

    REPRO_BENCH_COMPRESS_TINY=1 python -m repro_torch.benchmarks.fig_compress
        [--full] [--device cpu]

prints one JSON row per (K, method, compression). ``--full`` runs seeds
0-2 instead of seed 0.
"""
from __future__ import annotations

import argparse
import json
import os
import time
from typing import Dict, List

import torch

from ..core.compress import wire_bytes
from ..core.gossip import comm_cost_per_round
from ..nn.modules import tree_size
from .common import DATASETS, bench_methods, spec_of

# (method, compress mode): FedAvg is the uncompressed centralized baseline
GRID = (("proxyfl", "none"), ("proxyfl", "topk"), ("proxyfl", "int8"),
        ("fedavg", "none"))
RATIO = 0.25   # the config's default top-k ratio, which the runs use


def _env_flag(name: str) -> bool:
    return os.environ.get(name, "").strip().lower() in ("1", "true", "yes",
                                                        "on")


def run(full: bool = False, device="cuda") -> List[Dict]:
    tiny = _env_flag("REPRO_BENCH_COMPRESS_TINY")
    dataset = "mnist"
    cohorts = (4,) if tiny else (4, 8, 16)
    rounds = 2 if tiny else 20
    seeds = (0, 1, 2) if full else (0,)
    ntf = 0.05 if tiny else 1.0
    d = DATASETS[dataset]
    # the mlp is both FedAvg's model and ProxyFL's proxy: one flat length
    D = tree_size(spec_of("mlp", d["shape"], d["n_classes"]).init(
        torch.Generator().manual_seed(0)))
    rows = []
    for K in cohorts:
        base_client_bytes = None
        for method, mode in GRID:
            t0 = time.time()
            bench = bench_methods(
                dataset, [method], n_clients=K, rounds=rounds, seeds=seeds,
                n_train_factor=ntf, dp=False, compress=mode, device=device)
            by_method = {r["method"]: r for r in bench}
            wb = wire_bytes(mode, D, RATIO)
            client_bytes = 2 * wb  # one message out and one in a round
            if method == "proxyfl" and mode == "none":
                base_client_bytes = client_bytes
            rows.append({
                "dataset": dataset, "clients": K, "method": method,
                "compress": mode, "ratio": RATIO, "rounds": rounds,
                "acc_mean": by_method[method]["acc_mean"],
                "acc_std": by_method[method]["acc_std"],
                "proxy_acc_mean": by_method.get(
                    method + "-proxy", {}).get("acc_mean"),
                "wire_bytes_per_msg": wb,
                "client_bytes_per_round": client_bytes,
                "bottleneck_bytes_per_round": int(comm_cost_per_round(
                    method, K, wb, wb, link_bandwidth=1.0)),
                "client_bytes_total": client_bytes * rounds,
                "reduction_vs_none": (
                    round(base_client_bytes / client_bytes, 2)
                    if base_client_bytes and method == "proxyfl" else None),
                "seconds": round(time.time() - t0, 1),
            })
    path = os.environ.get("REPRO_BENCH_COMPRESS_JSON", "fig_compress.json")
    with open(path, "w") as f:
        json.dump(rows, f, indent=1)
    return rows


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--full", action="store_true", help="seeds 0-2")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    for row in run(args.full, args.device):
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
