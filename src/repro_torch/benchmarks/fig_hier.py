"""Two-level hier gossip: rounds/s of the hier backend against the flat
backends as the cohort grows, on the port (port of
``benchmarks/fig_hier.py``).

The hier backend factors the flat PushSum matrix P(t) into a
block-diagonal intra-shard part, mixed on the card by one launch of the
shard-grid mix kernel (``kernels.fused_pushsum_mix_blocks``), and at most
one cross-shard edge into each client a round, a gather: the traffic a
deployment sends between nodes. Rows, for K ∈ {8, 64, 256} (1,024 with
``--full`` or ``REPRO_BENCH_FULL``): the loop backend (the baseline), vmap,
hier at S = 8 shards with τ = 0, and hier at τ = 2 (the cross-shard edges
two rounds late); each with seconds a round (best of 3 passes, 2 at K ≥
256, after a warm-up pass), rounds/s, the speed-up over loop and, for
hier, the analytic cross-shard wire bytes a client sends a round, which
stay flat in K. A tiny mlp on 8x8x1 images, 4 classes, 32 examples a
client, DP off, one local step of batch 8, the kernels on
(``REPRO_BENCH_PALLAS=0`` for the plain path): the rows time the round
machinery, not the model. Each row carries the card as ``nvidia-smi``
names it, with its power limit.

Rows the reference has and this port lacks:

* ``shard_map`` at K = 8, one client per device of a mesh: ROADMAP.md
  Queue 1 item 12;
* blocked timing (8 rounds as one compiled program): item 5. Rounds run
  one at a time here, every backend loops over its clients in Python, and
  ``rounds_per_block`` reads 1.

The reference ran its rows in a subprocess with a forced 8-device host
mesh (JAX fixes its device count at start-up); the port needs neither. On
one card τ > 0 hides no network latency: the τ = 0 / τ = 2 ratio bounds
the buffer's cost, nothing more.

    python -m repro_torch.benchmarks.fig_hier [--full] [--device cpu]
        [--clients 8 64] [--rounds N]

One JSON row a line, and all of them in ``REPRO_BENCH_HIER_JSON`` (default
``fig_hier.json`` in the working directory).
"""
from __future__ import annotations

import argparse
import json
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .. import resolve_device
from ..configs import DPConfig, ProxyFLConfig
from ..core.engine import dml_engine
from ..core.gossip import hier_mix_schedule
from ..data.synthetic import make_classification_data
from ..launch.serve import device_label
from ..nn.modules import tree_size
from .common import FULL, _env_flag, spec_of, time_rounds, write_rows

SHAPE, N_CLASSES, PER_CLIENT = (8, 8, 1), 4, 32
SHARDS = 8
NOTE_STALE = ("one card: tau>0 overlaps no network latency; the wall-clock "
              "win needs genuine inter-node latency")


def cross_bytes_per_client(K: int, S: int, rounds: int, D: int) -> float:
    """Mean analytic cross-shard f32 wire bytes a client sends a round:
    the share of clients with a cross-shard in-edge times 4·D, O(D)
    whatever K."""
    _, _, scale = hier_mix_schedule("pushsum", 0, rounds, K, S)
    return float((np.asarray(scale) > 0).mean()) * 4 * D


def run(full: bool = FULL, device="cuda", *,
        clients: Optional[Sequence[int]] = None,
        rounds: Optional[int] = None) -> List[Dict]:
    dev = resolve_device(device)
    card = device_label(dev)
    use_pallas = _env_flag("REPRO_BENCH_PALLAS", default=True)
    spec = spec_of("mlp", SHAPE, N_CLASSES)
    D = tree_size(spec.init(torch.Generator().manual_seed(0)))
    Ks = clients or ((8, 64, 256, 1024) if full else (8, 64, 256))
    rounds = rounds or 8

    def cfg_of(K, n_rounds, n_shards=1, staleness=0):
        return ProxyFLConfig(n_clients=K, rounds=n_rounds, local_steps=1,
                             batch_size=8, seed=0, n_shards=n_shards,
                             staleness=staleness, use_pallas=use_pallas,
                             dp=DPConfig(enabled=False))

    rows = []
    for K in Ks:
        x, y = make_classification_data(
            torch.Generator(device=dev).manual_seed(1), PER_CLIENT * K,
            SHAPE, N_CLASSES, sep=2.0, task_seed=7)
        data = [(x[k * PER_CLIENT:(k + 1) * PER_CLIENT],
                 y[k * PER_CLIENT:(k + 1) * PER_CLIENT]) for k in range(K)]
        big = K >= 256
        grid = [("loop", 1, 0), ("vmap", 1, 0), ("hier", min(SHARDS, K), 0),
                ("hier", min(SHARDS, K), 2)]
        base = None
        for backend, S, tau in grid:
            n = min(rounds, 4) if backend == "loop" and big else rounds
            eng = dml_engine((spec,) * K, spec, cfg_of(K, n, S, tau),
                             backend=backend, device=dev)
            sec = time_rounds(eng, data, 0, n, trials=2 if big else 3)
            base = base or sec
            rows.append(dict(
                figure="fig_hier", K=K, backend=backend, n_shards=S,
                staleness=tau, rounds_per_block=1, devices=1,
                sec_per_round=sec, rounds_per_sec=1.0 / sec,
                speedup_vs_loop=base / sec,
                bytes_cross_per_client=(
                    cross_bytes_per_client(K, S, rounds, D)
                    if backend == "hier" else None),
                use_pallas=use_pallas, card=card,
                note=NOTE_STALE if tau else ""))
    write_rows(rows, "REPRO_BENCH_HIER_JSON", "fig_hier.json")
    return rows


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--full", action="store_true", help="also K = 1,024")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--clients", type=int, nargs="+",
                    help="cohort sizes (each a multiple of 8)")
    ap.add_argument("--rounds", type=int, help="rounds of each timed pass")
    args = ap.parse_args(argv)
    for row in run(args.full or FULL, args.device, clients=args.clients,
                   rounds=args.rounds):
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
