"""Round-blocks: rounds/s against the block size B on the port (port of
``benchmarks/fig_blocks.py``).

The paper's O(1)-communication claim (Fig. 4) is about gossip volume; on
one card the wall-clock of a small round is the host's: building P(t),
drawing the round's batches, launching the round and reading its metrics
back, every round. ``FederationEngine.run_rounds`` runs B consecutive
rounds as one block: on the card each round is a replay of the captured
stacked round, and the host reads the metrics once, at the block's edge.
Rows: K ∈ {4, 8} (16 too with ``--full`` or ``REPRO_BENCH_FULL``) in the
gossip-bound regime (``local_steps=1``: one local step, one exchange, where
the per-round cost is largest against the work), the vmap backend at B ∈
{1, 2, 4, 8} and the loop backend at B = 1, the mlp on the mnist stand-in
(a fifth of the data; all of it with ``--full``), batch 16, DP off, the
kernels on (``REPRO_BENCH_PALLAS=0`` for the plain path). Each row: seconds
a round (best of 3 passes of ``--rounds`` rounds, 8 by default, 16 with
``--full``, after a warm-up pass; ``common.time_rounds``), rounds/s and
``speedup_vs_b1``, the
rounds/s over the same backend's B = 1 on the same cohort, beside the card
as ``nvidia-smi`` names it, with its power limit.

    python -m repro_torch.benchmarks.fig_blocks [--full] [--device cpu]
        [--clients 4 8] [--rounds N] [--train-factor F]

One JSON row a line, and all of them in ``REPRO_BENCH_BLOCKS_JSON``
(default ``fig_blocks.json`` in the working directory).
"""
from __future__ import annotations

import argparse
import json
from typing import Dict, List, Optional, Sequence

from .. import resolve_device
from ..configs import DPConfig, ProxyFLConfig
from ..core.engine import dml_engine
from ..launch.serve import device_label
from .common import (FULL, _env_flag, federation_data, spec_of, time_rounds,
                     write_rows)

BLOCKS = (1, 2, 4, 8)


def run(full: bool = FULL, device="cuda", *,
        clients: Optional[Sequence[int]] = None,
        rounds: Optional[int] = None,
        n_train_factor: Optional[float] = None) -> List[Dict]:
    dev = resolve_device(device)
    card = device_label(dev)
    use_pallas = _env_flag("REPRO_BENCH_PALLAS", default=True)
    cohorts = clients or ((4, 8, 16) if full else (4, 8))
    rounds = rounds or (16 if full else 8)
    dataset = "mnist"
    rows = []
    for K in cohorts:
        data, _, d = federation_data(
            dataset, K, 0, device=dev,
            n_train_factor=n_train_factor or (1.0 if full else 0.2))
        spec = spec_of("mlp", d["shape"], d["n_classes"])
        cfg = ProxyFLConfig(n_clients=K, rounds=rounds, local_steps=1,
                            batch_size=16, seed=0, use_pallas=use_pallas,
                            dp=DPConfig(enabled=False))
        for backend in ("loop", "vmap"):
            eng = dml_engine((spec,) * K, spec, cfg, backend=backend,
                             device=dev)
            base = None
            for block in BLOCKS if backend == "vmap" else (1,):
                sec = time_rounds(eng, data, 0, rounds, block=block)
                base = base or sec
                rows.append(dict(
                    figure="fig_blocks", dataset=dataset, clients=K,
                    backend=backend, rounds_per_block=block, local_steps=1,
                    sec_per_round=sec, rounds_per_sec=1.0 / sec,
                    speedup_vs_b1=base / sec, use_pallas=use_pallas,
                    card=card))
    write_rows(rows, "REPRO_BENCH_BLOCKS_JSON", "fig_blocks.json")
    return rows


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--full", action="store_true",
                    help="also K = 16, 16 rounds, all the data")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--clients", type=int, nargs="+", help="cohort sizes")
    ap.add_argument("--rounds", type=int, help="rounds of each timed pass")
    ap.add_argument("--train-factor", type=float,
                    help="share of each client's examples")
    args = ap.parse_args(argv)
    for row in run(args.full or FULL, args.device, clients=args.clients,
                   rounds=args.rounds, n_train_factor=args.train_factor):
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
