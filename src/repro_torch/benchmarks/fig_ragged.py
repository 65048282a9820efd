"""Ragged cohorts: seconds a round of the stacked executor against the
loop on a size-skewed cohort (port of ``benchmarks/fig_ragged.py``).

The paper's Dirichlet partitions (§4.3/4.4) give every client its own
number of examples. The stacked executor pads the cohort to one stack,
draws each client's batch below its own length and, in epoch mode, freezes
a client once it has taken its ``n_k // B`` steps; the loop runs each
client as it is. One engine a backend runs the same Dirichlet(0.5) kvasir
cohort (8 clients, 40% of the data; ``--full``: 16 clients, all of it), the
mlp, batch 16, DP off, the kernels on (``REPRO_BENCH_PALLAS=0`` for the
plain path), in two regimes:

* ``gossip`` — ``local_steps=1``: one local step and one exchange a round;
  the step counts are uniform, so the padding costs only the padded copy
  and the bounded draws.
* ``epoch`` — ``local_steps=0``: each client takes its own ``n_k // B``
  steps. The stacked round runs the cohort's largest step count with the
  exhausted clients masked, so it does work in proportion to the padding
  that the loop skips: the trade is reported, not hidden.

Each row: seconds a round (best of 3 passes of ``--rounds`` rounds, 4 by
default, 6 with ``--full``, round by round after a warm-up pass;
``common.time_rounds``), the smallest and
largest client, the padded share of the stack and ``speedup_vs_loop``,
beside the card as ``nvidia-smi`` names it, with its power limit.

    python -m repro_torch.benchmarks.fig_ragged [--full] [--device cpu]
        [--rounds N] [--train-factor F]

One JSON row a line, and all of them in ``REPRO_BENCH_RAGGED_JSON``
(default ``fig_ragged.json`` in the working directory).
"""
from __future__ import annotations

import argparse
import json
from typing import Dict, List, Optional

import numpy as np

from .. import resolve_device
from ..configs import DPConfig, ProxyFLConfig
from ..core.engine import dml_engine
from ..launch.serve import device_label
from .common import (FULL, _env_flag, federation_data, spec_of, time_rounds,
                     write_rows)


def run(full: bool = FULL, device="cuda", *, rounds: Optional[int] = None,
        n_train_factor: Optional[float] = None) -> List[Dict]:
    dev = resolve_device(device)
    card = device_label(dev)
    use_pallas = _env_flag("REPRO_BENCH_PALLAS", default=True)
    K = 16 if full else 8
    rounds = rounds or (6 if full else 4)
    dataset = "kvasir"      # Dirichlet(0.5): ragged by construction
    data, _, d = federation_data(
        dataset, K, 0, device=dev,
        n_train_factor=n_train_factor or (1.0 if full else 0.4))
    sizes = np.asarray([x.shape[0] for x, _ in data])
    pad = float(1.0 - sizes.sum() / (sizes.max() * K))
    spec = spec_of("mlp", d["shape"], d["n_classes"])
    rows = []
    for regime, local_steps in (("gossip", 1), ("epoch", 0)):
        # a fixed batch: the draws are with replacement and bounded by each
        # client's length, so B > n_k is fine for a tiny client
        cfg = ProxyFLConfig(n_clients=K, rounds=rounds,
                            local_steps=local_steps, batch_size=16, seed=0,
                            use_pallas=use_pallas,
                            dp=DPConfig(enabled=False))
        secs = {b: time_rounds(dml_engine((spec,) * K, spec, cfg, backend=b,
                                          device=dev), data, 0, rounds,
                               block=1)
                for b in ("loop", "vmap")}
        rows += [dict(figure="fig_ragged", dataset=dataset, clients=K,
                      regime=regime, backend=b, min_client=int(sizes.min()),
                      max_client=int(sizes.max()), pad_fraction=pad,
                      sec_per_round=secs[b], rounds_per_sec=1.0 / secs[b],
                      speedup_vs_loop=secs["loop"] / secs[b],
                      use_pallas=use_pallas, card=card)
                 for b in ("loop", "vmap")]
    write_rows(rows, "REPRO_BENCH_RAGGED_JSON", "fig_ragged.json")
    return rows


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--full", action="store_true",
                    help="16 clients, 6 rounds, all the data")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--rounds", type=int, help="rounds of each timed pass")
    ap.add_argument("--train-factor", type=float,
                    help="share of each client's examples")
    args = ap.parse_args(argv)
    for row in run(args.full or FULL, args.device, rounds=args.rounds,
                   n_train_factor=args.train_factor):
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
