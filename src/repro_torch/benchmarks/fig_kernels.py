"""The kernels on and off: rounds/s of a DP ProxyFL round with the port's
kernels against its plain path (port of ``benchmarks/fig_kernels.py``).

Two chains dominate a round's device traffic: the PushSum exchange (P·z,
P·w, the de-bias: three [K, D] passes on the plain path) and the DP proxy
update (per-example clip, accumulate, noise, Adam: each a pass over the
gradients). ``ProxyFLConfig.use_pallas`` runs both through the
hand-written kernels (the rows route of the clip pair, ``noise_adam_step``
and the mix kernel), which touch each [K, D] once. Rows: rounds/s with the
kernels off (``path="plain"``) and on (``"fused"``) on identical DP
cohorts, K ∈ {4, 8, 16} (mnist stand-in, mlp, 2 local steps of batch 16,
σ = 1, C = 1, the vmap backend; 4 rounds timed, 8 with ``--full``, best
of 3 passes after a warm-up pass), with ``speedup_fused`` and the analytic
bytes an exchange moves (f32, D the proxy's size): plain ``4·(4·K·D)``
(read [K, D], write P·z, read it back, write z′), fused ``2·(4·K·D)``.
Each row carries the card as ``nvidia-smi`` names it, with its power
limit. On the CPU both paths run plain torch (the kernels' plain
versions), so only the card's rows compare the kernels.

    python -m repro_torch.benchmarks.fig_kernels [--full] [--device cpu]
        [--clients 4 8] [--rounds N] [--train-factor F]

One JSON row a line, and all of them in ``REPRO_BENCH_KERNELS_JSON``
(default ``fig_kernels.json`` in the working directory).
"""
from __future__ import annotations

import argparse
import json
from typing import Dict, List, Optional, Sequence

import torch

from .. import resolve_device
from ..configs import DPConfig, ProxyFLConfig
from ..core.engine import dml_engine
from ..launch.serve import device_label
from ..nn.modules import tree_size
from .common import FULL, federation_data, spec_of, time_rounds, write_rows


def run(full: bool = FULL, device="cuda", *,
        clients: Optional[Sequence[int]] = None,
        rounds: Optional[int] = None,
        n_train_factor: Optional[float] = None) -> List[Dict]:
    dev = resolve_device(device)
    card = device_label(dev)
    rounds = rounds or (8 if full else 4)
    dataset = "mnist"
    rows = []
    for n_clients in clients or (4, 8, 16):
        client_data, _, d = federation_data(
            dataset, n_clients, seed=0, device=dev,
            n_train_factor=n_train_factor or (1.0 if full else 0.2))
        spec = spec_of("mlp", d["shape"], d["n_classes"])
        D = tree_size(spec.init(torch.Generator().manual_seed(0)))
        bytes_kd = 4 * n_clients * D  # one f32 [K, D] pass
        base = None
        for fused in (False, True):
            cfg = ProxyFLConfig(
                n_clients=n_clients, rounds=rounds, local_steps=2,
                batch_size=16, seed=0, use_pallas=fused,
                dp=DPConfig(enabled=True, noise_multiplier=1.0,
                            clip_norm=1.0))
            engine = dml_engine((spec,) * n_clients, spec, cfg,
                                backend="vmap", device=dev)
            sec = time_rounds(engine, client_data, 0, rounds)
            base = base or sec
            rows.append({
                "dataset": dataset, "clients": n_clients, "d_params": D,
                "path": "fused" if fused else "plain",
                "sec_per_round": sec, "rounds_per_sec": 1.0 / sec,
                "exchange_bytes_per_round": (2 if fused else 4) * bytes_kd,
                "speedup_fused": base / sec, "card": card,
            })
    write_rows(rows, "REPRO_BENCH_KERNELS_JSON", "fig_kernels.json")
    return rows


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--full", action="store_true", help="8 timed rounds, "
                    "all the data")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--clients", type=int, nargs="+")
    ap.add_argument("--rounds", type=int, help="rounds of each timed pass")
    ap.add_argument("--train-factor", type=float,
                    help="share of each client's examples")
    args = ap.parse_args(argv)
    for row in run(args.full or FULL, args.device, clients=args.clients,
                   rounds=args.rounds, n_train_factor=args.train_factor):
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
