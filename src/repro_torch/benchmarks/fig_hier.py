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
machinery, not the model. Each pass is one round-block of ``--rounds``
rounds (8 by default; ``rounds_per_block`` in the rows), as in the
reference: the stacked backends replay their captured round on the card,
the loop runs its clients one at a time. Each row carries the card as
``nvidia-smi`` names it, with its power limit.

The reference's ``shard_map`` row (one client per device of a mesh, the
exchange a send/recv to the round's peer) runs under the reference's
condition, K equal to the device count: on the card K =
``torch.cuda.device_count()`` NCCL ranks, with ``--device cpu`` K = 8 gloo
ranks (the reference's forced host mesh); each rank a process, spawned by
the driver, the row timed on rank 0. On one card no K matches and no row
is printed, as the reference prints none when K is not its device count.

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
import os
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
CPU_RANKS = 8          # the reference's forced 8-device host mesh
NOTE_SHARD = ("one client per rank: bounded by the device count, the flat "
              "layout cannot reach K=64+")
NOTE_STALE = ("one card: tau>0 overlaps no network latency; the wall-clock "
              "win needs genuine inter-node latency")


def cross_bytes_per_client(K: int, S: int, rounds: int, D: int) -> float:
    """Mean analytic cross-shard f32 wire bytes a client sends a round:
    the share of clients with a cross-shard in-edge times 4·D, O(D)
    whatever K."""
    _, _, scale = hier_mix_schedule("pushsum", 0, rounds, K, S)
    return float((np.asarray(scale) > 0).mean()) * 4 * D


def cfg_of(K, n_rounds, use_pallas, n_shards=1, staleness=0):
    return ProxyFLConfig(n_clients=K, rounds=n_rounds, local_steps=1,
                         batch_size=8, seed=0, n_shards=n_shards,
                         staleness=staleness, use_pallas=use_pallas,
                         dp=DPConfig(enabled=False))


def cohort_data(K: int, dev):
    x, y = make_classification_data(
        torch.Generator(device=dev).manual_seed(1), PER_CLIENT * K,
        SHAPE, N_CLASSES, sep=2.0, task_seed=7)
    return [(x[k * PER_CLIENT:(k + 1) * PER_CLIENT],
             y[k * PER_CLIENT:(k + 1) * PER_CLIENT]) for k in range(K)]


def _shard_map_rank(rank, K, store, rounds, use_pallas, device_type, out):
    """Rank ``rank`` of the shard_map row: the group and mesh (NCCL, one
    card a rank, or gloo), the engine, ``time_rounds``; rank 0 writes the
    seconds a round to ``out``."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    if device_type == "cuda":
        torch.cuda.set_device(rank)
        dev = torch.device("cuda", rank)
        dist.init_process_group("nccl", init_method="file://" + store,
                                rank=rank, world_size=K, device_id=dev)
    else:
        torch.set_num_threads(1)
        dev = torch.device("cpu")
        dist.init_process_group("gloo", init_method="file://" + store,
                                rank=rank, world_size=K)
    try:
        mesh = init_device_mesh(device_type, (K,),
                                mesh_dim_names=("clients",))
        spec = spec_of("mlp", SHAPE, N_CLASSES)
        eng = dml_engine((spec,) * K, spec, cfg_of(K, rounds, use_pallas),
                         backend="shard_map", device=dev, mesh=mesh)
        sec = time_rounds(eng, cohort_data(K, dev), 0, rounds)
        if rank == 0:
            with open(out, "w") as f:
                f.write(repr(sec))
    finally:
        dist.destroy_process_group()


def shard_map_seconds(K: int, rounds: int, use_pallas: bool,
                      device_type: str) -> float:
    """Seconds a round of the shard_map backend at K clients on K ranks
    (spawned processes, a file store in a temporary directory)."""
    import tempfile
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "sec")
        mp.start_processes(_shard_map_rank,
                           args=(K, os.path.join(tmp, "store"), rounds,
                                 use_pallas, device_type, out),
                           nprocs=K, start_method="spawn")
        with open(out) as f:
            return float(f.read())


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
    n_dev = (torch.cuda.device_count() if dev.type == "cuda"
             else CPU_RANKS)

    rows = []
    for K in Ks:
        data = cohort_data(K, dev)
        big = K >= 256
        grid = [("loop", 1, 0), ("vmap", 1, 0), ("hier", min(SHARDS, K), 0),
                ("hier", min(SHARDS, K), 2)]
        base = None
        for backend, S, tau in grid:
            n = min(rounds, 4) if backend == "loop" and big else rounds
            eng = dml_engine((spec,) * K, spec,
                             cfg_of(K, n, use_pallas, S, tau),
                             backend=backend, device=dev)
            sec = time_rounds(eng, data, 0, n, trials=2 if big else 3)
            base = base or sec
            rows.append(dict(
                figure="fig_hier", K=K, backend=backend, n_shards=S,
                staleness=tau, rounds_per_block=n, devices=1,
                sec_per_round=sec, rounds_per_sec=1.0 / sec,
                speedup_vs_loop=base / sec,
                bytes_cross_per_client=(
                    cross_bytes_per_client(K, S, rounds, D)
                    if backend == "hier" else None),
                use_pallas=use_pallas, card=card,
                note=NOTE_STALE if tau else ""))
        if K == n_dev:
            sec = shard_map_seconds(K, rounds, use_pallas, dev.type)
            rows.append(dict(
                figure="fig_hier", K=K, backend="shard_map", n_shards=K,
                staleness=0, rounds_per_block=rounds, devices=n_dev,
                sec_per_round=sec, rounds_per_sec=1.0 / sec,
                speedup_vs_loop=base / sec, bytes_cross_per_client=4.0 * D,
                use_pallas=use_pallas, card=card, note=NOTE_SHARD))
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
