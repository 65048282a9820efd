"""Paper fig. 3 on the port: test accuracy of all seven methods on the
synthetic MNIST, FaMNIST and CIFAR-10 stand-ins under DP training, 8
clients, non-IID skew (port of ``benchmarks/fig3_accuracy.py``). The
claim it checks is the ORDERING: ProxyFL-private ≥ FML-private >
decentralized singles ≥ centralized singles ≥ Regular, with Joint as the
upper bound.

    python -m repro_torch.benchmarks.fig3_accuracy [--full] [--seeds N]

prints one JSON row per method (and per ``-proxy`` model) as each
finishes, then one line per link of the ordering with its verdict. The quick configuration runs mnist and cifar10 with 4 clients,
3 rounds, seed 0 and 0.4 of the data; ``--full`` the paper's three
datasets with 8 clients, 30 rounds and 5 seeds. ``--device cpu`` runs
the plain versions on the CPU (with ``--rounds``, ``--clients`` and
``--train-factor`` to cut it to a tiny size).
"""
from __future__ import annotations

import argparse
import json
from typing import Dict, Iterator, List, Optional, Sequence

from .common import bench_methods

METHODS = ("proxyfl", "fml", "avgpush", "fedavg", "cwt", "regular", "joint")


def configuration(full: bool) -> Dict:
    """The reference's two configurations."""
    if full:
        return dict(datasets=("mnist", "famnist", "cifar10"), n_clients=8,
                    rounds=30, seeds=range(5), n_train_factor=1.0)
    return dict(datasets=("mnist", "cifar10"), n_clients=4, rounds=3,
                seeds=(0,), n_train_factor=0.4)


def iter_rows(full: bool = False, device="cuda", *,
              datasets: Optional[Sequence[str]] = None,
              **overrides) -> Iterator[Dict]:
    """Fig. 3's rows, one method at a time; ``datasets`` and any key of
    :func:`configuration` (``n_clients``, ``rounds``, ``seeds``,
    ``n_train_factor``) override the configuration."""
    conf = configuration(full)
    default = conf.pop("datasets")
    conf.update(overrides)
    for ds in datasets or default:
        for method in METHODS:
            yield from bench_methods(ds, (method,), device=device, **conf)


def run(full: bool = False, device="cuda"):
    return list(iter_rows(full, device))


# the links of the claimed ordering, (left, relation, right) on the mean
# accuracies: ProxyFL-private ≥ FML-private > AvgPush/CWT ≥ FedAvg ≥
# Regular, with Joint above every other method
LINKS = ([("proxyfl", ">=", "fml"), ("fml", ">", "avgpush"),
          ("fml", ">", "cwt"), ("avgpush", ">=", "fedavg"),
          ("cwt", ">=", "fedavg"), ("fedavg", ">=", "regular")]
         + [("joint", ">=", m) for m in METHODS if m != "joint"])


def ordering(rows) -> List[Dict]:
    """Each link of the claimed ordering, per dataset of ``rows``: both
    means, both spreads and whether the link holds (``met``)."""
    by = {(r["dataset"], r["method"]): r for r in rows}
    out = []
    for ds in dict.fromkeys(r["dataset"] for r in rows):
        for a, rel, b in LINKS:
            if (ds, a) not in by or (ds, b) not in by:
                continue
            ra, rb = by[ds, a], by[ds, b]
            met = (ra["acc_mean"] >= rb["acc_mean"] if rel == ">="
                   else ra["acc_mean"] > rb["acc_mean"])
            out.append(dict(dataset=ds, link=f"{a} {rel} {b}",
                            left=ra["acc_mean"], right=rb["acc_mean"],
                            left_std=ra["acc_std"], right_std=rb["acc_std"],
                            met=met))
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--full", action="store_true",
                    help="the paper's configuration")
    ap.add_argument("--seeds", type=int, help="seeds 0 .. N-1")
    ap.add_argument("--datasets", nargs="+", help="a subset of datasets")
    ap.add_argument("--rounds", type=int)
    ap.add_argument("--clients", type=int)
    ap.add_argument("--train-factor", type=float)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    overrides = {k: v for k, v in dict(
        seeds=None if args.seeds is None else range(args.seeds),
        rounds=args.rounds, n_clients=args.clients,
        n_train_factor=args.train_factor).items() if v is not None}
    rows = []
    for row in iter_rows(args.full, args.device, datasets=args.datasets,
                         **overrides):
        rows.append(row)
        print(json.dumps(row), flush=True)
    for verdict in ordering(rows):
        print(json.dumps(verdict), flush=True)


if __name__ == "__main__":
    main()
