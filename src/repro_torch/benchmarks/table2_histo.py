"""Paper fig. 8 / table 2 on the port: the Camelyon-17 histopathology task
(port of ``benchmarks/table2_histo.py``). Four institutions, binary
(healthy against tumour), σ = 1.4, C = 0.7, δ = 1e-5, batch 32,
α = β = 0.3, on the synthetic binary stand-in, a Dirichlet(1.0) ragged
cohort.

Two things are checked: (i) the accuracy ordering (ProxyFL > FML ≥
FedAvg/AvgPush/CWT > Regular, Joint on top), and (ii) the privacy rows:
the RDP accountant reproduces the paper's per-client epsilons (table 2,
right: 2.36 / 2.17 / 2.08 / 2.12, Joint 1.00) from the real training-set
sizes, which is arithmetic only.

    python -m repro_torch.benchmarks.table2_histo [--full] [--device cpu]
        [--rounds N] [--train-factor F]

prints the privacy rows, then one JSON row per method as each finishes.
Quick: mlp private and proxy, 3 rounds, seed 0, half the data; ``--full``:
cnn1 private and proxy, 30 rounds, 15 seeds, all the data.
"""
from __future__ import annotations

from typing import Dict, Iterator, List

from ..core.accountant import epsilon_for
from .common import cut, driver_main, iter_methods

TRAIN_SIZES = {"C1": 2338, "C2": 2726, "C3": 2937, "C4": 2841}
PAPER_EPS = {"C1": 2.36, "C2": 2.17, "C3": 2.08, "C4": 2.12, "Joint": 1.00}
METHODS = ("proxyfl", "fml", "avgpush", "fedavg", "cwt", "regular", "joint")


def privacy_rows() -> List[Dict]:
    """Table 2 (right): each institution's epsilon after 30 epochs at
    batch 32, and Joint's on the pooled set, beside the paper's."""
    rows = []
    for c, n in TRAIN_SIZES.items():
        eps = epsilon_for(noise_multiplier=1.4, sample_rate=32 / n,
                          steps=30 * (n // 32), delta=1e-5)
        rows.append({"table": "privacy", "client": c,
                     "epsilon": round(eps, 3), "paper_epsilon": PAPER_EPS[c],
                     "rel_err": round(abs(eps - PAPER_EPS[c])
                                      / PAPER_EPS[c], 3)})
    n_joint = sum(TRAIN_SIZES.values())
    eps_j = epsilon_for(noise_multiplier=1.4, sample_rate=32 / n_joint,
                        steps=30 * (n_joint // 32), delta=1e-5)
    rows.append({"table": "privacy", "client": "Joint",
                 "epsilon": round(eps_j, 3),
                 "paper_epsilon": PAPER_EPS["Joint"],
                 "rel_err": round(abs(eps_j - 1.0), 3)})
    return rows


def configuration(full: bool) -> Dict:
    """The accuracy rows' :func:`iter_methods` arguments, the reference's."""
    arch = "cnn1" if full else "mlp"
    return dict(dataset="camelyon", methods=METHODS, n_clients=4,
                rounds=30 if full else 3,
                seeds=range(15) if full else (0,), batch_size=32, sigma=1.4,
                clip=0.7, alpha=0.3, private_arch=arch, proxy_arch=arch,
                n_train_factor=1.0 if full else 0.5)


def iter_rows(full: bool = False, device="cuda", *, rounds=None,
              n_train_factor=None) -> Iterator[Dict]:
    yield from privacy_rows()
    conf = configuration(full)
    conf.update(rounds=cut(conf["rounds"], rounds),
                n_train_factor=cut(conf["n_train_factor"], n_train_factor))
    for r in iter_methods(device=device, **conf):
        yield dict(r, table="accuracy")


def run(full: bool = False, device="cuda"):
    return list(iter_rows(full, device))


if __name__ == "__main__":
    driver_main(__doc__, iter_rows)
