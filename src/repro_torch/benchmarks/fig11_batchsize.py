"""Paper fig. 11 on the port: the effect of the batch size on the privacy
guarantee (port of ``benchmarks/fig11_batchsize.py``). Smaller batches
(a lower sampling rate q) give a much stronger (ε, δ) at equal epochs.
Accountant arithmetic only: no model and no device.

    python -m repro_torch.benchmarks.fig11_batchsize

prints one JSON row per batch size, equal to the reference's.
"""
from __future__ import annotations

import json
from typing import Dict, List

from ..core.accountant import epsilon_for


def run(full: bool = False) -> List[Dict]:
    """The reference's rows (``full`` changes nothing, as there)."""
    n = 1000  # per-client training set size (the paper's MNIST setting)
    epochs = 30
    rows = []
    for b in (10, 25, 50, 125, 250):
        steps = epochs * max(1, n // b)
        rows.append({
            "batch_size": b, "sample_rate": b / n, "steps": steps,
            "epsilon": round(epsilon_for(noise_multiplier=1.0,
                                         sample_rate=b / n, steps=steps,
                                         delta=1e-5), 3),
        })
    return rows


if __name__ == "__main__":
    for row in run():
        print(json.dumps(row))
