"""Shared figure machinery of the port: a copy of the parts of
``benchmarks/common.py`` that fig. 3 uses, without jax.

``DATASETS`` holds the synthetic stand-ins for the paper's datasets (the
same image geometry, class count and non-IID partition as the
reference's). The draws are the port's own (torch generators on the run's
device), so a seed gives other numbers than in the JAX package; the task
seed, the partitioner and fig. 3's set-up are the reference's.
``bench_methods`` takes only the knobs fig. 3 sets; the others are fixed
at the reference's defaults, but for ``use_pallas``, on here so that the
runs go through the port's kernels.
"""
from __future__ import annotations

import time
import zlib
from typing import Dict, List, Sequence

import numpy as np
import torch

from .. import resolve_device
from ..configs import DPConfig, ProxyFLConfig
from ..core.baselines import run_federated
from ..core.engine import stream_seed
from ..core.protocol import ModelSpec
from ..data.partition import partition_major
from ..data.synthetic import make_classification_data
from ..nn.vision import get_vision_model

DATASETS = {
    "mnist": dict(shape=(28, 28, 1), n_classes=10, per_client=1000,
                  p_major=0.8, sep=2.5),
    "famnist": dict(shape=(28, 28, 1), n_classes=10, per_client=1000,
                    p_major=0.8, sep=1.8),
    "cifar10": dict(shape=(32, 32, 3), n_classes=10, per_client=3000,
                    p_major=0.3, sep=0.7),
    "kvasir": dict(shape=(25, 20, 3), n_classes=8, per_client=750,
                   p_major=None, dirichlet=0.5, sep=1.0),
    "camelyon": dict(shape=(32, 32, 3), n_classes=2, per_client=700,
                     p_major=None, dirichlet=1.0, sep=0.4),
}


def spec_of(name: str, shape, n_classes) -> ModelSpec:
    vm = get_vision_model(name)
    return ModelSpec(name, lambda g: vm.init(g, shape, n_classes), vm.apply)


def task_seed_of(dataset: str) -> int:
    """Process-independent task seed for a named dataset: crc32 of the
    name (``hash()`` on strings is salted per interpreter)."""
    return zlib.crc32(dataset.encode()) % 997


def federation_data(dataset: str, n_clients: int, seed: int, *,
                    n_train_factor: float = 1.0, device="cuda"):
    """Per-client train sets and the shared 1,000-example test set on
    ``device``, and the dataset's entry of :data:`DATASETS`. Each client
    gets ``per_client · n_train_factor`` examples by ``partition_major``
    from a pool twice the cohort's size."""
    d = DATASETS[dataset]
    if d["p_major"] is None:
        raise NotImplementedError(
            f"dataset {dataset!r} is Dirichlet-partitioned, which gives "
            "ragged (size-skewed) cohorts; they are not ported yet "
            "(ROADMAP.md Queue 1 item 4)")
    dev = resolve_device(device)
    per_client = int(d["per_client"] * n_train_factor)
    task_seed = task_seed_of(dataset)

    def draw(stream: int, n: int):
        gen = torch.Generator(device=dev).manual_seed(stream_seed(seed,
                                                                  stream))
        return make_classification_data(gen, n, d["shape"], d["n_classes"],
                                        sep=d["sep"], task_seed=task_seed)

    x, y = draw(0, per_client * n_clients * 2)
    xt, yt = draw(1, 1000)
    idxs = partition_major(np.random.default_rng(seed), y.cpu().numpy(),
                           n_clients, per_client, d["p_major"],
                           d["n_classes"])
    data = []
    for i in idxs:
        i = torch.as_tensor(i, device=dev)
        data.append((x[i], y[i]))
    return data, (xt, yt), d


# fig. 3's training set-up, the reference bench_methods' defaults: an mlp
# for every model, DP on every trained-and-shared model, batch 250 (cut to
# the mean client size), DML weight 0.5, the synchronous "auto" backend
ARCH = "mlp"
BATCH_SIZE = 250
ALPHA = 0.5
SIGMA = 1.0
CLIP = 1.0


def bench_methods(dataset: str, methods: Sequence[str], *, n_clients: int,
                  rounds: int, seeds: Sequence[int],
                  n_train_factor: float = 1.0, device="cuda") -> List[Dict]:
    """One row per method (and a ``-proxy`` row for ProxyFL and FML) with
    the reference's keys: the final test accuracy's mean and spread over
    every client of every seed, the worst epsilon over clients and seeds,
    and the method's wall-clock seconds. The DP steps and the mix run the
    port's kernels on a CUDA device (their plain versions on the CPU)."""
    rows = []
    for method in methods:
        accs, proxy_accs, eps_out = [], [], None
        t0 = time.perf_counter()
        for seed in seeds:
            client_data, test, d = federation_data(
                dataset, n_clients, seed, n_train_factor=n_train_factor,
                device=device)
            spec = spec_of(ARCH, d["shape"], d["n_classes"])
            mean_n = int(np.mean([dk[0].shape[0] for dk in client_data]))
            cfg = ProxyFLConfig(
                alpha=ALPHA, beta=ALPHA, n_clients=n_clients, rounds=rounds,
                batch_size=max(1, min(BATCH_SIZE, mean_n)), seed=seed,
                use_pallas=True,
                dp=DPConfig(enabled=True, noise_multiplier=SIGMA,
                            clip_norm=CLIP))
            res = run_federated(
                method, [spec] * n_clients, spec, client_data, test, cfg,
                seed=seed, eval_every=rounds, device=device)
            row = res["history"][-1]
            accs.extend(row["private_acc" if "private_acc" in row else "acc"])
            proxy_accs.extend(row.get("proxy_acc", []))
            eps = [e for e in res["epsilon"] if e is not None]
            if eps:
                eps_out = max(eps) if eps_out is None else max(eps_out,
                                                               max(eps))
        common = dict(epsilon=eps_out, rounds=rounds, clients=n_clients,
                      dp=True)
        rows.append(dict(dataset=dataset, method=method,
                         acc_mean=float(np.mean(accs)),
                         acc_std=float(np.std(accs)), **common,
                         seconds=time.perf_counter() - t0))
        if proxy_accs:
            rows.append(dict(dataset=dataset, method=method + "-proxy",
                             acc_mean=float(np.mean(proxy_accs)),
                             acc_std=float(np.std(proxy_accs)), **common,
                             seconds=0.0))
    return rows
