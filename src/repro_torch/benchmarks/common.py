"""Shared figure machinery of the port: a copy of the parts of
``benchmarks/common.py`` that the ported figure drivers use, without jax.

``DATASETS`` holds the synthetic stand-ins for the paper's datasets (the
same image geometry, class count and non-IID partition as the
reference's). The draws are the port's own (torch generators on the run's
device), so a seed gives other numbers than in the JAX package; the task
seed, the partitioners and each figure's set-up are the reference's.
``bench_methods`` takes every knob of the reference's but
``rounds_per_block`` (fused round-blocks: ROADMAP.md Queue 1 item 5), each
at the reference's default and read from the reference's environment
variable when unset, but for ``use_pallas``, on by default here so that
the runs go through the port's kernels (``REPRO_BENCH_PALLAS=0`` turns it
off). ``FULL`` is ``REPRO_BENCH_FULL``, the default budget of the drivers
that the runner (:mod:`.run`) calls without ``--full``.
"""
from __future__ import annotations

import argparse
import json
import os
import time
import zlib
from typing import (Callable, Dict, Iterable, Iterator, List, Optional,
                    Sequence)

import numpy as np
import torch

from .. import resolve_device
from ..configs import DPConfig, ProxyFLConfig
from ..core.baselines import run_federated
from ..core.engine import stream_seed
from ..core.protocol import ModelSpec
from ..data.partition import partition_dirichlet, partition_major
from ..data.synthetic import make_classification_data
from ..launch.serve import sync
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


def _env_int(name: str) -> int:
    raw = os.environ.get(name, "").strip()
    try:
        return int(raw) if raw else 0
    except ValueError:
        raise SystemExit(f"{name} must be an integer, got {raw!r}")


def _env_flag(name: str, default: bool = False) -> bool:
    """``1``, ``true``, ``yes`` or ``on`` (any case) is true; unset or
    empty is ``default``; anything else is false."""
    raw = os.environ.get(name, "").strip().lower()
    return default if not raw else raw in ("1", "true", "yes", "on")


FULL = _env_flag("REPRO_BENCH_FULL")


def spec_of(name: str, shape, n_classes) -> ModelSpec:
    vm = get_vision_model(name)
    return ModelSpec(name, lambda g: vm.init(g, shape, n_classes), vm.apply)


def task_seed_of(dataset: str) -> int:
    """Process-independent task seed for a named dataset: crc32 of the
    name (``hash()`` on strings is salted per interpreter)."""
    return zlib.crc32(dataset.encode()) % 997


def federation_data(dataset: str, n_clients: int, seed: int, *,
                    n_train_factor: float = 1.0, p_major=None,
                    device="cuda"):
    """Per-client train sets and the shared 1,000-example test set on
    ``device``, and the dataset's entry of :data:`DATASETS`.

    With a major-class share (``p_major``, else the dataset's), each client
    gets ``per_client · n_train_factor`` examples by ``partition_major``
    from a pool twice the cohort's size. The Dirichlet datasets (kvasir,
    camelyon) assign every example of a pool of ``per_client · K`` by
    ``partition_dirichlet``: a RAGGED cohort, each client keeping its own
    size (every client at least one example, :func:`_ensure_nonempty`).
    The partition and the donor draw use ``np.random.default_rng(seed)``,
    as in the reference."""
    d = DATASETS[dataset]
    dev = resolve_device(device)
    per_client = int(d["per_client"] * n_train_factor)
    pm = p_major if p_major is not None else d.get("p_major")
    n_total = per_client * n_clients * (2 if pm is not None else 1)
    task_seed = task_seed_of(dataset)

    def draw(stream: int, n: int):
        gen = torch.Generator(device=dev).manual_seed(stream_seed(seed,
                                                                  stream))
        return make_classification_data(gen, n, d["shape"], d["n_classes"],
                                        sep=d["sep"], task_seed=task_seed)

    x, y = draw(0, n_total)
    xt, yt = draw(1, 1000)
    rng = np.random.default_rng(seed)
    if pm is not None:
        idxs = partition_major(rng, y.cpu().numpy(), n_clients, per_client,
                               pm, d["n_classes"])
    else:
        idxs = _ensure_nonempty(rng, partition_dirichlet(
            rng, y.cpu().numpy(), n_clients, d.get("dirichlet", 0.5)))
    data = []
    for i in idxs:
        i = torch.as_tensor(i, device=dev)
        data.append((x[i], y[i]))
    return data, (xt, yt), d


def _ensure_nonempty(rng: np.random.Generator, idxs):
    """A Dirichlet draw can leave a client with no example, which no step
    can sample from: move one index over from the largest client, again
    until none is empty (one donor pass could itself empty a client)."""
    idxs = [np.asarray(i) for i in idxs]
    if sum(len(i) for i in idxs) < len(idxs):
        raise ValueError("fewer samples than clients — cannot give every "
                         "client at least one example")
    while True:
        empty = [k for k, i in enumerate(idxs) if len(i) == 0]
        if not empty:
            return idxs
        donor = int(np.argmax([len(j) for j in idxs]))
        take = rng.integers(len(idxs[donor]))
        idxs[empty[0]] = idxs[donor][take:take + 1]
        idxs[donor] = np.delete(idxs[donor], take)


def method_setup(dataset: str, n_clients: int, seed: int, *, rounds: int,
                 batch_size: int = 250, dp: bool = True, p_major=None,
                 private_arch: str = "mlp", proxy_arch: str = "mlp",
                 alpha: float = 0.5, sigma: float = 1.0, clip: float = 1.0,
                 n_train_factor: float = 1.0, dropout_rate: float = 0.0,
                 compress: str = "none", use_pallas: bool = True,
                 device="cuda", **cfg_knobs):
    """One seed's run of :func:`bench_methods`: ``(client data, test set,
    private spec, proxy spec, config)``, the batch cut to the mean client
    size. ``cfg_knobs`` are other :class:`ProxyFLConfig` fields
    (``staleness``, ``n_shards``, ``compress_ratio``, ``local_steps``,
    ...); None keeps a field's default."""
    client_data, test, d = federation_data(
        dataset, n_clients, seed, n_train_factor=n_train_factor,
        p_major=p_major, device=device)
    priv = spec_of(private_arch, d["shape"], d["n_classes"])
    prox = spec_of(proxy_arch, d["shape"], d["n_classes"])
    # clamp to the MEAN client size: sampling is with replacement, so a
    # batch above a small client's size is fine, while the smallest
    # client's size would shrink every client's batch
    mean_n = int(np.mean([dk[0].shape[0] for dk in client_data]))
    cfg = ProxyFLConfig(
        alpha=alpha, beta=alpha, n_clients=n_clients, rounds=rounds,
        batch_size=max(1, min(batch_size, mean_n)), seed=seed,
        dropout_rate=dropout_rate, use_pallas=use_pallas, compress=compress,
        dp=DPConfig(enabled=dp, noise_multiplier=sigma, clip_norm=clip),
        **{k: v for k, v in cfg_knobs.items() if v is not None})
    return client_data, test, priv, prox, cfg


def bench_methods(dataset: str, methods: Sequence[str], *, n_clients: int,
                  rounds: int, seeds: Sequence[int], device="cuda",
                  backend: Optional[str] = None, staleness: int = 0,
                  n_shards: int = 0, checkpoint_dir: Optional[str] = None,
                  checkpoint_every: int = 0, resume: Optional[bool] = None,
                  use_pallas: Optional[bool] = None,
                  compress: Optional[str] = None,
                  compress_ratio: Optional[float] = None,
                  verify_commitments: Optional[bool] = None,
                  local_steps: Optional[int] = None,
                  lr: Optional[float] = None,
                  weight_decay: Optional[float] = None,
                  topology: Optional[str] = None,
                  min_active: Optional[int] = None,
                  **knobs) -> List[Dict]:
    """One row per method (and a ``-proxy`` row for ProxyFL and FML) with
    the reference's keys: the final test accuracy's mean and spread over
    every client of every seed, the worst epsilon over clients and seeds
    (ragged cohorts give each client its own), and the method's wall-clock
    seconds. ``knobs`` are :func:`method_setup`'s, the reference's, at its
    defaults: the batch (cut to the mean client size), ``dp`` with noise
    multiplier ``sigma`` and clip norm ``clip``, the major-class share
    ``p_major`` (None: the dataset's), ``private_arch`` and
    ``proxy_arch``, the DML weight ``alpha`` (= β), §3.4's per-round
    ``dropout_rate`` and ``n_train_factor``. The DP steps and the
    uncompressed mixes run the port's kernels on a CUDA device (their plain
    versions on the CPU).

    The engine knobs, each read from the reference's environment variable
    when unset: ``backend`` (``REPRO_BENCH_BACKEND``, default ``"auto"``);
    ``staleness`` (``REPRO_BENCH_STALENESS``), the delay τ of the async
    backend and of the hier backend's cross-shard edges, refused by the
    other backends; ``n_shards`` (``REPRO_BENCH_SHARDS``), the hier
    backend's shard count, refused by the others above 1; ``use_pallas``
    (``REPRO_BENCH_PALLAS``, default on); ``compress`` and
    ``compress_ratio`` (``REPRO_BENCH_COMPRESS``,
    ``REPRO_BENCH_COMPRESS_RATIO``), the compressed exchange;
    ``verify_commitments`` (``REPRO_BENCH_VERIFY``). ``local_steps``,
    ``lr``, ``weight_decay``, ``topology`` and ``min_active`` go into the
    config as given (None: its default).

    ``checkpoint_dir`` makes every (method, seed) run snapshot its complete
    federation every ``checkpoint_every`` rounds (0: every round) under
    ``<dir>/<dataset>/<method>_s<seed>``; with ``resume`` a preempted
    benchmark restarts mid-run and finishes bit-identically to an
    uninterrupted one. Unset, each reads its environment variable:
    ``REPRO_BENCH_CKPT_DIR``, ``REPRO_BENCH_CKPT_EVERY``,
    ``REPRO_BENCH_RESUME`` (``1``, ``true``, ``yes`` or ``on``)."""
    backend = backend or os.environ.get("REPRO_BENCH_BACKEND", "auto")
    staleness = staleness or _env_int("REPRO_BENCH_STALENESS")
    n_shards = n_shards or _env_int("REPRO_BENCH_SHARDS")
    if staleness and backend not in ("async", "hier"):
        # a silently ignored τ would report synchronous results as stale
        raise SystemExit(
            f"staleness={staleness} requires backend='async' or 'hier' "
            f"(got {backend!r}; the synchronous backends deliver every "
            "round) — set REPRO_BENCH_BACKEND=async")
    if n_shards > 1 and backend != "hier":
        raise SystemExit(
            f"n_shards={n_shards} requires backend='hier' "
            f"(got {backend!r}; the flat backends have no shard level) "
            "— set REPRO_BENCH_BACKEND=hier")
    checkpoint_dir = checkpoint_dir or os.environ.get("REPRO_BENCH_CKPT_DIR")
    checkpoint_every = checkpoint_every or _env_int("REPRO_BENCH_CKPT_EVERY")
    if resume is None:
        resume = _env_flag("REPRO_BENCH_RESUME")
    if use_pallas is None:
        use_pallas = _env_flag("REPRO_BENCH_PALLAS", default=True)
    if verify_commitments is None:
        verify_commitments = _env_flag("REPRO_BENCH_VERIFY")
    compress = (compress or os.environ.get("REPRO_BENCH_COMPRESS", "").strip()
                or "none")
    if compress_ratio is None:
        raw = os.environ.get("REPRO_BENCH_COMPRESS_RATIO", "").strip()
        if raw:
            try:
                compress_ratio = float(raw)
            except ValueError:
                raise SystemExit("REPRO_BENCH_COMPRESS_RATIO must be a "
                                 f"float, got {raw!r}")
    knobs.update(
        staleness=staleness, n_shards=n_shards or 1,
        use_pallas=bool(use_pallas), compress=compress,
        compress_ratio=compress_ratio,
        verify_commitments=bool(verify_commitments), local_steps=local_steps,
        lr=lr, weight_decay=weight_decay, topology=topology,
        min_active=min_active)
    rows = []
    for method in methods:
        accs, proxy_accs, eps_out = [], [], None
        t0 = time.perf_counter()
        for seed in seeds:
            client_data, test, priv, prox, cfg = method_setup(
                dataset, n_clients, seed, rounds=rounds, device=device,
                **knobs)
            res = run_federated(
                method, [priv] * n_clients, prox, client_data, test, cfg,
                seed=seed, eval_every=rounds, device=device, backend=backend,
                checkpoint_dir=(os.path.join(checkpoint_dir, dataset)
                                if checkpoint_dir else None),
                checkpoint_every=checkpoint_every, resume=resume)
            row = res["history"][-1]
            accs.extend(row["private_acc" if "private_acc" in row else "acc"])
            proxy_accs.extend(row.get("proxy_acc", []))
            eps = [e for e in res["epsilon"] if e is not None]
            if eps:
                eps_out = max(eps) if eps_out is None else max(eps_out,
                                                               max(eps))
        common = dict(epsilon=eps_out, rounds=rounds, clients=n_clients,
                      dp=cfg.dp.enabled)
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


def iter_methods(dataset: str, methods: Sequence[str], **kw
                 ) -> Iterator[Dict]:
    """:func:`bench_methods` one method at a time, so that a driver prints
    each method's rows as it finishes."""
    for method in methods:
        yield from bench_methods(dataset, (method,), **kw)


def time_rounds(engine, data, seed: int, rounds: int, *, trials: int = 3,
                fresh: bool = False) -> float:
    """Steady-state seconds a round: one warm-up pass, then ``trials``
    passes of rounds 0 .. rounds-1 one at a time (``engine.run_rounds``),
    each from the state the last left, or from ``init_states(seed)`` with
    ``fresh`` (set-up untimed); the best pass, the reference's throughput
    measure. Synchronises the card before each clock read."""
    state = engine.init_states(seed)
    state, _ = engine.run_rounds(state, data, 0, rounds, seed)
    sync(engine.device)
    times = []
    for _ in range(trials):
        if fresh:
            state = engine.init_states(seed)
        t0 = time.perf_counter()
        state, _ = engine.run_rounds(state, data, 0, rounds, seed)
        sync(engine.device)
        times.append((time.perf_counter() - t0) / rounds)
    return float(np.min(times))


def write_rows(rows: List[Dict], env: str, default: str) -> None:
    """The rows as JSON in the file ``env`` names, else ``default`` in the
    working directory (the reference drivers' convention)."""
    with open(os.environ.get(env, default), "w") as f:
        json.dump(rows, f, indent=1)


def cut(default, override):
    """A driver's configured value, or the caller's cut of it."""
    return default if override is None else override


def driver_main(doc: str, iter_rows: Callable[..., Iterable[Dict]],
                argv=None) -> None:
    """The command line of a figure driver: ``[--full] [--device D]
    [--rounds N] [--train-factor F]``, one JSON row per line as each
    finishes. ``--rounds`` and ``--train-factor`` cut every run of the
    configuration (a tiny size on the CPU)."""
    ap = argparse.ArgumentParser(description=doc.split("\n\n")[0])
    ap.add_argument("--full", action="store_true",
                    help="the paper's configuration")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--rounds", type=int, help="rounds of every run")
    ap.add_argument("--train-factor", type=float,
                    help="share of each client's examples")
    args = ap.parse_args(argv)
    for row in iter_rows(args.full, args.device, rounds=args.rounds,
                         n_train_factor=args.train_factor):
        print(json.dumps(row), flush=True)
