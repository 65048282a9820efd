"""ProxyFL protocol configuration: a copy of ``DPConfig`` and
``ProxyFLConfig`` from ``src/repro/configs/base.py`` with the same field
names and defaults, so one set of knobs describes a run in both packages.

In this port ``use_pallas=True`` runs the hand-written kernels of
:mod:`repro_torch.kernels` on a CUDA device and their plain versions on a
CPU device the caller chose. Fields whose feature is not ported yet are
kept for parity and refused by the engine when set (see ``ROADMAP.md``).
"""
from __future__ import annotations

from dataclasses import dataclass, field


@dataclass(frozen=True)
class DPConfig:
    enabled: bool = True
    clip_norm: float = 1.0  # C
    noise_multiplier: float = 1.0  # sigma
    delta: float = 1e-5
    sample_rate: float = 0.0  # q; 0 -> batch/dataset size at runtime
    vectorized: bool = False  # vmap-over-the-batch mode (not ported yet)


@dataclass(frozen=True)
class ProxyFLConfig:
    alpha: float = 0.5  # private-model DML weight (Eq. 4)
    beta: float = 0.5  # proxy-model DML weight (Eq. 5)
    n_clients: int = 8
    rounds: int = 10
    local_steps: int = 0  # 0 -> one epoch over local data
    lr: float = 1e-3
    weight_decay: float = 1e-4
    batch_size: int = 250
    dp: DPConfig = field(default_factory=DPConfig)
    topology: str = "exponential"  # exponential | ring | full
    seed: int = 0
    dropout_rate: float = 0.0  # §3.4 dropout
    min_active: int = 1
    backend: str = "auto"  # "auto" | "loop" | "vmap" | "async" in this port
    staleness: int = 0  # async gossip delay τ (backend="async")
    n_shards: int = 1  # hier layout (not ported yet)
    use_pallas: bool = False  # hand-written kernels on CUDA
    compress: str = "none"  # compressed exchange (not ported yet)
    compress_ratio: float = 0.25
    verify_commitments: bool = False  # commitments (not ported yet)
