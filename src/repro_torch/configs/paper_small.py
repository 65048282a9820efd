"""The paper's own experimental configurations (Section 4 / Appendix A).

Image-classification models (MLP / LeNet5 / CNN1 / CNN2 / VGG-small /
ResNet18-GN) live in ``repro_torch.nn.vision``; this module holds their hyper-
parameter descriptions plus the federated-experiment settings used by the
per-figure benchmarks.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

from .base import DPConfig, ProxyFLConfig


@dataclass(frozen=True)
class VisionDataConfig:
    name: str
    image_shape: Tuple[int, int, int]  # H, W, C
    n_classes: int
    train_per_client: int
    p_major: float  # non-IID majority-class fraction (0.1 == IID for 10 classes)
    partition: str = "major"  # "major" | "dirichlet"
    dirichlet_alpha: float = 0.5


# paper §4.1 dataset settings (synthetic stand-ins keep the same structure)
MNIST = VisionDataConfig("mnist", (28, 28, 1), 10, 1000, 0.8)
FAMNIST = VisionDataConfig("famnist", (28, 28, 1), 10, 1000, 0.8)
CIFAR10 = VisionDataConfig("cifar10", (32, 32, 3), 10, 3000, 0.3)
KVASIR = VisionDataConfig("kvasir", (80, 100, 3), 8, 750, 0.0, partition="dirichlet")
CAMELYON = VisionDataConfig("camelyon", (64, 64, 3), 2, 2700, 0.0, partition="dirichlet")

DATASETS = {c.name: c for c in (MNIST, FAMNIST, CIFAR10, KVASIR, CAMELYON)}


def paper_benchmark_protocol(**overrides) -> ProxyFLConfig:
    """§4.1 settings: Adam lr 1e-3, wd 1e-4, B=250, C=1.0, sigma=1.0,
    alpha=beta=0.5, 8 clients."""
    kw = dict(
        alpha=0.5,
        beta=0.5,
        n_clients=8,
        rounds=10,
        lr=1e-3,
        weight_decay=1e-4,
        batch_size=250,
        dp=DPConfig(enabled=True, clip_norm=1.0, noise_multiplier=1.0, delta=1e-5),
    )
    kw.update(overrides)
    return ProxyFLConfig(**kw)


def paper_histo_protocol(**overrides) -> ProxyFLConfig:
    """§4.4 settings: 4 clients, B=32, sigma=1.4, C=0.7, alpha=beta=0.3."""
    kw = dict(
        alpha=0.3,
        beta=0.3,
        n_clients=4,
        rounds=30,
        lr=1e-3,
        weight_decay=1e-4,
        batch_size=32,
        dp=DPConfig(enabled=True, clip_norm=0.7, noise_multiplier=1.4, delta=1e-5),
    )
    kw.update(overrides)
    return ProxyFLConfig(**kw)
