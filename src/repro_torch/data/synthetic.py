"""Synthetic class-conditional images (port of ``make_classification_data``
in ``src/repro/data/synthetic.py``).

Same formula as the reference, drawn with torch generators, so the values
differ from the JAX package's for the same seeds. Parity tests feed the
reference's arrays to the port instead.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch


def make_classification_data(
    generator: torch.Generator,
    n: int,
    image_shape: Tuple[int, int, int],
    n_classes: int,
    *,
    sep: float = 1.0,
    noise: float = 1.0,
    task_seed: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Class-conditional Gaussian images ``x = sep·mu_y + noise·eps``, drawn
    on ``generator``'s device.

    The class means come from a generator seeded with ``task_seed`` (NOT
    from ``generator``), so train/test splits drawn with different sampling
    generators share the same task."""
    device = generator.device
    task = torch.Generator(device=device).manual_seed(task_seed)
    d = math.prod(image_shape)
    # smooth-ish class means: low-dim random basis mixed per class
    basis = torch.randn((16, d), generator=task, device=device) / math.sqrt(d)
    coef = torch.randn((n_classes, 16), generator=task, device=device)
    mu = coef @ basis  # [C, d]
    y = torch.randint(0, n_classes, (n,), generator=generator, device=device)
    eps = torch.randn((n, d), generator=generator, device=device)
    x = sep * mu[y] + noise * eps / math.sqrt(d) * 4.0
    return x.reshape((n,) + tuple(image_shape)), y
