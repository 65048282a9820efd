"""Batching for DP-SGD (port of ``sample_batch`` in
``src/repro/data/loader.py``): fixed-size uniform sampling with
replacement, the standard practical surrogate for Poisson subsampling
(Abadi et al. 2016 §5)."""
from __future__ import annotations

from typing import Tuple

import torch


def sample_batch(generator: torch.Generator, x: torch.Tensor, y: torch.Tensor,
                 batch: int) -> Tuple[torch.Tensor, torch.Tensor]:
    idx = torch.randint(0, x.shape[0], (batch,), generator=generator,
                        device=x.device)
    return x[idx], y[idx]
