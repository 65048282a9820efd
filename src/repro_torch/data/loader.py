"""Batching for DP-SGD (port of ``src/repro/data/loader.py``).

The RDP accountant for the SAMPLED Gaussian mechanism formally assumes
POISSON subsampling: each example enters the batch independently with
probability q = B/N (paper §4.1, citing Yu et al. 2019).

* :func:`sample_batch` — fixed-size uniform sampling with replacement, the
  standard practical surrogate (Abadi et al. 2016 §5).
* :func:`poisson_batch` — exact Poisson subsampling, padded or truncated
  to a fixed ``max_batch`` with a weight mask: selected examples weigh 1,
  padding 0, and the DP-SGD mean divides by the EXPECTED batch size qN
  (:func:`repro_torch.core.dp.dp_gradient_poisson`).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch


def sample_batch(generator: torch.Generator, x: torch.Tensor, y: torch.Tensor,
                 batch: int) -> Tuple[torch.Tensor, torch.Tensor]:
    idx = torch.randint(0, x.shape[0], (batch,), generator=generator,
                        device=x.device)
    return x[idx], y[idx]


def poisson_batch(generator: Optional[torch.Generator], x: torch.Tensor,
                  y: torch.Tensor, q: float, max_batch: int, *,
                  selected=None
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Poisson-subsampled batch, padded to ``max_batch``.

    Returns (xb, yb, mask) where mask[i] in {0., 1.} (f32) marks real
    examples. Each of the N examples is selected with probability ``q``
    (a Bernoulli draw from ``generator``; ``selected``, a bool[N], replaces
    the draw, as tests feed in the reference's). The selected examples
    come first in a stable order (index order), then the unselected ones;
    the first ``max_batch`` are taken. Selected examples beyond
    ``max_batch`` are dropped (negligible when max_batch ≳ qN +
    4·sqrt(qN(1-q))); unselected slots carry mask 0, so their clipped
    gradients add nothing.
    """
    n = x.shape[0]
    if selected is None:
        sel = torch.rand((n,), generator=generator, device=x.device) < q
    elif isinstance(selected, torch.Tensor):
        sel = selected.to(device=x.device, dtype=torch.bool)
    else:
        sel = torch.as_tensor(np.array(selected, dtype=bool),
                              device=x.device)
    # stable order: selected indices first (False < True under ~sel)
    order = torch.argsort((~sel).to(torch.uint8), stable=True)
    take = order[:max_batch]
    return x[take], y[take], sel[take].to(torch.float32)


def expected_batch(q: float, n: int) -> float:
    return q * n


def steps_per_epoch(n: int, batch: int) -> int:
    return max(1, -(-n // batch))
