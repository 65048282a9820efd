"""Synthetic datasets (port of ``src/repro/data/synthetic.py``):
class-conditional images, and token streams from per-domain random bigram
chains for the LLM ProxyFL path (clients draw from different domains, so
the cohort is non-IID; a held-out stream mixing the domains plays the
joint test set).

Same formulas as the reference, drawn with torch generators, so the values
differ from the JAX package's for the same seeds. Parity tests feed the
reference's arrays to the port instead.
"""
from __future__ import annotations

import functools
import math
from typing import Tuple

import numpy as np
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


@functools.lru_cache(maxsize=8)
def _chain_cdf(vocab: int, domain: int, order_sharpness: float) -> np.ndarray:
    """Each row's cumulative next-token probabilities of ``domain``'s
    chain (f64 [vocab, vocab]); a client's stream and the test stream of
    one domain share it."""
    chain = torch.Generator().manual_seed(7_000_000 + domain)
    logits = order_sharpness * torch.randn((vocab, vocab), generator=chain)
    return np.cumsum(torch.softmax(logits.to(torch.float64), dim=-1).numpy(),
                     axis=-1)


def make_lm_data(seed: int, n_tokens: int, vocab: int, *, domain: int = 0,
                 order_sharpness: float = 4.0) -> torch.Tensor:
    """``n_tokens`` int32 tokens from the random bigram chain of
    ``domain``, on the CPU: the token after t is drawn from
    softmax(order_sharpness · L[t]), L ~ N(0, 1) [vocab, vocab].

    The chain comes from a generator seeded with ``7_000_000 + domain``
    (NOT from ``seed``), so every client of a domain, and the test stream,
    share it; the stream (the first token and one U[0, 1) draw a token)
    from ``(seed, domain)``. The draws come in bulk and each token is
    picked by inverse CDF from its row's cumulative probabilities (f64),
    so the Python loop over tokens does one binary search a token."""
    from ..core.engine import stream_seed
    cdf = _chain_cdf(vocab, domain, order_sharpness)
    stream = torch.Generator().manual_seed(stream_seed(seed, domain))
    tok = int(torch.randint(0, vocab, (), generator=stream))
    u = torch.rand((n_tokens,), generator=stream,
                   dtype=torch.float64).numpy()
    out = np.empty(n_tokens, np.int32)
    for i in range(n_tokens):
        tok = min(int(np.searchsorted(cdf[tok], u[i], side="right")),
                  vocab - 1)
        out[i] = tok
    return torch.from_numpy(out)
