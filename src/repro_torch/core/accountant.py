"""Rényi-DP accounting for the sampled Gaussian mechanism.

Follows Mironov (2017) / Mironov, Talwar, Zhang (2019): the RDP of one
DP-SGD step with sampling rate q and noise multiplier sigma is, at integer
order alpha,

    eps_RDP(alpha) = 1/(alpha-1) * log( sum_{k=0}^{alpha} C(alpha,k)
                     (1-q)^{alpha-k} q^k exp(k(k-1)/(2 sigma^2)) )

computed in log space for stability. RDP composes additively over steps,
and converts to (eps, delta)-DP with the improved bound of Balle et al.
(2020) (the conversion used by Opacus/TF-Privacy):

    eps = min_alpha eps_RDP(alpha) + log((alpha-1)/alpha)
          - (log delta + log alpha)/(alpha-1)

Restricting to integer alpha only weakens (never invalidates) the bound,
since every order yields a valid guarantee. Pure host-side Python — the
accountant sits outside the jitted training step.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Sequence

DEFAULT_ALPHAS: List[int] = list(range(2, 65)) + [96, 128, 256, 512]


def _log_comb(n: int, k: int) -> float:
    return math.lgamma(n + 1) - math.lgamma(k + 1) - math.lgamma(n - k + 1)


def _log_add(a: float, b: float) -> float:
    if a == -math.inf:
        return b
    if b == -math.inf:
        return a
    hi, lo = (a, b) if a > b else (b, a)
    return hi + math.log1p(math.exp(lo - hi))


def rdp_sampled_gaussian(q: float, sigma: float, alpha: int) -> float:
    """RDP epsilon of ONE sampled-Gaussian step at integer order alpha."""
    if q == 0.0:
        return 0.0
    if sigma == 0.0:
        return math.inf
    if q == 1.0:
        return alpha / (2 * sigma ** 2)
    log_sum = -math.inf
    log_q, log_1q = math.log(q), math.log1p(-q)
    for k in range(alpha + 1):
        term = (
            _log_comb(alpha, k)
            + k * log_q
            + (alpha - k) * log_1q
            + (k * k - k) / (2 * sigma ** 2)
        )
        log_sum = _log_add(log_sum, term)
    return log_sum / (alpha - 1)


def rdp_to_eps(rdp: Sequence[float], alphas: Sequence[int], delta: float) -> float:
    """Best (eps, delta) conversion over orders (Balle et al. 2020)."""
    best = math.inf
    for r, a in zip(rdp, alphas):
        if math.isinf(r):
            continue
        eps = r + math.log((a - 1) / a) - (math.log(delta) + math.log(a)) / (a - 1)
        best = min(best, eps)
    return max(best, 0.0)


@dataclass
class PrivacyAccountant:
    """Per-client accountant (paper §3.3: privacy tracked per client; the
    client drops out when its prespecified budget is reached)."""

    noise_multiplier: float
    sample_rate: float  # q = B / N
    delta: float = 1e-5
    alphas: List[int] = field(default_factory=lambda: list(DEFAULT_ALPHAS))
    steps: int = 0
    _per_step_rdp: List[float] = field(default_factory=list)

    def __post_init__(self):
        self._per_step_rdp = [
            rdp_sampled_gaussian(self.sample_rate, self.noise_multiplier, a)
            for a in self.alphas
        ]

    def step(self, n: int = 1) -> None:
        self.steps += n

    def epsilon(self, delta: float | None = None) -> float:
        delta = self.delta if delta is None else delta
        rdp = [r * self.steps for r in self._per_step_rdp]
        return rdp_to_eps(rdp, self.alphas, delta)

    def exceeds(self, budget: float) -> bool:
        return self.epsilon() > budget


def epsilon_for(
    *, noise_multiplier: float, sample_rate: float, steps: int, delta: float
) -> float:
    acc = PrivacyAccountant(noise_multiplier, sample_rate, delta)
    acc.step(steps)
    return acc.epsilon()
