"""Losses: cross-entropy and the DML KL term (paper Eqs. 2-5), accuracy
and macro-accuracy, ported from ``src/repro/nn/losses.py``."""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def _masked_mean(x: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    if mask is None:
        return torch.mean(x)
    mask = torch.broadcast_to(mask, x.shape).to(torch.float32)
    return torch.sum(x * mask) / torch.clamp(torch.sum(mask), min=1.0)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean CE. logits [..., V]; labels [...] int; mask broadcastable to
    labels (1 = count)."""
    lf = logits.to(torch.float32)
    m = torch.amax(lf, dim=-1, keepdim=True).detach()
    lse = torch.log(torch.sum(torch.exp(lf - m), dim=-1)) + m[..., 0]
    picked = torch.gather(lf, -1, labels[..., None].long())[..., 0]
    return _masked_mean(lse - picked, mask)


def kl_divergence(p_logits: torch.Tensor, q_logits: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean KL[p || q] over positions (paper Eq. 3), p = the first argument
    (the model being trained). Spelled out as the reference does:
    ``F.kl_div(input, target)`` takes the log-probabilities of the OTHER
    distribution first, an easy way to get the direction wrong.
    Differentiable in both; callers detach the frozen side."""
    lp = F.log_softmax(p_logits.to(torch.float32), dim=-1)
    lq = F.log_softmax(q_logits.to(torch.float32), dim=-1)
    kl = torch.sum(torch.exp(lp) * (lp - lq), dim=-1)
    return _masked_mean(kl, mask)


def dml_loss(own_logits, peer_logits, labels, alpha: float,
             mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(1-alpha)·CE(own, y) + alpha·KL(own ‖ peer), the peer detached —
    Eq. 4/5."""
    peer = peer_logits.detach()
    return ((1.0 - alpha) * cross_entropy(own_logits, labels, mask)
            + alpha * kl_divergence(own_logits, peer, mask))


def accuracy(logits, labels, mask: Optional[torch.Tensor] = None
             ) -> torch.Tensor:
    ok = (torch.argmax(logits, dim=-1) == labels).to(torch.float32)
    return _masked_mean(ok, mask)


def macro_accuracy(logits, labels, n_classes: int) -> torch.Tensor:
    """Per-class accuracy averaged over classes (the paper's
    macro-accuracy, fig. 9). A class absent from ``labels`` counts as 0,
    as in the reference."""
    pred = torch.argmax(logits, dim=-1).reshape(-1)
    labels = labels.reshape(-1)
    accs = []
    for c in range(n_classes):
        m = (labels == c).to(torch.float32)
        accs.append(torch.sum((pred == c) * m)
                    / torch.clamp(torch.sum(m), min=1.0))
    return torch.mean(torch.stack(accs))
