"""Empirical privacy validation: membership-inference attacks (port of
``src/repro/core/attacks.py``).

The loss-threshold MIA (Yeom et al. 2018): the adversary observes a model
(a RELEASED PROXY, say) and predicts that low-loss examples were training
members; reported as the AUC over member and non-member scores, 0.5 for no
leakage, 1.0 for full leakage. :func:`bitflip_proxy` is the byzantine wire
adversary the engine's ``transmit_tamper`` hook takes.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch


@torch.no_grad()
def per_example_losses(apply_fn: Callable, params, x: torch.Tensor,
                       y: torch.Tensor, batch: int = 256) -> np.ndarray:
    """CE loss of each example under the model (the MIA score): an f32
    log-softmax of the forward's logits, ``batch`` examples a call."""
    out = []
    for i in range(0, x.shape[0], batch):
        logits = apply_fn(params, x[i:i + batch])
        logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
        picked = logp.gather(-1, y[i:i + batch].to(torch.int64)[..., None])
        out.append((-picked[..., 0]).cpu().numpy())
    return np.concatenate(out)


def auc_from_scores(member_scores: np.ndarray,
                    nonmember_scores: np.ndarray) -> float:
    """Rank-based AUC of the attacker that predicts 'member' for LOWER
    scores (losses). 0.5 = chance; 1.0 = perfect membership inference."""
    m, n = np.asarray(member_scores), np.asarray(nonmember_scores)
    if len(m) == 0 or len(n) == 0:
        raise ValueError(
            f"auc_from_scores needs non-empty score arrays on both sides "
            f"(got {len(m)} member, {len(n)} non-member scores) — an AUC "
            "over an empty class is undefined, not 0.5; check the "
            "member/non-member split upstream")
    # Mann-Whitney U via tie-averaged ranks
    all_scores = np.concatenate([m, n])
    _, inv, counts = np.unique(all_scores, return_inverse=True,
                               return_counts=True)
    cum = np.cumsum(counts)
    ranks = (cum - (counts - 1) / 2.0)[inv]
    u = ranks[: len(m)].sum() - len(m) * (len(m) + 1) / 2.0
    auc_high = u / (len(m) * len(n))  # P(member loss > nonmember loss)
    return float(1.0 - auc_high)      # members should have LOWER loss


def bitflip_proxy(client: int, *, bit: int = 0, index: int = 0,
                  rounds: Optional[Tuple[int, ...]] = None) -> Callable:
    """Byzantine tamper model for the engine's ``transmit_tamper`` hook:
    flip bit ``bit`` of float32 element ``index`` of client ``client``'s
    TRANSMITTED proxy vector, the smallest in-flight corruption, which
    commitment verification must still catch (``cfg.verify_commitments``).
    ``rounds`` restricts the attack to those round indices (None = every
    round). Returns ``tamper(flat [K, D] numpy, t) -> flat``."""
    def tamper(flat: np.ndarray, t: int) -> np.ndarray:
        if rounds is not None and t not in rounds:
            return flat
        out = np.array(flat, dtype=np.float32, copy=True)
        row = out[client].view(np.uint32)
        row[index] ^= np.uint32(1 << bit)
        return out
    return tamper


def loss_threshold_mia(apply_fn: Callable, params,
                       member_data: Tuple[torch.Tensor, torch.Tensor],
                       nonmember_data: Tuple[torch.Tensor, torch.Tensor],
                       ) -> float:
    """AUC of the loss-threshold membership-inference attack."""
    ml = per_example_losses(apply_fn, params, *member_data)
    nl = per_example_losses(apply_fn, params, *nonmember_data)
    return auc_from_scores(ml, nl)
