"""Plain PyTorch versions of the hand-written kernels.

Each follows its counterpart in ``src/repro/kernels/ref.py`` line for line.
The CPU path of every wrapper runs them, the tests compare with them, and
``chip_smoke.py`` holds each CUDA kernel against them on the card. Python
scalars enter each operation as f32, as JAX's weakly typed scalars do.
"""
from __future__ import annotations

import torch


def sumsq_ref(x: torch.Tensor) -> torch.Tensor:
    return torch.sum(torch.square(x.to(torch.float32)))


def scale_accumulate_ref(acc: torch.Tensor, g: torch.Tensor,
                         scale) -> torch.Tensor:
    return acc + g.to(torch.float32) * scale


def fused_pushsum_mix_ref(flat: torch.Tensor, w: torch.Tensor, P, *,
                          debias: bool = True):
    """Synchronous PushSum exchange, f32 accumulation: (P·z [/ P·w], P·w)."""
    Pf = torch.as_tensor(P, dtype=torch.float32, device=flat.device)
    mixed = Pf @ flat.to(torch.float32)
    w2 = Pf @ w.to(torch.float32)
    if debias:
        mixed = mixed / w2[:, None]
    return mixed.to(flat.dtype), w2.to(w.dtype)


def fused_stale_mix_ref(flat, w, kept, sent, buf_t0, buf_w0):
    """Stale (async τ>0) exchange: re-bias θ = z·w, split kept/sent, merge
    the delayed delivery, de-bias — returns (z', send_t, w', send_w)."""
    keptf = torch.as_tensor(kept, dtype=torch.float32, device=flat.device)
    sentf = torch.as_tensor(sent, dtype=torch.float32, device=flat.device)
    wf = w.to(torch.float32)
    theta = flat.to(torch.float32) * wf[:, None]
    send_t = sentf @ theta
    send_w = sentf @ wf
    mixed = keptf[:, None] * theta + buf_t0.to(torch.float32)
    w2 = keptf * wf + buf_w0.to(torch.float32)
    z2 = mixed / w2[:, None]
    return (z2.to(flat.dtype), send_t.to(flat.dtype), w2.to(w.dtype),
            send_w.to(w.dtype))


def noise_adam_step_ref(acc, noise, p, m, v, *, stddev, n_units, lr,
                        weight_decay=0.0, b1=0.9, b2=0.999, eps=1e-8,
                        c1=None, c2=None):
    g = (acc.to(torch.float32) + stddev * noise.to(torch.float32)) / n_units
    pf = p.to(torch.float32)
    g = g + weight_decay * pf
    m2 = b1 * m.to(torch.float32) + (1.0 - b1) * g
    v2 = b2 * v.to(torch.float32) + (1.0 - b2) * g * g
    step = lr * (m2 / c1) / (torch.sqrt(v2 / c2) + eps)
    return (pf - step).to(p.dtype), m2.to(m.dtype), v2.to(v.dtype)
