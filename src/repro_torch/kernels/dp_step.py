"""Fused DP noise-add + clipped mean + optimizer steps (tail of the Eq. 7
chain).

:func:`noise_sgd_step` applies ``p − lr·((acc + σ·noise)/n + wd·p)`` over
flat vectors in one pass, returning p' in p's dtype (f32 or bf16).
:func:`noise_adam_step` applies ``g = (acc + σ·noise)/n + wd·p`` and Adam's
moment updates and bias-corrected step in one pass over flat f32 vectors,
returning ``(p', m', v')``. On a CUDA tensor each launches its kernel of
``csrc/dp_step.cu`` (replacing ``src/repro/kernels/dp_step.py``'s
``noise_sgd_step`` and ``noise_adam_step``); on a CPU tensor it runs the
plain version in :mod:`.ref`. Each CUDA call is one launch: the Python
scalars go by value, rounded once to f32 (the TPU kernels read them as f32
from SMEM), and a thread takes the :func:`step_columns` neighbouring
elements its vectors' alignment allows. The caller draws the noise and, for
Adam, owns the gate to f32 params and moments
(``repro_torch.core.dp.dp_adam_update``).
"""
from __future__ import annotations

from typing import Tuple

import torch

from . import _build
from .ref import noise_adam_step_ref, noise_sgd_step_ref


def noise_sgd_step(acc: torch.Tensor, noise: torch.Tensor, p: torch.Tensor,
                   *, stddev: float, n_units: int, lr: float,
                   weight_decay: float = 0.0) -> torch.Tensor:
    """``p − lr·((acc + stddev·noise)/n_units + weight_decay·p)``: acc and
    noise f32 [D], p [D] f32 or bf16; returns p's dtype."""
    if any(x.dim() != 1 or x.shape != acc.shape for x in (acc, noise, p)) \
            or acc.numel() == 0:
        raise ValueError("noise_sgd_step: acc, noise, p must be non-empty "
                         "1-D vectors of one length")
    if acc.dtype != torch.float32 or noise.dtype != torch.float32:
        raise TypeError("noise_sgd_step: acc and noise must be f32")
    if p.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"noise_sgd_step: p dtype {p.dtype} not supported "
                        "(float32 or bfloat16)")
    _build.refuse_grad("noise_sgd_step", acc, noise, p)
    if acc.device.type == "cpu":
        return noise_sgd_step_ref(acc, noise, p, stddev=stddev,
                                  n_units=n_units, lr=lr,
                                  weight_decay=weight_decay)
    _build.check_cuda("noise_sgd_step", acc, noise, p)
    out = torch.empty_like(p)
    # one launch: the Python scalars go by value, rounded once to f32
    _build.launch("repro_noise_sgd_step", acc.data_ptr(), noise.data_ptr(),
                  p.data_ptr(), _build.DTYPE_CODES[p.dtype], out.data_ptr(),
                  acc.numel(), stddev, n_units, lr, weight_decay,
                  step_columns(acc, noise, p, out))
    noise_sgd_step.launches += 1
    return out


def noise_adam_step(acc: torch.Tensor, noise: torch.Tensor, p: torch.Tensor,
                    m: torch.Tensor, v: torch.Tensor, *, stddev: float,
                    n_units: int, lr: float, weight_decay: float = 0.0,
                    b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                    c1: torch.Tensor, c2: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``c1``/``c2`` are the bias corrections ``1 − b1**t`` / ``1 − b2**t``
    of the post-update step count t, as 0-d f32 tensors on the device (they
    come from the device-side step counter; the host never reads them)."""
    vecs = (acc, noise, p, m, v)
    if any(x.dim() != 1 or x.shape != acc.shape or x.dtype != torch.float32
           for x in vecs) or acc.numel() == 0:
        raise ValueError("noise_adam_step: acc, noise, p, m, v must be "
                         "non-empty 1-D f32 vectors of one length")
    if any(c.numel() != 1 or c.dtype != torch.float32 for c in (c1, c2)):
        raise TypeError("noise_adam_step: c1/c2 must be one-element f32 "
                        "tensors")
    _build.refuse_grad("noise_adam_step", *vecs, c1, c2)
    if acc.device.type == "cpu":
        return noise_adam_step_ref(
            acc, noise, p, m, v, stddev=stddev, n_units=n_units, lr=lr,
            weight_decay=weight_decay, b1=b1, b2=b2, eps=eps,
            c1=c1.reshape(()), c2=c2.reshape(()))
    _build.check_cuda("noise_adam_step", *vecs, c1, c2)
    p2, m2, v2 = (torch.empty_like(acc) for _ in range(3))
    outs = (p2, m2, v2)
    # one launch: the Python scalars go by value (rounded once to f32, as
    # the plain version rounds them), c1 and c2 stay on the device
    _build.launch("repro_noise_adam_step", c1.data_ptr(), c2.data_ptr(),
                  *(t.data_ptr() for t in vecs + outs), acc.numel(), stddev,
                  n_units, lr, weight_decay, b1, b2, 1.0 - b1, 1.0 - b2, eps,
                  step_columns(*vecs, *outs))
    noise_adam_step.launches += 1
    return p2, m2, v2


def step_columns(*vecs: torch.Tensor) -> int:
    """Elements a thread of either step kernel takes: 4 when every vector's
    base is aligned to four of its elements (16 bytes of f32, 8 of bf16), 2
    when to two, else 1."""
    for cols in (4, 2):
        if all(t.data_ptr() % (cols * t.element_size()) == 0 for t in vecs):
            return cols
    return 1


noise_sgd_step.launches = 0
noise_adam_step.launches = 0
