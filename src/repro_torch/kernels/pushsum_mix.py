"""Fused PushSum exchange over the stacked [K, D] proxies (Algorithm 1
lines 7-11).

:func:`fused_pushsum_mix` returns ``(P·z / (P·w)[:, None], P·w)`` with
``debias=True`` or ``(P·z, P·w)`` without. On a CUDA tensor the [K, D]
product runs in the kernel of ``csrc/pushsum_mix.cu`` (replacing
``src/repro/kernels/pushsum_mix.py``'s ``fused_pushsum_mix``); the O(K)
weight product ``w' = P·w`` stays a torch product, as the reference forms
it outside its kernel. On a CPU tensor the plain version in :mod:`.ref`
runs.
"""
from __future__ import annotations

from typing import Tuple

import torch

from . import _build
from .ref import fused_pushsum_mix_ref


def fused_pushsum_mix(flat: torch.Tensor, w: torch.Tensor, P, *,
                      debias: bool = True
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """flat [K, D] f32/bf16, w [K], P [K, K] (array or tensor, any float
    dtype; used in f32). Accumulates in f32 and returns flat's dtype."""
    if flat.dim() != 2 or flat.shape[0] < 1 or flat.shape[1] < 1:
        raise ValueError("fused_pushsum_mix: flat must be a non-empty "
                         f"[K, D] matrix, got {tuple(flat.shape)}")
    if flat.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"fused_pushsum_mix: flat dtype {flat.dtype} not "
                        "supported (float32 or bfloat16)")
    K, D = flat.shape
    if tuple(w.shape) != (K,) or tuple(P.shape) != (K, K):
        raise ValueError(f"fused_pushsum_mix: need w [{K}] and P [{K}, {K}], "
                         f"got {tuple(w.shape)} and {tuple(P.shape)}")
    if flat.device.type == "cpu":
        return fused_pushsum_mix_ref(flat, w, P, debias=debias)
    Pf = torch.as_tensor(P, dtype=torch.float32,
                         device=flat.device).contiguous()
    w2 = Pf @ w.to(torch.float32)
    _build.check_cuda("fused_pushsum_mix", flat, Pf, w2)
    out = torch.empty_like(flat)
    _build.launch("repro_pushsum_mix", flat.data_ptr(),
                  _build.DTYPE_CODES[flat.dtype], Pf.data_ptr(),
                  w2.data_ptr(), out.data_ptr(), K, D, int(debias))
    fused_pushsum_mix.launches += 1
    return out, w2.to(w.dtype)


fused_pushsum_mix.launches = 0
