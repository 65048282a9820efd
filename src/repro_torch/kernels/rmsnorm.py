"""Fused RMSNorm over the last axis.

:func:`rmsnorm` computes ``x·rsqrt(mean(x²)+eps)·g`` in f32 and casts to
x's dtype at the end (the gain is applied before the cast, as the
reference kernel does). On a CUDA tensor it launches the kernel of
``csrc/rmsnorm.cu`` (replacing ``src/repro/kernels/rmsnorm.py``'s
``rmsnorm``) in one of two instantiations that :func:`rmsnorm_route` picks:
``"vector"`` (16-byte loads and stores) when x, g and the output are
16-byte aligned and a row is a whole number of 16 bytes, else ``"scalar"``
(one element an access). On a CPU tensor it runs the plain version in
:mod:`.ref`.
"""
from __future__ import annotations

import torch

from . import _build
from .ref import rmsnorm_ref


def rmsnorm_route(x: torch.Tensor, g: torch.Tensor,
                  out: torch.Tensor) -> str:
    """The instantiation a CUDA call takes: ``"vector"`` when x, g and out
    start on 16-byte boundaries and a row of x is a multiple of 16 bytes,
    else ``"scalar"``."""
    aligned = all(t.data_ptr() % 16 == 0 for t in (x, g, out))
    row_bytes = x.shape[-1] * x.element_size()
    return "vector" if aligned and row_bytes % 16 == 0 else "scalar"


def rmsnorm(x: torch.Tensor, g: torch.Tensor, *, eps: float = 1e-6,
            block_rows: int = 256) -> torch.Tensor:
    """x [..., d] f32/bf16, g [d] f32/bf16; returns x's dtype and shape.
    ``block_rows`` is the reference's tiling, accepted for its signature
    (the CUDA kernel gives a row one warp, or a few at large d)."""
    if x.dim() < 1 or x.numel() == 0 or g.dim() != 1 \
            or g.shape[0] != x.shape[-1]:
        raise ValueError("rmsnorm: need a non-empty x [..., d] and g [d], "
                         f"got {tuple(x.shape)} and {tuple(g.shape)}")
    if x.dtype not in _build.DTYPE_CODES or g.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"rmsnorm: dtypes {x.dtype}, {g.dtype} not supported "
                        "(float32 or bfloat16)")
    if block_rows < 1:
        raise ValueError(f"rmsnorm: block_rows must be >= 1, got {block_rows}")
    _build.refuse_grad("rmsnorm", x, g)
    if x.device.type == "cpu":
        return rmsnorm_ref(x, g, eps)
    _build.check_cuda("rmsnorm", x, g)
    d = x.shape[-1]
    out = torch.empty_like(x)
    route = rmsnorm_route(x, g, out)
    _build.launch("repro_rmsnorm", x.data_ptr(), _build.DTYPE_CODES[x.dtype],
                  g.data_ptr(), _build.DTYPE_CODES[g.dtype], out.data_ptr(),
                  x.numel() // d, d, float(eps), int(route == "vector"))
    rmsnorm.launches += 1
    rmsnorm.route_launches[route] += 1
    return out


rmsnorm.launches = 0
rmsnorm.route_launches = {"vector": 0, "scalar": 0}
