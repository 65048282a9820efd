"""DP-SGD clip-and-accumulate kernels (paper Eq. 7 inner loop).

* :func:`sumsq` — f32 sum of squares of a 1-D vector (the per-example norm);
* :func:`scale_accumulate` — ``acc + g·scale`` with a device scalar scale;
* :func:`clip_accumulate` — ``acc + g / max(1, ‖g‖/C)``, the two composed
  (it launches nothing of its own).

On a CUDA tensor each wrapper launches its kernel from ``csrc/dp_clip.cu``
(replacing ``src/repro/kernels/dp_clip.py``'s Pallas kernels); on a CPU
tensor it runs the plain version in :mod:`.ref`. ``launches`` counts the
kernel launches only.
"""
from __future__ import annotations

import torch

from . import _build
from .ref import scale_accumulate_ref, sumsq_ref

_PARTIAL_ELEMS = 1024   # elements per partial-sum block of the first pass
_MAX_PARTIALS = 1024    # the second pass sums at most this many partials


def _check_vector(name: str, x: torch.Tensor, what: str) -> None:
    if x.dim() != 1 or x.numel() == 0:
        raise ValueError(f"{name}: {what} must be a non-empty 1-D vector, "
                         f"got shape {tuple(x.shape)}")
    if x.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"{name}: {what} dtype {x.dtype} not supported "
                        "(float32 or bfloat16)")


def sumsq(x: torch.Tensor) -> torch.Tensor:
    """Sum of squares of a 1-D f32/bf16 vector, accumulated in f32 (0-d)."""
    _check_vector("sumsq", x, "x")
    if x.device.type == "cpu":
        return sumsq_ref(x)
    _build.check_cuda("sumsq", x)
    n = x.numel()
    n_partials = min(-(-n // _PARTIAL_ELEMS), _MAX_PARTIALS)
    partials = torch.empty(n_partials, dtype=torch.float32, device=x.device)
    out = torch.empty((), dtype=torch.float32, device=x.device)
    _build.launch("repro_sumsq", x.data_ptr(), _build.DTYPE_CODES[x.dtype],
                  n, partials.data_ptr(), n_partials, out.data_ptr())
    sumsq.launches += 1
    return out


def scale_accumulate(acc: torch.Tensor, g: torch.Tensor,
                     scale: torch.Tensor) -> torch.Tensor:
    """``acc + g·scale``: acc f32 [D], g f32/bf16 [D], scale an f32 scalar
    tensor on acc's device (read by the kernel, never by the host)."""
    _check_vector("scale_accumulate", acc, "acc")
    _check_vector("scale_accumulate", g, "g")
    if acc.dtype != torch.float32 or acc.shape != g.shape:
        raise ValueError("scale_accumulate: acc must be f32 and match g's "
                         f"shape, got {acc.dtype} {tuple(acc.shape)} and "
                         f"{tuple(g.shape)}")
    if not isinstance(scale, torch.Tensor) or scale.numel() != 1 \
            or scale.dtype != torch.float32:
        raise TypeError("scale_accumulate: scale must be a one-element f32 "
                        "tensor")
    if acc.device.type == "cpu":
        return scale_accumulate_ref(acc, g, scale.reshape(()))
    _build.check_cuda("scale_accumulate", acc, g, scale)
    out = torch.empty_like(acc)
    _build.launch("repro_scale_accumulate", acc.data_ptr(), g.data_ptr(),
                  _build.DTYPE_CODES[g.dtype], scale.data_ptr(),
                  out.data_ptr(), acc.numel())
    scale_accumulate.launches += 1
    return out


sumsq.launches = 0
scale_accumulate.launches = 0


def clip_accumulate(acc: torch.Tensor, g: torch.Tensor,
                    clip_norm: float) -> torch.Tensor:
    """One per-example DP-SGD update of the accumulator, as the reference's
    composite computes it: ``scale = 1/max(1, sqrt(sumsq(g))/C)``, then
    ``scale_accumulate(acc, g, scale)``. The scale stays on the device."""
    norm = torch.sqrt(sumsq(g))
    scale = 1.0 / torch.clamp(norm / clip_norm, min=1.0)
    return scale_accumulate(acc, g, scale)
