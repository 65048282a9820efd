"""DP-SGD clip-and-accumulate kernels (paper Eq. 7 inner loop).

* :func:`sumsq` — f32 sum of squares of a 1-D vector (the per-example norm);
* :func:`scale_accumulate` — ``acc + g·scale`` with a device scalar scale;
* :func:`clip_accumulate` — ``acc + g / max(1, ‖g‖/C)``, the two composed
  (it launches nothing of its own);
* :func:`sumsq_rows` / :func:`clip_accumulate_rows` — the ``"rows"`` route
  of the same two kernels over a ``[B, D]`` matrix of per-example
  gradients: every row's sum of squares in one call, and Σᵢ gᵢ·scaleᵢ in
  row order in one call, each bit-equal to the per-row chain of the 1-D
  (``"vector"``) route.

On a CUDA tensor each wrapper launches its kernel from ``csrc/dp_clip.cu``
(replacing ``src/repro/kernels/dp_clip.py``'s Pallas kernels); on a CPU
tensor it runs the plain version in :mod:`.ref`. ``launches`` counts the
kernel launches only, ``route_launches`` splits them by route.
"""
from __future__ import annotations

import torch

from . import _build
from .ref import (clip_accumulate_rows_ref, scale_accumulate_ref,
                  sumsq_ref, sumsq_rows_ref)

_PARTIAL_ELEMS = 1024   # elements per partial-sum block of the first pass
_MAX_PARTIALS = 1024    # the second pass sums at most this many partials
_MAX_ROWS = 65_535      # sumsq_rows: one grid row a matrix row


def _n_partials(n: int) -> int:
    """First-pass blocks of a length-n vector or row: fixed by n alone."""
    return min(-(-n // _PARTIAL_ELEMS), _MAX_PARTIALS)


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
    _build.refuse_grad("sumsq", x)
    if x.device.type == "cpu":
        return sumsq_ref(x)
    _build.check_cuda("sumsq", x)
    n = x.numel()
    n_partials = _n_partials(n)
    partials = torch.empty(n_partials, dtype=torch.float32, device=x.device)
    out = torch.empty((), dtype=torch.float32, device=x.device)
    _build.launch("repro_sumsq", x.data_ptr(), _build.DTYPE_CODES[x.dtype],
                  n, partials.data_ptr(), n_partials, out.data_ptr())
    sumsq.launches += 1
    sumsq.route_launches["vector"] += 1
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
    _build.refuse_grad("scale_accumulate", acc, g, scale)
    if acc.device.type == "cpu":
        return scale_accumulate_ref(acc, g, scale.reshape(()))
    _build.check_cuda("scale_accumulate", acc, g, scale)
    out = torch.empty_like(acc)
    _build.launch("repro_scale_accumulate", acc.data_ptr(), g.data_ptr(),
                  _build.DTYPE_CODES[g.dtype], scale.data_ptr(),
                  out.data_ptr(), acc.numel())
    scale_accumulate.launches += 1
    scale_accumulate.route_launches["vector"] += 1
    return out


def _check_rows(name: str, x: torch.Tensor, what: str) -> None:
    """A non-empty 2-D f32/bf16 matrix whose rows are unit-stride and do
    not overlap (``stride(0) >= D``), as a padded buffer's ``[:, :D]``
    view is."""
    if x.dim() != 2 or x.numel() == 0:
        raise ValueError(f"{name}: {what} must be a non-empty 2-D [B, D] "
                         f"matrix, got shape {tuple(x.shape)}")
    if x.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"{name}: {what} dtype {x.dtype} not supported "
                        "(float32 or bfloat16)")
    if x.stride(1) != 1 or x.stride(0) < x.shape[1]:
        raise ValueError(f"{name}: {what} needs unit-stride rows with row "
                         f"stride >= D, got strides {x.stride()} for shape "
                         f"{tuple(x.shape)}")


def sumsq_rows(x: torch.Tensor) -> torch.Tensor:
    """Each row's sum of squares of a [B, D] f32/bf16 matrix, accumulated
    in f32: [B]. Row i is bit-equal to ``sumsq(x[i])``."""
    _check_rows("sumsq_rows", x, "x")
    _build.refuse_grad("sumsq_rows", x)
    if x.device.type == "cpu":
        return sumsq_rows_ref(x)
    _build.check_cuda("sumsq_rows", x, contiguous=False)
    B, n = x.shape
    if B > _MAX_ROWS:
        raise ValueError(f"sumsq_rows: at most {_MAX_ROWS} rows, got {B}")
    n_partials = _n_partials(n)
    partials = torch.empty((B, n_partials), dtype=torch.float32,
                           device=x.device)
    out = torch.empty((B,), dtype=torch.float32, device=x.device)
    _build.launch("repro_sumsq_rows", x.data_ptr(),
                  _build.DTYPE_CODES[x.dtype], B, n, x.stride(0),
                  partials.data_ptr(), n_partials, out.data_ptr())
    sumsq.launches += 1
    sumsq.route_launches["rows"] += 1
    return out


def clip_accumulate_rows(g: torch.Tensor,
                         scales: torch.Tensor) -> torch.Tensor:
    """Σᵢ g[i]·scales[i] over the rows of a [B, D] f32/bf16 matrix in row
    order, from 0: [D] f32, bit-equal to B chained ``scale_accumulate``
    calls. ``scales`` is [B] f32 on g's device. Any row stride >= D is
    taken; one of whole 128 bytes reads each row in whole cache lines."""
    _check_rows("clip_accumulate_rows", g, "g")
    if not isinstance(scales, torch.Tensor):
        raise TypeError("clip_accumulate_rows: scales must be a tensor, got "
                        f"{type(scales).__name__}")
    if scales.dtype != torch.float32 or scales.shape != (g.shape[0],) \
            or scales.device != g.device:
        raise ValueError(f"clip_accumulate_rows: scales must be [{g.shape[0]}]"
                         f" f32 on {g.device}, got {scales.dtype} "
                         f"{tuple(scales.shape)} on {scales.device}")
    _build.refuse_grad("clip_accumulate_rows", g, scales)
    if g.device.type == "cpu":
        return clip_accumulate_rows_ref(g, scales)
    _build.check_cuda("clip_accumulate_rows", g, scales,
                      contiguous=False)
    scales = scales.contiguous()
    out = torch.empty((g.shape[1],), dtype=torch.float32, device=g.device)
    _build.launch("repro_clip_accumulate_rows", g.data_ptr(),
                  _build.DTYPE_CODES[g.dtype], g.shape[0], g.shape[1],
                  g.stride(0), scales.data_ptr(), out.data_ptr())
    scale_accumulate.launches += 1
    scale_accumulate.route_launches["rows"] += 1
    return out


sumsq.launches = 0
scale_accumulate.launches = 0
sumsq.route_launches = {"vector": 0, "rows": 0}
scale_accumulate.route_launches = {"vector": 0, "rows": 0}


def clip_accumulate(acc: torch.Tensor, g: torch.Tensor,
                    clip_norm: float) -> torch.Tensor:
    """One per-example DP-SGD update of the accumulator, as the reference's
    composite computes it: ``scale = 1/max(1, sqrt(sumsq(g))/C)``, then
    ``scale_accumulate(acc, g, scale)``. The scale stays on the device."""
    norm = torch.sqrt(sumsq(g))
    scale = 1.0 / torch.clamp(norm / clip_norm, min=1.0)
    return scale_accumulate(acc, g, scale)
