"""Causal / sliding-window attention with an online softmax (flash
attention, forward).

:func:`flash_attention` takes q, k, v [B, H, S, D] (f32 or bf16, one dtype,
D ≤ 256) and returns softmax(scale·qkᵀ | mask)·v in q's dtype, with the
mask ``key ≤ query`` when causal and ``query − key < window`` when a window
is given (one-sided when not causal); a row with no key left is 0. On a
CUDA tensor it launches one of three kernels replacing
``src/repro/kernels/flash_attention.py``'s ``flash_attention``, chosen by
:func:`flash_route` from the dtype and head dim alone. At every head dim
whose rows are whole 16 bytes (bf16 D % 8 == 0, f32 D % 4 == 0) both
dtypes run on the tensor cores: bf16 on wgmma fed by TMA
(``csrc/flash_attention_sm90.cu``, route ``"wgmma"``), f32 on mma.sync in
split TF32 (``csrc/flash_attention_tf32x3.cu``, route ``"tf32x3"``: each
operand split into a TF32 high part and its residual, three products per
product, f32-grade). The wgmma kernel is compiled at D ∈ {64, 128, 256},
the split-TF32 one also at 96 (phi-3-vision's head dim); a call at
another aligned D runs the width :func:`padded_head_dim` gives, its
columns past D read as zeros and never stored. The unaligned head dims run
on the CUDA cores (``csrc/flash_attention.cu``, route ``"cuda_cores"``).
The dispatch is fixed: a call the route's kernel refuses raises. On a CPU
tensor the plain version in :mod:`.ref` runs. :func:`launch_flash` is the
launch both this and ``ops.gqa_flash_attention`` use: the kernels read q,
k, v through (batch, head, position) strides, so the model layout
[B, S, H, D] and grouped KV heads need no copy.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import _build
from .ref import flash_attention_ref

MAX_HEAD_DIM = 256
# the widths each tensor-core kernel is compiled at
COMPILED_HEAD_DIMS = {"wgmma": (64, 128, 256), "tf32x3": (64, 96, 128, 256)}
ROUTES = ("wgmma", "tf32x3", "cuda_cores")
TENSOR_CORE_ROUTE = {torch.bfloat16: "wgmma", torch.float32: "tf32x3"}
ROUTE_ENTRY = {"wgmma": "repro_flash_attention_sm90",
               "tf32x3": "repro_flash_attention_tf32x3"}


def _check_head_dim(head_dim: int) -> None:
    if not 1 <= head_dim <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {head_dim} outside 1..{MAX_HEAD_DIM}")


def padded_head_dim(head_dim: int, route: str = "wgmma") -> int:
    """The width the tensor-core ``route`` runs a call at head dim D on: the
    smallest of its :data:`COMPILED_HEAD_DIMS` that is ≥ D."""
    _check_head_dim(head_dim)
    return next(w for w in COMPILED_HEAD_DIMS[route] if w >= head_dim)


def flash_route(dtype: torch.dtype, head_dim: int) -> str:
    """The kernel a CUDA call takes: where a row of D elements is whole 16
    bytes, ``"wgmma"`` (``csrc/flash_attention_sm90.cu``) for bf16 and
    ``"tf32x3"`` (``csrc/flash_attention_tf32x3.cu``) for f32, each at
    :func:`padded_head_dim`; at any other head dim ``"cuda_cores"``
    (``csrc/flash_attention.cu``). A head dim above 256 raises."""
    _check_head_dim(head_dim)
    route = TENSOR_CORE_ROUTE.get(dtype)
    if route is not None and head_dim * dtype.itemsize % 16 == 0:
        return route
    return "cuda_cores"


def check_tma(name: str, *tensors: torch.Tensor) -> None:
    """What the tensor-core routes need (the wgmma route's tensor maps, the
    tf32x3 route's 16-byte copies): 16-byte aligned bases and strides (in
    bytes) that are positive multiples of 16."""
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: the tensor-core kernels need "
                             "16-byte aligned tensors, got one at "
                             f"{t.data_ptr():#x}")
        strides = [st * t.element_size() for st in t.stride()[:-1]]
        if any(st <= 0 or st % 16 for st in strides):
            raise ValueError(f"{name}: the tensor-core kernels need "
                             "strides that are multiples of 16 bytes, got "
                             f"{strides}")


def check_attention(name: str, q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor, head_axis: int) -> int:
    """Validate 4-D q, k, v of one dtype, position axis ``3 − head_axis``,
    k and v of one shape whose head count divides q's; return the group
    size (query heads per KV head)."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"{name}: need 4-D q, k, v with k and v of one "
                         f"shape, got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"{name}: q, k, v must share one dtype, float32 or "
                        f"bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    pos_axis = 3 - head_axis
    hq, hkv = q.shape[head_axis], k.shape[head_axis]
    if q.numel() == 0 or k.shape[0] != q.shape[0] \
            or k.shape[pos_axis] != q.shape[pos_axis] \
            or k.shape[3] != q.shape[3] or hq % hkv:
        raise ValueError(f"{name}: k/v {tuple(k.shape)} do not fit q "
                         f"{tuple(q.shape)} (same batch, length and head "
                         "dim; KV heads dividing query heads)")
    if q.shape[3] > MAX_HEAD_DIM:
        raise ValueError(f"{name}: head dim {q.shape[3]} > {MAX_HEAD_DIM}")
    return hq // hkv


def launch_flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                 head_axis: int, group: int, causal: bool,
                 window: Optional[int], scale: float) -> torch.Tensor:
    """Launch the kernel :func:`flash_route` picks on contiguous CUDA q
    [.., Hq, .., D] and k, v [.., Hkv, .., D] with the heads on
    ``head_axis`` (1 or 2) and the positions on the other; the output has
    q's layout."""
    _build.check_cuda("flash_attention", q, k, v)
    pos_axis = 3 - head_axis
    B, H, S, D = q.shape[0], q.shape[head_axis], q.shape[pos_axis], q.shape[3]
    out = torch.empty_like(q)
    # a window of S or more masks nothing more, one of −S or less masks all
    win = 0 if window is None else max(-S, min(int(window), S))
    shape = (B, H, group, S, D, q.stride(0), q.stride(head_axis),
             q.stride(pos_axis), k.stride(0), k.stride(head_axis),
             k.stride(pos_axis), float(scale), int(bool(causal)), win,
             int(window is not None))
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
    route = flash_route(q.dtype, D)
    if route in ROUTE_ENTRY:
        check_tma("flash_attention", q, k, v, out)
        _build.launch(ROUTE_ENTRY[route], *ptrs, *shape)
    else:
        _build.launch("repro_flash_attention", *ptrs,
                      _build.DTYPE_CODES[q.dtype], *shape)
    flash_attention.launches += 1
    flash_attention.route_launches[route] += 1
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    scale: Optional[float] = None, block_q: int = 128,
                    block_k: int = 128) -> torch.Tensor:
    """q, k, v [B, H, S, D] (KV heads already broadcast). ``block_q`` and
    ``block_k`` are the reference's tiling, accepted for its signature (the
    CUDA kernel tiles on its own); ``scale`` defaults to D**-0.5."""
    check_attention("flash_attention", q, k, v, head_axis=1)
    if k.shape != q.shape:
        raise ValueError("flash_attention: k, v must match q's shape "
                         f"{tuple(q.shape)}, got {tuple(k.shape)}")
    if block_q < 1 or block_k < 1:
        raise ValueError("flash_attention: block sizes must be >= 1")
    scale = float(scale if scale is not None else q.shape[3] ** -0.5)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   scale=scale)
    return launch_flash(q, k, v, head_axis=1, group=1, causal=causal,
                        window=window, scale=scale)


flash_attention.launches = 0
flash_attention.route_launches = dict.fromkeys(ROUTES, 0)
