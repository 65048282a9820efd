"""Causal / sliding-window attention with an online softmax (flash
attention, forward).

:func:`flash_attention` takes q, k, v [B, H, S, D] (f32 or bf16, one dtype,
D ≤ 256) and returns softmax(scale·qkᵀ | mask)·v in q's dtype, with the
mask ``key ≤ query`` when causal and ``query − key < window`` when a window
is given (one-sided when not causal); a row with no key left is 0. On a
CUDA tensor it launches a kernel replacing
``src/repro/kernels/flash_attention.py``'s ``flash_attention``, on the
tensor cores at every head dim: :func:`flash_route` picks it by dtype, bf16
on wgmma (``csrc/flash_attention_sm90.cu``, route ``"wgmma"``) and f32 on
mma.sync in split TF32 (``csrc/flash_attention_tf32x3.cu``, route
``"tf32x3"``: each operand split into a TF32 high part and its residual,
three products per product, f32-grade). The wgmma kernel is compiled at
D ∈ {64, 128, 256}, the split-TF32 one also at 96 (phi-3-vision's head
dim); a call at another D runs the width :func:`padded_head_dim` gives, its
columns past D read as zeros and never stored. :func:`flash_copy_width`
picks how a kernel fills its shared memory: where D·itemsize, every base
and every stride are multiples of 16 bytes, 16 bytes a copy (TMA for
wgmma, cp.async for split TF32; :func:`check_tma` is that predicate);
anywhere else the narrow loader of the same kernel, 8-, 4- or (bf16 rows of
an odd D) 2-byte copies into the same shared layout, counted under
``"wgmma/narrow"`` and ``"tf32x3/narrow"``. A call the chosen kernel
refuses raises. On a CPU tensor the plain version in :mod:`.ref` runs.
:func:`launch_flash` is the launch both this and ``ops.gqa_flash_attention``
use: the kernels read q, k, v through (batch, head, position) strides, so
the model layout [B, S, H, D] and grouped KV heads need no copy.

Both public calls go through one ``torch.library`` custom op whose
``torch.func.vmap`` rule folds the vmapped dim into the batch dim (``[K·B,
…]``) and launches the same kernel once, as ``jax.vmap`` adds a grid axis
to the reference's ``pallas_call``: no (batch, head) tile reads another's,
so each client's rows are bit-equal to a launch on that client's alone. A
cohort vmapped by the stacked executor of ``repro_torch.core.engine`` thus
takes one launch, counted under the route ``"clients"`` (and not under
the kernel's route), so the routes' counts sum to ``launches``. A call
outside every ``torch.func`` transform and dispatch mode (serving,
evaluation) runs the op's body directly, without the dispatcher.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import _build
from .ref import flash_attention_ref, gqa_flash_attention_ref

MAX_HEAD_DIM = 256
# the widths each tensor-core kernel is compiled at
COMPILED_HEAD_DIMS = {"wgmma": (64, 128, 256), "tf32x3": (64, 96, 128, 256)}
ROUTES = ("wgmma", "wgmma/narrow", "tf32x3", "tf32x3/narrow")
TENSOR_CORE_ROUTE = {torch.bfloat16: "wgmma", torch.float32: "tf32x3"}
ROUTE_ENTRY = {"wgmma": "repro_flash_attention_sm90",
               "wgmma/narrow": "repro_flash_attention_sm90_narrow",
               "tf32x3": "repro_flash_attention_tf32x3",
               "tf32x3/narrow": "repro_flash_attention_tf32x3_narrow"}
# bytes a copy of the loaders, widest first: 16 is the aligned loader
COPY_WIDTHS = (16, 8, 4, 2)


def _check_head_dim(head_dim: int) -> None:
    if not 1 <= head_dim <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {head_dim} outside 1..{MAX_HEAD_DIM}")


def padded_head_dim(head_dim: int, route: str = "wgmma") -> int:
    """The width the tensor-core ``route`` runs a call at head dim D on: the
    smallest of its :data:`COMPILED_HEAD_DIMS` that is ≥ D."""
    _check_head_dim(head_dim)
    return next(w for w in COMPILED_HEAD_DIMS[route] if w >= head_dim)


def flash_route(dtype: torch.dtype, head_dim: int) -> str:
    """The kernel a CUDA call takes at every head dim 1..256: ``"wgmma"``
    (``csrc/flash_attention_sm90.cu``) for bf16 and ``"tf32x3"``
    (``csrc/flash_attention_tf32x3.cu``) for f32, each at
    :func:`padded_head_dim`. A head dim above 256 raises."""
    _check_head_dim(head_dim)
    if dtype not in TENSOR_CORE_ROUTE:
        raise TypeError(f"flash attention takes float32 or bfloat16, got "
                        f"{dtype}")
    return TENSOR_CORE_ROUTE[dtype]


def flash_copy_width(head_dim: int, itemsize: int, addresses, strides
                     ) -> int:
    """Bytes a copy of the loader that fills the kernel's shared memory:
    the widest of 16, 8, 4 and 2 (not below ``itemsize``) that D·itemsize,
    every base address and every stride (in elements, times ``itemsize``)
    are multiples of. 16 is the aligned loader (TMA, or 16-byte cp.async);
    8, 4 and 2 the narrow one. A stride ≤ 0 raises."""
    if any(st <= 0 for st in strides):
        raise ValueError(f"flash_attention: strides must be positive, got "
                         f"{list(strides)}")
    for width in COPY_WIDTHS:
        if width >= itemsize and head_dim * itemsize % width == 0 and all(
                a % width == 0 for a in addresses) and all(
                st * itemsize % width == 0 for st in strides):
            return width
    raise ValueError(f"flash_attention: tensors not aligned to their "
                     f"{itemsize}-byte elements")


def check_tma(name: str, *tensors: torch.Tensor) -> None:
    """What the 16-byte loaders need (the wgmma kernel's tensor maps, the
    split-TF32 kernel's 16-byte copies): 16-byte aligned bases and strides
    (in bytes) that are positive multiples of 16. Where a tensor fails it,
    :func:`flash_copy_width` sends the call to the narrow loader."""
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
                 window: Optional[int], scale: float,
                 count_as: Optional[str] = None) -> torch.Tensor:
    """Launch the kernel :func:`flash_route` picks, with the loader
    :func:`flash_copy_width` picks, on contiguous CUDA q [.., Hq, .., D] and
    k, v [.., Hkv, .., D] with the heads on ``head_axis`` (1 or 2) and the
    positions on the other; the output has q's layout. The launch counts
    under its kernel's route, or under ``count_as``."""
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
    tensors = (q, k, v, out)
    width = flash_copy_width(D, q.element_size(),
                             [t.data_ptr() for t in tensors],
                             [st for t in tensors for st in t.stride()[:-1]])
    if width == 16:
        check_tma("flash_attention", *tensors)
        _build.launch(ROUTE_ENTRY[route], *ptrs, *shape)
    else:
        route += "/narrow"
        _build.launch(ROUTE_ENTRY[route], *ptrs, *shape, width)
    flash_attention.launches += 1
    flash_attention.route_launches[count_as or route] += 1
    return out


def _attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               head_axis: int, causal: bool, window: Optional[int],
               scale: float, count_as: Optional[str] = None
               ) -> torch.Tensor:
    """The op's body: the plain version on the CPU or meta (the [B, H, S,
    D] one, or the model layout's with the KV heads repeated), else the
    kernel."""
    if _build.plain(q):
        ref = flash_attention_ref if head_axis == 1 \
            else gqa_flash_attention_ref
        return ref(q, k, v, causal=causal, window=window, scale=scale)
    return launch_flash(q, k, v, head_axis=head_axis,
                        group=q.shape[head_axis] // k.shape[head_axis],
                        causal=causal, window=window, scale=scale,
                        count_as=count_as)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              head_axis: int, causal: bool, window: Optional[int],
              scale: float) -> torch.Tensor:
    """Attention on validated q, k, v (heads on ``head_axis``): the
    custom op under a ``torch.func`` transform or a dispatch mode, else
    its body."""
    window = None if window is None else int(window)
    if _build.through_op():
        return _attention_op(q, k, v, head_axis, bool(causal), window,
                             float(scale))
    return _attention(q, k, v, head_axis, bool(causal), window,
                      float(scale))


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
    _build.refuse_grad("flash_attention", q, k, v)
    return attention(q, k, v, head_axis=1, causal=causal, window=window,
                     scale=scale)


flash_attention.launches = 0
# the kernel routes, and "clients": the launches folded over a vmapped
# cohort
flash_attention.route_launches = dict.fromkeys(ROUTES + ("clients",), 0)

_attention_op = _build.custom_op(
    "repro_torch::flash_attention", _attention,
    schema="(Tensor q, Tensor k, Tensor v, int head_axis, bool causal, "
           "int? window, float scale) -> Tensor")


@_attention_op.register_fake
def _attention_fake(q, k, v, head_axis, causal, window, scale):
    return torch.empty_like(q)


@_attention_op.register_vmap
def _attention_vmap(info, in_dims, q, k, v, head_axis, causal, window,
                    scale):
    n = info.batch_size
    q, k, v = ((t.movedim(d, 0) if d is not None
                else t.expand((n,) + tuple(t.shape))) for t, d in
               zip((q, k, v), in_dims))
    # the vmapped dim folded into the batch: one launch, each row's tiles
    # as they were (a view where the stack is contiguous)
    folded = [t.reshape((-1,) + tuple(t.shape[2:])).contiguous()
              for t in (q, k, v)]
    out = _attention(*folded, head_axis, causal, window, scale,
                     count_as="clients")
    return out.reshape(q.shape), 0
