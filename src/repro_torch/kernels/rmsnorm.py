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

:func:`rmsnorm_clients` is the ``"clients"`` route: K clients' ``[rows,
d]`` matrices, each with its own gain ``[K, d]``, in one launch of the same
kernel on a grid whose y is the client (vector or scalar instantiation as
above, the gains' client stride included), each client's rows bit-equal to
a flat launch on them. :func:`rmsnorm` is a ``torch.library`` custom op
whose ``torch.func.vmap`` rule batches it the way ``jax.vmap`` batches the
reference's ``pallas_call``: with one gain for the batch the batch dim is
folded into the rows (one flat launch); with a gain per client (a cohort's
own models, the stacked executor of ``repro_torch.core.engine``) it runs
the ``"clients"`` route. A call outside every ``torch.func`` transform
and dispatch mode (serving, evaluation) runs the op's body directly,
without the dispatcher.
"""
from __future__ import annotations

import torch

from . import _build
from .ref import rmsnorm_clients_ref, rmsnorm_ref


def rmsnorm_route(x: torch.Tensor, g: torch.Tensor, out: torch.Tensor,
                  g_stride: int = 0) -> str:
    """The instantiation a CUDA call takes: ``"vector"`` when x, g and out
    start on 16-byte boundaries, a row of x is a multiple of 16 bytes and
    so is ``g_stride`` (elements between two clients' gains), else
    ``"scalar"``."""
    aligned = all(t.data_ptr() % 16 == 0 for t in (x, g, out))
    row_bytes = x.shape[-1] * x.element_size()
    vector = aligned and row_bytes % 16 == 0 \
        and g_stride * g.element_size() % 16 == 0
    return "vector" if vector else "scalar"


def _check(name: str, x: torch.Tensor, g: torch.Tensor) -> None:
    if x.dim() < 1 or x.numel() == 0 or g.dim() != 1 \
            or g.shape[0] != x.shape[-1]:
        raise ValueError(f"{name}: need a non-empty x [..., d] and g [d], "
                         f"got {tuple(x.shape)} and {tuple(g.shape)}")
    if x.dtype not in _build.DTYPE_CODES or g.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"{name}: dtypes {x.dtype}, {g.dtype} not supported "
                        "(float32 or bfloat16)")


def rmsnorm(x: torch.Tensor, g: torch.Tensor, *, eps: float = 1e-6,
            block_rows: int = 256) -> torch.Tensor:
    """x [..., d] f32/bf16, g [d] f32/bf16; returns x's dtype and shape.
    ``block_rows`` is the reference's tiling, accepted for its signature
    (the CUDA kernel gives a row one warp, or a few at large d)."""
    _check("rmsnorm", x, g)
    if block_rows < 1:
        raise ValueError(f"rmsnorm: block_rows must be >= 1, got {block_rows}")
    _build.refuse_grad("rmsnorm", x, g)
    if _build.through_op():
        return _rmsnorm_op(x, g, float(eps))
    return _rmsnorm(x, g, float(eps))


def _rmsnorm(x: torch.Tensor, g: torch.Tensor, eps: float) -> torch.Tensor:
    """The op's body, on inputs :func:`rmsnorm` has checked."""
    if _build.plain(x):
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


def rmsnorm_clients(x: torch.Tensor, g: torch.Tensor, *,
                    eps: float = 1e-6) -> torch.Tensor:
    """K clients' :func:`rmsnorm` in one launch: x [K, rows, d] f32/bf16
    (contiguous), g [K, d] f32/bf16 with unit-stride rows; returns [K,
    rows, d] in x's dtype, client k bit-equal to ``rmsnorm(x[k], g[k])``
    on the instantiation both take."""
    if x.dim() != 3 or x.numel() == 0 or g.dim() != 2 \
            or g.shape != (x.shape[0], x.shape[2]) or g.stride(1) != 1:
        raise ValueError("rmsnorm_clients: need a non-empty x [K, rows, d] "
                         "and g [K, d] with unit-stride rows, got "
                         f"{tuple(x.shape)} and {tuple(g.shape)}")
    if x.dtype not in _build.DTYPE_CODES or g.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"rmsnorm_clients: dtypes {x.dtype}, {g.dtype} not "
                        "supported (float32 or bfloat16)")
    _build.refuse_grad("rmsnorm_clients", x, g)
    if _build.plain(x):
        return rmsnorm_clients_ref(x, g, eps)
    _build.check_cuda("rmsnorm_clients", x)
    _build.check_cuda("rmsnorm_clients", g, contiguous=False)
    K, rows, d = x.shape
    if K > 65_535:
        raise ValueError(f"rmsnorm_clients: at most 65,535 clients, got {K}")
    out = torch.empty_like(x)
    route = rmsnorm_route(x, g, out, g.stride(0))
    _build.launch("repro_rmsnorm_clients", x.data_ptr(),
                  _build.DTYPE_CODES[x.dtype], g.data_ptr(),
                  _build.DTYPE_CODES[g.dtype], out.data_ptr(), K, rows, d,
                  rows * d, g.stride(0), float(eps), int(route == "vector"))
    rmsnorm.launches += 1
    rmsnorm.route_launches["clients"] += 1
    return out


rmsnorm.launches = 0
rmsnorm.route_launches = {"vector": 0, "scalar": 0, "clients": 0}

_rmsnorm_op = _build.custom_op(
    "repro_torch::rmsnorm", _rmsnorm,
    schema="(Tensor x, Tensor g, float eps) -> Tensor")


@_rmsnorm_op.register_fake
def _rmsnorm_fake(x, g, eps):
    _check("rmsnorm", x, g)
    return torch.empty_like(x)


@_rmsnorm_op.register_vmap
def _rmsnorm_vmap(info, in_dims, x, g, eps):
    n = info.batch_size
    x = x.movedim(in_dims[0], 0) if in_dims[0] is not None \
        else x.expand((n,) + tuple(x.shape))
    if in_dims[1] is None:
        # one gain for the batch: the batch's rows are one flat call's
        return _rmsnorm(x.contiguous(), g, eps), 0
    # a gain per client: the client grid (the gains' rows may lie at any
    # stride, as a layer's gains indexed out of a stacked [R, d] leaf do)
    shape = x.shape
    x = x.reshape(n, -1, shape[-1]).contiguous()
    g = g.movedim(in_dims[1], 0)
    if g.stride(1) != 1:
        g = g.contiguous()
    return rmsnorm_clients(x, g, eps=eps).reshape(shape), 0
