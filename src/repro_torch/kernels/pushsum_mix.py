"""Fused PushSum exchanges over the stacked [K, D] proxies (Algorithm 1
lines 7-11).

:func:`fused_pushsum_mix` returns ``(P·z / (P·w)[:, None], P·w)`` with
``debias=True`` or ``(P·z, P·w)`` without. On a CUDA tensor the [K, D]
product runs in the kernel of ``csrc/pushsum_mix.cu`` (replacing
``src/repro/kernels/pushsum_mix.py``'s ``fused_pushsum_mix``).
:func:`fused_pushsum_mix_blocks` is the hier backend's intra-shard half,
the same kernel on a grid over S shards of [L, L] blocks in one launch
(the reference vmaps ``fused_pushsum_mix`` over the shards).

:func:`fused_stale_mix` is the async (staleness τ>0) exchange: re-bias
θ = z·w, ``send_t = sent@θ``, ``z' = (kept·θ + buf_t0)/w'``, in the kernel
of ``csrc/stale_mix.cu`` (replacing the reference's ``fused_stale_mix``).

In all three, the O(K) weight products (``w' = P·w``; the per-shard
``blocks @ w``; ``w' = kept·w + buf_w0`` and ``send_w = sent@w``) stay
torch products, as the reference forms them
outside its kernels. On a CPU tensor the plain versions in :mod:`.ref` run.
"""
from __future__ import annotations

from typing import Tuple

import torch

from . import _build
from .ref import (fused_pushsum_mix_blocks_ref, fused_pushsum_mix_ref,
                  fused_stale_mix_ref)


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
    _build.refuse_grad("fused_pushsum_mix", flat, w, P)
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


def fused_pushsum_mix_blocks(flat: torch.Tensor, w: torch.Tensor, blocks, *,
                             debias: bool = False
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The hier exchange's intra-shard half: S independent [L, L] × [L, D]
    products, ``(blockdiag(blocks)·z [/ wm], wm)`` with ``wm`` the
    per-shard ``blocks[s] @ w[s·L:(s+1)·L]``.

    flat [S·L, D] f32/bf16, w [S·L], blocks [S, L, L] (array or tensor, any
    float dtype; used in f32). One launch of the mix kernel on a grid over
    the shards, each output bit-equal to :func:`fused_pushsum_mix` on its
    shard's rows with its block."""
    if flat.dim() != 2 or flat.shape[0] < 1 or flat.shape[1] < 1:
        raise ValueError("fused_pushsum_mix_blocks: flat must be a non-empty "
                         f"[S·L, D] matrix, got {tuple(flat.shape)}")
    if flat.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"fused_pushsum_mix_blocks: flat dtype {flat.dtype} "
                        "not supported (float32 or bfloat16)")
    shape = tuple(blocks.shape)
    if len(shape) != 3 or shape[1] != shape[2] or shape[0] < 1 \
            or shape[0] * shape[1] != flat.shape[0] \
            or tuple(w.shape) != (flat.shape[0],):
        raise ValueError(
            "fused_pushsum_mix_blocks: need blocks [S, L, L] with S·L = "
            f"{flat.shape[0]} rows and w [{flat.shape[0]}], got blocks "
            f"{shape} and w {tuple(w.shape)}")
    _build.refuse_grad("fused_pushsum_mix_blocks", flat, w, blocks)
    if flat.device.type == "cpu":
        return fused_pushsum_mix_blocks_ref(flat, w, blocks, debias=debias)
    S, L, _ = shape
    D = flat.shape[1]
    Bf = torch.as_tensor(blocks, dtype=torch.float32,
                         device=flat.device).contiguous()
    wm = torch.einsum("sij,sj->si", Bf,
                      w.to(torch.float32).reshape(S, L)).reshape(S * L)
    _build.check_cuda("fused_pushsum_mix_blocks", flat, Bf, wm)
    out = torch.empty_like(flat)
    _build.launch("repro_pushsum_mix_blocks", flat.data_ptr(),
                  _build.DTYPE_CODES[flat.dtype], Bf.data_ptr(),
                  wm.data_ptr(), out.data_ptr(), S, L, D, int(debias))
    fused_pushsum_mix_blocks.launches += 1
    return out, wm.to(w.dtype)


fused_pushsum_mix_blocks.launches = 0


def fused_stale_mix(flat: torch.Tensor, w: torch.Tensor, kept, sent,
                    buf_t0: torch.Tensor, buf_w0: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                               torch.Tensor]:
    """One stale exchange: returns ``(z', send_t, w', send_w)``.

    flat, buf_t0 [K, D] f32/bf16 (one dtype); w, buf_w0 [K]; kept [K] and
    sent [K, K] the diag/off-diag split of P (array or tensor, used in
    f32). Accumulates in f32 and returns flat's dtype for z' and send_t,
    w's for w' and send_w. The caller owns the buffer rotation."""
    if flat.dim() != 2 or flat.shape[0] < 1 or flat.shape[1] < 1:
        raise ValueError("fused_stale_mix: flat must be a non-empty [K, D] "
                         f"matrix, got {tuple(flat.shape)}")
    if flat.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"fused_stale_mix: flat dtype {flat.dtype} not "
                        "supported (float32 or bfloat16)")
    K, D = flat.shape
    if buf_t0.shape != flat.shape or buf_t0.dtype != flat.dtype:
        raise ValueError("fused_stale_mix: buf_t0 must match flat's shape "
                         f"{tuple(flat.shape)} and dtype {flat.dtype}, got "
                         f"{tuple(buf_t0.shape)} {buf_t0.dtype}")
    shapes = [tuple(a.shape) for a in (w, kept, buf_w0, sent)]
    if shapes != [(K,), (K,), (K,), (K, K)]:
        raise ValueError(f"fused_stale_mix: need w, kept, buf_w0 [{K}] and "
                         f"sent [{K}, {K}], got {shapes}")
    _build.refuse_grad("fused_stale_mix", flat, w, kept, sent, buf_t0,
                       buf_w0)
    if flat.device.type == "cpu":
        return fused_stale_mix_ref(flat, w, kept, sent, buf_t0, buf_w0)

    def f32(a):
        return torch.as_tensor(a, dtype=torch.float32,
                               device=flat.device).contiguous()

    wf, keptf, sentf = f32(w), f32(kept), f32(sent)
    w2 = keptf * wf + buf_w0.to(torch.float32)
    send_w = sentf @ wf
    _build.check_cuda("fused_stale_mix", flat, buf_t0, wf, keptf, sentf, w2)
    z2, send_t = torch.empty_like(flat), torch.empty_like(flat)
    _build.launch("repro_stale_mix", flat.data_ptr(), buf_t0.data_ptr(),
                  _build.DTYPE_CODES[flat.dtype], wf.data_ptr(),
                  keptf.data_ptr(), sentf.data_ptr(), w2.data_ptr(),
                  z2.data_ptr(), send_t.data_ptr(), K, D)
    fused_stale_mix.launches += 1
    return z2, send_t, w2.to(w.dtype), send_w.to(w.dtype)


fused_stale_mix.launches = 0
