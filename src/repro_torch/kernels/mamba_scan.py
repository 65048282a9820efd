"""Mamba-1 selective scan (the recurrence; the caller applies the D·x skip
and the gate).

:func:`mamba_scan` computes ``h_t = exp(dt_t·A)⊙h_{t-1} + (dt_t·x_t)·B_t``,
``y_t = C_t·h_t`` with an f32 state from zero (or from ``h0``), and
returns the final state too where asked (``return_state``: what a model's
prefill leaves in its SSM cache). On a CUDA tensor it launches
the kernel of ``csrc/mamba_scan.cu`` (replacing
``src/repro/kernels/mamba_scan.py``'s ``mamba_scan``); on a CPU tensor it
runs the plain version in :mod:`.ref`. The kernel spreads a channel's
states over :func:`scan_lanes` lanes of a warp, :func:`scan_states` states
a lane.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import _build
from .ref import mamba_scan_ref

MAX_STATE = 64   # the kernel keeps a channel's states in registers
LANE_COUNTS = (2, 4, 8, 16)   # the kernel's compiled lanes a channel


def scan_lanes(ds: int) -> int:
    """Lanes a channel that the kernel takes at ``ds`` states (the C
    entry point's ``lanes_for``)."""
    if not 1 <= ds <= MAX_STATE:
        raise ValueError(f"scan_lanes: ds = {ds} outside 1..{MAX_STATE}")
    return 2 if ds <= 8 else 4 if ds <= 16 else 8 if ds <= 32 else 16


def scan_states(ds: int) -> int:
    """States a lane at ``ds`` states: ``ds / scan_lanes(ds)`` rounded up to
    a power of two, 1, 2 or 4 (the states past ds are zero; the C entry
    point's ``states_for``)."""
    per = -(-ds // scan_lanes(ds))
    return next(n for n in (1, 2, 4) if per <= n)


def mamba_scan(dt: torch.Tensor, x: torch.Tensor, B_in: torch.Tensor,
               C_in: torch.Tensor, A: torch.Tensor, *, chunk: int = 128,
               block_d: int = 512, h0: Optional[torch.Tensor] = None,
               return_state: bool = False):
    """dt, x [B, S, di]; B_in, C_in [B, S, ds]; A [di, ds]; each f32 or
    bf16, ds ≤ 64; ``h0`` None (a zero state) or [B, di, ds] f32. Returns
    y [B, S, di] in x's dtype, or (y, the final state [B, di, ds] f32) with
    ``return_state``. ``chunk`` and ``block_d`` are the reference's tiling,
    accepted for its signature with its contract ``di % min(block_d, di)
    == 0``; the CUDA kernel tiles on its own."""
    if x.dim() != 3 or x.numel() == 0:
        raise ValueError(f"mamba_scan: x must be a non-empty [B, S, di], got "
                         f"{tuple(x.shape)}")
    Bsz, S, di = x.shape
    ds = A.shape[-1] if A.dim() == 2 else -1
    if dt.shape != x.shape or tuple(A.shape) != (di, ds) or ds < 1 \
            or any(tuple(t.shape) != (Bsz, S, ds) for t in (B_in, C_in)):
        raise ValueError(
            "mamba_scan: need dt, x [B, S, di], B, C [B, S, ds], A [di, ds]; "
            f"got {[tuple(t.shape) for t in (dt, x, B_in, C_in, A)]}")
    if ds > MAX_STATE:
        raise ValueError(f"mamba_scan: ds = {ds} > {MAX_STATE} states")
    if any(t.dtype not in _build.DTYPE_CODES for t in (dt, x, B_in, C_in, A)):
        raise TypeError("mamba_scan: dtypes must be float32 or bfloat16")
    if chunk < 1 or block_d < 1 or di % min(block_d, di):
        raise ValueError(f"mamba_scan: need chunk, block_d >= 1 and di % "
                         f"min(block_d, di) == 0, got chunk {chunk}, "
                         f"block_d {block_d}, di {di}")
    if h0 is not None and (tuple(h0.shape) != (Bsz, di, ds)
                           or h0.dtype != torch.float32):
        raise ValueError(f"mamba_scan: h0 must be [B, di, ds] float32 "
                         f"{(Bsz, di, ds)}, got {tuple(h0.shape)} {h0.dtype}")
    _build.refuse_grad("mamba_scan", dt, x, B_in, C_in, A, h0)
    if x.device.type == "cpu":
        return mamba_scan_ref(dt, x, B_in, C_in, A, h0, return_state)
    _build.check_cuda("mamba_scan", dt, x, B_in, C_in, A,
                      *(() if h0 is None else (h0,)))
    if Bsz > 65535:
        raise ValueError(f"mamba_scan: batch {Bsz} > 65535")
    Af = A.to(torch.float32)
    y = torch.empty_like(x)
    h_last = torch.empty((Bsz, di, ds), dtype=torch.float32,
                         device=x.device) if return_state else None
    codes = _build.DTYPE_CODES
    _build.launch("repro_mamba_scan", dt.data_ptr(), codes[dt.dtype],
                  x.data_ptr(), codes[x.dtype], B_in.data_ptr(),
                  codes[B_in.dtype], C_in.data_ptr(), codes[C_in.dtype],
                  Af.data_ptr(), y.data_ptr(),
                  None if h0 is None else h0.data_ptr(),
                  None if h_last is None else h_last.data_ptr(),
                  Bsz, S, di, ds)
    mamba_scan.launches += 1
    return (y, h_last) if return_state else y


mamba_scan.launches = 0
