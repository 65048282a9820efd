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

:func:`mamba_scan_clients` is the ``"clients"`` route: K clients' scans,
each with its own A (a parameter of the client's model), in one launch of
the same kernel over the K·B batch rows (row b reads client b // B's A),
each client's y and final state bit-equal to a flat launch on it.
:func:`mamba_scan` is a ``torch.library`` custom op whose
``torch.func.vmap`` rule runs that route, as ``jax.vmap`` adds a grid axis
to the reference's ``pallas_call``: one launch for a cohort vmapped by the
stacked executor of ``repro_torch.core.engine``. ``route_launches``
counts each launch under ``"flat"`` or ``"clients"``. A call outside
every ``torch.func`` transform and dispatch mode (serving, evaluation)
runs the op's body directly, without the dispatcher.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import _build
from .ref import mamba_scan_clients_ref, mamba_scan_ref

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


def _check(name: str, dt, x, B_in, C_in, A, h0) -> None:
    """dt, x [B, S, di]; B, C [B, S, ds]; A [di, ds]; h0 None or [B, di,
    ds] f32; ds <= 64; f32 or bf16."""
    if x.dim() != 3 or x.numel() == 0:
        raise ValueError(f"{name}: x must be a non-empty [B, S, di], got "
                         f"{tuple(x.shape)}")
    Bsz, S, di = x.shape
    ds = A.shape[-1] if A.dim() == 2 else -1
    if dt.shape != x.shape or tuple(A.shape) != (di, ds) or ds < 1 \
            or any(tuple(t.shape) != (Bsz, S, ds) for t in (B_in, C_in)):
        raise ValueError(
            f"{name}: need dt, x [B, S, di], B, C [B, S, ds], A [di, ds]; "
            f"got {[tuple(t.shape) for t in (dt, x, B_in, C_in, A)]}")
    if ds > MAX_STATE:
        raise ValueError(f"{name}: ds = {ds} > {MAX_STATE} states")
    if any(t.dtype not in _build.DTYPE_CODES for t in (dt, x, B_in, C_in, A)):
        raise TypeError(f"{name}: dtypes must be float32 or bfloat16")
    if h0 is not None and (tuple(h0.shape) != (Bsz, di, ds)
                           or h0.dtype != torch.float32):
        raise ValueError(f"{name}: h0 must be [B, di, ds] float32 "
                         f"{(Bsz, di, ds)}, got {tuple(h0.shape)} {h0.dtype}")


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
    _check("mamba_scan", dt, x, B_in, C_in, A, h0)
    di = x.shape[2]
    if chunk < 1 or block_d < 1 or di % min(block_d, di):
        raise ValueError(f"mamba_scan: need chunk, block_d >= 1 and di % "
                         f"min(block_d, di) == 0, got chunk {chunk}, "
                         f"block_d {block_d}, di {di}")
    _build.refuse_grad("mamba_scan", dt, x, B_in, C_in, A, h0)
    scan = _mamba_scan_op if _build.through_op() else _mamba_scan
    y, h_last = scan(dt, x, B_in, C_in, A, h0, bool(return_state))
    return (y, h_last) if return_state else y


def _launch(entry: str, dt, x, B_in, C_in, A, h0, return_state: bool):
    """One launch of ``entry`` on one client's contiguous inputs, or (the
    ``_clients`` entry) K clients' stacked ones; returns (y, the final
    state or an empty tensor)."""
    Af = A.to(torch.float32)
    y = torch.empty_like(x)
    *lead, S, di = x.shape
    ds = A.shape[-1]
    h_last = torch.empty((*lead, di, ds), dtype=torch.float32,
                         device=x.device) if return_state \
        else x.new_empty((0,), dtype=torch.float32)
    codes = _build.DTYPE_CODES
    _build.launch(entry, dt.data_ptr(), codes[dt.dtype],
                  x.data_ptr(), codes[x.dtype], B_in.data_ptr(),
                  codes[B_in.dtype], C_in.data_ptr(), codes[C_in.dtype],
                  Af.data_ptr(), y.data_ptr(),
                  None if h0 is None else h0.data_ptr(),
                  h_last.data_ptr() if return_state else None,
                  *lead, S, di, ds)
    mamba_scan.launches += 1
    return y, h_last


def _mamba_scan(dt, x, B_in, C_in, A, h0, return_state: bool):
    """The op's body, on inputs :func:`mamba_scan` has checked; returns
    (y, the final state or an empty tensor)."""
    if _build.plain(x):
        if return_state:
            return mamba_scan_ref(dt, x, B_in, C_in, A, h0, True)
        return (mamba_scan_ref(dt, x, B_in, C_in, A, h0),
                x.new_empty((0,), dtype=torch.float32))
    _build.check_cuda("mamba_scan", dt, x, B_in, C_in, A,
                      *(() if h0 is None else (h0,)))
    if x.shape[0] > 65535:
        raise ValueError(f"mamba_scan: batch {x.shape[0]} > 65535")
    out = _launch("repro_mamba_scan", dt, x, B_in, C_in, A, h0,
                  return_state)
    mamba_scan.route_launches["flat"] += 1
    return out


def mamba_scan_clients(dt: torch.Tensor, x: torch.Tensor, B_in: torch.Tensor,
                       C_in: torch.Tensor, A: torch.Tensor, *,
                       h0: Optional[torch.Tensor] = None,
                       return_state: bool = False):
    """K clients' :func:`mamba_scan` in one launch: dt, x [K, B, S, di];
    B_in, C_in [K, B, S, ds]; A [K, di, ds]; h0 None or [K, B, di, ds] f32
    (all contiguous on a CUDA device), K·B at most 65,535. Returns y [K, B,
    S, di] (and the final states [K, B, di, ds]), client k bit-equal to
    ``mamba_scan`` on its own inputs."""
    if x.dim() != 4 or A.dim() != 3 or A.shape[0] != x.shape[0] \
            or any(t.dim() != 4 or t.shape[:2] != x.shape[:2]
                   for t in (dt, B_in, C_in)) \
            or (h0 is not None and (h0.dim() != 4
                                    or h0.shape[:2] != x.shape[:2])):
        raise ValueError(
            "mamba_scan_clients: need dt, x [K, B, S, di], B, C [K, B, S, "
            "ds], A [K, di, ds], h0 [K, B, di, ds]; got "
            f"{[tuple(t.shape) for t in (dt, x, B_in, C_in, A)]}")
    _check("mamba_scan_clients", dt[0], x[0], B_in[0], C_in[0], A[0],
           None if h0 is None else h0[0])
    _build.refuse_grad("mamba_scan_clients", dt, x, B_in, C_in, A, h0)
    if _build.plain(x):
        return mamba_scan_clients_ref(dt, x, B_in, C_in, A, h0, return_state)
    _build.check_cuda("mamba_scan_clients", dt, x, B_in, C_in, A,
                      *(() if h0 is None else (h0,)))
    K, Bsz = x.shape[:2]
    if K * Bsz > 65535:
        raise ValueError(f"mamba_scan_clients: K·B = {K * Bsz} batch rows > "
                         "65535")
    y, h_last = _launch("repro_mamba_scan_clients", dt, x, B_in, C_in, A, h0,
                        return_state)
    mamba_scan.route_launches["clients"] += 1
    return (y, h_last) if return_state else y


mamba_scan.launches = 0
mamba_scan.route_launches = {"flat": 0, "clients": 0}

_mamba_scan_op = _build.custom_op(
    "repro_torch::mamba_scan", _mamba_scan,
    schema="(Tensor dt, Tensor x, Tensor B, Tensor C, Tensor A, Tensor? h0, "
           "bool return_state) -> (Tensor, Tensor)")


@_mamba_scan_op.register_fake
def _mamba_scan_fake(dt, x, B_in, C_in, A, h0, return_state):
    _check("mamba_scan", dt, x, B_in, C_in, A, h0)
    Bsz, _, di = x.shape
    state = (Bsz, di, A.shape[-1]) if return_state else (0,)
    return torch.empty_like(x), x.new_empty(state, dtype=torch.float32)


@_mamba_scan_op.register_vmap
def _mamba_scan_vmap(info, in_dims, dt, x, B_in, C_in, A, h0, return_state):
    # every client's inputs stacked (an unbatched one repeated) and the
    # client route: one launch for the cohort
    n = info.batch_size
    dt, x, B_in, C_in, A, h0 = (
        None if t is None else (t.movedim(d, 0) if d is not None else
                                t.expand((n,) + tuple(t.shape))).contiguous()
        for t, d in zip((dt, x, B_in, C_in, A, h0), in_dims))
    out = mamba_scan_clients(dt, x, B_in, C_in, A, h0=h0,
                             return_state=return_state)
    if return_state:
        return out, (0, 0)
    return (out, x.new_empty((0,), dtype=torch.float32)), (0, None)
