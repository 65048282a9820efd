"""Mamba-1 selective-SSM block (falcon-mamba, jamba; port of
``src/repro/nn/mamba.py``).

The model's own scan is chunked: an outer loop over sequence chunks carries
the [B, d_inner, d_state] state, and each chunk's recurrence is the
work-efficient associative scan of ``jax.lax.associative_scan`` (the same
odd/even recursion, so the same pairs are combined in the same order).
Decode is the single-step recurrence with a rolling conv state.

With ``use_pallas`` on, a block of S > 1 steps runs the scan kernel
(``kernels.mamba_scan``) from the cache's state, returning the final state
for the cache; decode (S = 1) stays the plain single step.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import MambaConfig, ModelConfig
from ..kernels.mamba_scan import mamba_scan
from .modules import Params, init_linear, linear, normal_init, zeros_init


def init_mamba(generator: torch.Generator, cfg: ModelConfig,
               dtype=torch.float32) -> Params:
    m = cfg.mamba or MambaConfig()
    d, di, ds, dtr = cfg.d_model, cfg.d_inner, m.d_state, cfg.resolved_dt_rank
    dev = generator.device
    # S4D-real initialization for A; dt bias so softplus(dt) starts ~1e-3..1e-1
    A = torch.arange(1, ds + 1, dtype=torch.float32, device=dev).expand(di, ds)
    return {
        "in_proj": init_linear(generator, d, 2 * di, dtype=dtype),
        "conv_w": normal_init(generator, (m.d_conv, di), 0.2, dtype),
        "conv_b": zeros_init(generator, (di,), dtype),
        "x_proj": init_linear(generator, di, dtr + 2 * ds, dtype=dtype),
        "dt_proj": init_linear(generator, dtr, di, bias=True,
                               scale=dtr ** -0.5, dtype=dtype),
        "A_log": torch.log(A).to(dtype),
        "D": torch.ones((di,), dtype=dtype, device=dev),
        "out_proj": init_linear(generator, di, d, dtype=dtype),
    }


def init_mamba_cache(cfg: ModelConfig, batch: int, dtype=torch.float32,
                     device="cpu") -> Params:
    m = cfg.mamba or MambaConfig()
    return {
        "conv": torch.zeros((batch, m.d_conv - 1, cfg.d_inner), dtype=dtype,
                            device=device),
        "ssm": torch.zeros((batch, cfg.d_inner, m.d_state),
                           dtype=torch.float32, device=device),
    }


def _causal_conv(p: Params, x: torch.Tensor,
                 prev: Optional[torch.Tensor]) -> torch.Tensor:
    """Depthwise causal conv along seq. x: [B, S, di]; prev: [B, d_conv-1,
    di]."""
    K = p["conv_w"].shape[0]
    if prev is None:
        prev = torch.zeros((x.shape[0], K - 1, x.shape[2]), dtype=x.dtype,
                           device=x.device)
    xp = torch.cat([prev.to(x.dtype), x], dim=1)
    S = x.shape[1]
    y = sum(xp[:, i:i + S, :] * p["conv_w"][i] for i in range(K))
    return y + p["conv_b"]


def _ssm_inputs(p: Params, cfg: ModelConfig, xc: torch.Tensor):
    """From conv output xc: [B, S, di] compute (dt, B, C, A) in f32 (B and C
    contiguous, as the scan kernel reads them)."""
    m = cfg.mamba or MambaConfig()
    dtr = cfg.resolved_dt_rank
    dbc = linear(p["x_proj"], xc)
    dt_r = dbc[..., :dtr]
    Bm = dbc[..., dtr:dtr + m.d_state].to(torch.float32).contiguous()
    Cm = dbc[..., dtr + m.d_state:].to(torch.float32).contiguous()
    u = linear(p["dt_proj"], dt_r).to(torch.float32) - 4.0
    dt = torch.logaddexp(u, torch.zeros_like(u))   # jax.nn.softplus
    A = -torch.exp(p["A_log"].to(torch.float32))
    return dt, Bm, Cm, A


def associative_scan(fn: Callable, elems: Sequence[torch.Tensor]
                     ) -> List[torch.Tensor]:
    """Inclusive scan of ``fn`` along axis 1 by the recursion of
    ``jax.lax.associative_scan``: combine adjacent pairs, scan the halved
    sequence, then fill in the even positions."""
    n = elems[0].shape[1]
    if n < 2:
        return list(elems)
    reduced = fn([e[:, 0:-1:2] for e in elems], [e[:, 1::2] for e in elems])
    odd = associative_scan(fn, reduced)
    if n % 2 == 0:
        even = fn([e[:, :-1] for e in odd], [e[:, 2::2] for e in elems])
    else:
        even = fn(odd, [e[:, 2::2] for e in elems])
    even = [torch.cat([e[:, :1], r], dim=1) for e, r in zip(elems, even)]
    return [_interleave(e, o) for e, o in zip(even, odd)]


def _interleave(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    """Positions 0, 2, 4, … from ``even`` and 1, 3, … from ``odd`` along
    axis 1 (``even`` one longer when the length is odd), out of place, as
    ``torch.func.vmap`` needs."""
    n_odd = odd.shape[1]
    pairs = torch.stack([even[:, :n_odd], odd], dim=2).flatten(1, 2)
    return pairs if even.shape[1] == n_odd else torch.cat(
        [pairs, even[:, n_odd:]], dim=1)


def _combine(left, right):
    al, bl = left
    ar, br = right
    return [al * ar, bl * ar + br]


def _chunk_scan(h0, dt, A, Bm, Cm, xc):
    """One chunk of the selective scan.

    h0: [B, di, ds] f32; dt, xc: [B, C, di]; Bm, Cm: [B, C, ds]; A: [di, ds].
    Returns (y [B, C, di] f32, h_last [B, di, ds]).
    """
    a = torch.exp(dt[..., None] * A)   # [B, C, di, ds]
    b = (dt * xc.to(torch.float32))[..., None] * Bm[:, :, None, :]
    a_cum, b_cum = associative_scan(_combine, (a, b))
    h = a_cum * h0[:, None] + b_cum   # [B, C, di, ds]
    y = torch.einsum("bcds,bcs->bcd", h, Cm)
    return y, h[:, -1]


def selective_scan(h0, dt, A, Bm, Cm, xc, chunk: int):
    """The model's scan of S steps from h0: one :func:`_chunk_scan` when
    S ≤ chunk, else a loop over chunks (the last padded with dt = 0, an
    identity step). Returns (y [B, S, di] f32, h_last)."""
    S = dt.shape[1]
    if S <= chunk:
        return _chunk_scan(h0, dt, A, Bm, Cm, xc)
    n = -(-S // chunk)
    pad = n * chunk - S
    if pad:
        dt, Bm, Cm, xc = (F.pad(t, (0, 0, 0, pad)) for t in (dt, Bm, Cm, xc))
    h_last, ys = h0, []
    for c in range(n):
        cut = slice(c * chunk, (c + 1) * chunk)
        y_c, h_last = _chunk_scan(h_last, dt[:, cut], A, Bm[:, cut],
                                  Cm[:, cut], xc[:, cut])
        ys.append(y_c)
    return torch.cat(ys, dim=1)[:, :S], h_last


def apply_mamba(
    p: Params,
    cfg: ModelConfig,
    x: torch.Tensor,   # [B, S, d]
    *,
    cache: Optional[Params] = None,
    chunk: int = 256,
    use_pallas: bool = True,
) -> Tuple[torch.Tensor, Optional[Params]]:
    """Returns the output and the cache (the same dict, its conv and SSM
    states overwritten)."""
    m = cfg.mamba or MambaConfig()
    B, S, _ = x.shape
    di = cfg.d_inner
    xz = linear(p["in_proj"], x)
    x1, z = xz[..., :di], xz[..., di:]

    prev_conv = cache["conv"] if cache is not None else None
    xc = F.silu(_causal_conv(p, x1, prev_conv))
    dt, Bm, Cm, A = _ssm_inputs(p, cfg, xc)
    h0 = cache["ssm"] if cache is not None else torch.zeros(
        (B, di, m.d_state), dtype=torch.float32, device=x.device)

    if S == 1:
        # decode: single recurrence step
        a = torch.exp(dt[:, 0, :, None] * A)
        b = (dt[:, 0] * xc[:, 0].to(torch.float32))[..., None] \
            * Bm[:, 0, None, :]
        h = a * h0 + b
        y = torch.einsum("bds,bs->bd", h, Cm[:, 0])[:, None, :]
        h_last = h
    elif use_pallas:
        # xc in f32, so that y comes back in f32 for the D·xc skip below;
        # the cache's state in, its final state out
        xf = xc.to(torch.float32).contiguous()
        if cache is None:
            y = mamba_scan(dt, xf, Bm, Cm, A)
        else:
            y, h_last = mamba_scan(dt, xf, Bm, Cm, A, h0=h0,
                                   return_state=True)
    else:
        y, h_last = selective_scan(h0, dt, A, Bm, Cm, xc, chunk)

    y = y + p["D"].to(torch.float32) * xc.to(torch.float32)
    out = linear(p["out_proj"], y.to(x.dtype) * F.silu(z))

    if cache is not None:
        K = m.d_conv
        if S >= K - 1:
            conv_state = x1[:, S - (K - 1):, :]
        else:
            conv_state = torch.cat([cache["conv"][:, S:, :], x1], dim=1)
        cache["conv"].copy_(conv_state)
        cache["ssm"].copy_(h_last)
    return out, cache
