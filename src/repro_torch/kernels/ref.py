"""Plain PyTorch versions of the hand-written kernels.

Each follows its counterpart in ``src/repro/kernels/ref.py`` line for line.
The CPU path of every wrapper runs them, the tests compare with them, and
``chip_smoke.py`` holds each CUDA kernel against them on the card. Python
scalars enter each operation as f32, as JAX's weakly typed scalars do.
"""
from __future__ import annotations

from typing import Optional

import torch


def sumsq_ref(x: torch.Tensor) -> torch.Tensor:
    return torch.sum(torch.square(x.to(torch.float32)))


def scale_accumulate_ref(acc: torch.Tensor, g: torch.Tensor,
                         scale) -> torch.Tensor:
    return acc + g.to(torch.float32) * scale


def sumsq_rows_ref(x: torch.Tensor) -> torch.Tensor:
    """Each row's :func:`sumsq_ref`, stacked: [B]. Row by row, because a
    1-D CPU sum splits a long row across threads and ``sum(dim=1)`` does
    not, so the two can differ in the last bit."""
    return torch.stack([sumsq_ref(row) for row in x])


def clip_accumulate_rows_ref(g: torch.Tensor,
                             scales: torch.Tensor) -> torch.Tensor:
    """Σᵢ gᵢ·scalesᵢ over the rows in order, from 0, as B chained
    :func:`scale_accumulate_ref` calls: [D] f32."""
    acc = torch.zeros(g.shape[1], dtype=torch.float32, device=g.device)
    for i in range(g.shape[0]):
        acc = acc + g[i].to(torch.float32) * scales[i]
    return acc


def clip_accumulate_rows_clients_ref(g: torch.Tensor,
                                     scales: torch.Tensor) -> torch.Tensor:
    """K clients' :func:`clip_accumulate_rows_ref`, one client at a time:
    [K, D] f32 from g [K, B, D] and scales [K, B]."""
    return torch.stack([clip_accumulate_rows_ref(g[k], scales[k])
                        for k in range(g.shape[0])])


def fused_pushsum_mix_ref(flat: torch.Tensor, w: torch.Tensor, P, *,
                          debias: bool = True):
    """Synchronous PushSum exchange, f32 accumulation: (P·z [/ P·w], P·w)."""
    Pf = torch.as_tensor(P, dtype=torch.float32, device=flat.device)
    mixed = Pf @ flat.to(torch.float32)
    w2 = Pf @ w.to(torch.float32)
    if debias:
        mixed = mixed / w2[:, None]
    return mixed.to(flat.dtype), w2.to(w.dtype)


def fused_pushsum_mix_blocks_ref(flat: torch.Tensor, w: torch.Tensor,
                                 blocks, *, debias: bool = False):
    """The hier exchange's intra-shard half, f32 accumulation: S independent
    [L, L] × [L, D] products of ``blocks`` [S, L, L] with the shards' rows
    of ``flat`` [S·L, D] (and of ``w`` [S·L]), de-biased or not."""
    Bf = torch.as_tensor(blocks, dtype=torch.float32, device=flat.device)
    S, L, _ = Bf.shape
    mixed = torch.einsum("sij,sjd->sid", Bf,
                         flat.to(torch.float32).reshape(S, L, -1))
    # shard by shard, as S calls of fused_pushsum_mix_ref form it: on the
    # CPU a batched matrix-vector product rounds otherwise than `@`
    ws = w.to(torch.float32).reshape(S, L)
    wm = torch.stack([Bf[s] @ ws[s] for s in range(S)])
    if debias:
        mixed = mixed / wm[..., None]
    return (mixed.reshape(flat.shape).to(flat.dtype),
            wm.reshape(w.shape).to(w.dtype))


def fused_stale_mix_ref(flat, w, kept, sent, buf_t0, buf_w0):
    """Stale (async τ>0) exchange: re-bias θ = z·w, split kept/sent, merge
    the delayed delivery, de-bias — returns (z', send_t, w', send_w)."""
    keptf = torch.as_tensor(kept, dtype=torch.float32, device=flat.device)
    sentf = torch.as_tensor(sent, dtype=torch.float32, device=flat.device)
    wf = w.to(torch.float32)
    theta = flat.to(torch.float32) * wf[:, None]
    send_t = sentf @ theta
    send_w = sentf @ wf
    mixed = keptf[:, None] * theta + buf_t0.to(torch.float32)
    w2 = keptf * wf + buf_w0.to(torch.float32)
    z2 = mixed / w2[:, None]
    return (z2.to(flat.dtype), send_t.to(flat.dtype), w2.to(w.dtype),
            send_w.to(w.dtype))


def noise_adam_step_ref(acc, noise, p, m, v, *, stddev, n_units, lr,
                        weight_decay=0.0, b1=0.9, b2=0.999, eps=1e-8,
                        c1=None, c2=None):
    g = (acc.to(torch.float32) + stddev * noise.to(torch.float32)) / n_units
    pf = p.to(torch.float32)
    g = g + weight_decay * pf
    m2 = b1 * m.to(torch.float32) + (1.0 - b1) * g
    v2 = b2 * v.to(torch.float32) + (1.0 - b2) * g * g
    step = lr * (m2 / c1) / (torch.sqrt(v2 / c2) + eps)
    return (pf - step).to(p.dtype), m2.to(m.dtype), v2.to(v.dtype)


def noise_adam_step_clients_ref(acc, noise, p, m, v, *, c1, c2, **hp):
    """K clients' :func:`noise_adam_step_ref`, one client at a time: the
    vectors [K, D], the bias corrections ``c1`` / ``c2`` [K]."""
    outs = [noise_adam_step_ref(acc[k], noise[k], p[k], m[k], v[k],
                                c1=c1[k], c2=c2[k], **hp)
            for k in range(acc.shape[0])]
    return tuple(torch.stack(x) for x in zip(*outs))


def noise_sgd_step_ref(acc, noise, p, *, stddev, n_units, lr,
                       weight_decay=0.0):
    g = (acc.to(torch.float32) + stddev * noise.to(torch.float32)) / n_units
    pf = p.to(torch.float32)
    g = g + weight_decay * pf
    return (pf - lr * g).to(p.dtype)


def clip_accumulate_ref(acc, g, clip_norm: float) -> torch.Tensor:
    norm = torch.sqrt(sumsq_ref(g))
    return acc + g.to(torch.float32) / torch.clamp(norm / clip_norm, min=1.0)


def rmsnorm_ref(x, g, eps: float = 1e-6) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * g.to(torch.float32)).to(x.dtype)


def rmsnorm_clients_ref(x, g, eps: float = 1e-6) -> torch.Tensor:
    """K clients' :func:`rmsnorm_ref`, one client at a time: x [K, rows,
    d], each client's gain g [K, d]."""
    return torch.stack([rmsnorm_ref(x[k], g[k], eps)
                        for k in range(x.shape[0])])


def flash_attention_ref(q, k, v, *, causal: bool = True,
                        window: Optional[int] = None,
                        scale: Optional[float] = None) -> torch.Tensor:
    """Naive materialized-scores attention. q/k/v: [B, H, S, D]."""
    B, H, S, D = q.shape
    scale = scale if scale is not None else D ** -0.5
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(torch.float32),
                     k.to(torch.float32)) * scale
    qp = torch.arange(S, device=q.device)[:, None]
    kp = torch.arange(S, device=q.device)[None, :]
    ok = torch.ones((S, S), dtype=torch.bool, device=q.device)
    if causal:
        ok &= kp <= qp
    if window is not None:
        ok &= (qp - kp) < window
    s = torch.where(ok, s, float("-inf"))
    p = torch.softmax(s, dim=-1)
    p = torch.where(torch.isnan(p), 0.0, p)
    return torch.einsum("bhqk,bhkd->bhqd", p,
                        v.to(torch.float32)).to(q.dtype)


def gqa_flash_attention_ref(q, k, v, *, causal: bool = True,
                            window: Optional[int] = None,
                            scale: Optional[float] = None) -> torch.Tensor:
    """Grouped-query attention on the model layout: q [B, S, Hq, D], k/v
    [B, S, Hkv, D]; the KV heads repeated, then :func:`flash_attention_ref`
    on [B, H, S, D]."""
    rep = q.shape[2] // k.shape[2]
    if rep != 1:
        k = torch.repeat_interleave(k, rep, dim=2)
        v = torch.repeat_interleave(v, rep, dim=2)
    out = flash_attention_ref(*(t.transpose(1, 2) for t in (q, k, v)),
                              causal=causal, window=window, scale=scale)
    return out.transpose(1, 2)


def mamba_scan_ref(dt, x, B_in, C_in, A, h0=None, return_state=False):
    """Sequential selective scan. dt/x: [B,S,di]; B/C: [B,S,ds]; A: [di,ds];
    the state from ``h0`` [B,di,ds] f32 (zero when None). Returns y, or
    (y, the final state [B,di,ds] f32) with ``return_state``."""
    Bsz, S, di = x.shape
    h = torch.zeros((Bsz, di, A.shape[1]), dtype=torch.float32,
                    device=x.device) if h0 is None else h0.to(torch.float32)
    dtf, xf, bf, cf = (t.to(torch.float32) for t in (dt, x, B_in, C_in))
    ys = []
    for t in range(S):
        a = torch.exp(dtf[:, t, :, None] * A)  # [B, di, ds]
        h = a * h + (dtf[:, t] * xf[:, t])[..., None] * bf[:, t, None, :]
        ys.append(torch.einsum("bds,bs->bd", h, cf[:, t]))
    y = torch.stack(ys, dim=1).to(x.dtype)
    return (y, h) if return_state else y


def mamba_scan_clients_ref(dt, x, B_in, C_in, A, h0=None, return_state=False):
    """K clients' :func:`mamba_scan_ref`, one client at a time: dt, x [K,
    B, S, di], B, C [K, B, S, ds], each client's A [K, di, ds], h0 [K, B,
    di, ds] or None."""
    outs = [mamba_scan_ref(dt[k], x[k], B_in[k], C_in[k], A[k],
                           None if h0 is None else h0[k], return_state)
            for k in range(x.shape[0])]
    if not return_state:
        return torch.stack(outs)
    return tuple(torch.stack(t) for t in zip(*outs))
