"""Attention: GQA/MHA with causal, sliding-window and KV-cache decode paths
(port of ``src/repro/nn/attention.py``).

:func:`attend` is the model's own attention, an online softmax over KV
chunks in f32 (the S×S score matrix of a long context is never
materialized), with grouped queries (``Hq = G * Hkv``), different QK and V
head dims (MLA), causal and sliding-window masks from explicit position
vectors, and any query offset (decode against a cache).

With ``use_pallas`` on, :func:`apply_attention` runs the flash attention
kernel (``kernels.ops.gqa_flash_attention``) where it computes the same
function as :func:`attend`: a block of S > 1 fresh tokens at position 0,
with or without a cache. There the cache holds nothing yet (a linear
cache's unwritten slots and a ring buffer's old slots are all masked), so
attention over the cache is causal (or windowed causal) attention over the
fresh keys. Decode (S = 1) and any other offset run :func:`attend`.
Positions are int64 on the host's side of the port: ``pos_offset`` is a
Python int.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..configs.base import LayerSpec, ModelConfig
from ..kernels.ops import gqa_flash_attention
from .modules import (Params, apply_rope, checkpoint, init_linear,
                      lazy_einsum, linear)

NEG_INF = float("-inf")
# the position of a padded or never-written key slot: after every query
POS_MAX = torch.iinfo(torch.int32).max


def _mask(q_pos: torch.Tensor, kv_pos: torch.Tensor,
          window: Optional[int]) -> torch.Tensor:
    """[Sq, Sk] boolean validity mask (True == attend)."""
    ok = kv_pos[None, :] <= q_pos[:, None]
    if window is not None:
        ok &= (q_pos[:, None] - kv_pos[None, :]) < window
    return ok


def _attend_dense(q, k, v, q_pos, kv_pos, window, scale):
    """Single-block attention (small Sk). q: [B, Sq, Hkv, G, Dqk]. The
    products of q and k in f32, as the reference's
    ``preferred_element_type``."""
    s = torch.einsum("bqhgd,bkhd->bhgqk", q.to(torch.float32),
                     k.to(torch.float32))
    s = s * scale
    ok = _mask(q_pos, kv_pos, window)
    s = torch.where(ok, s, NEG_INF)
    m = torch.amax(s, dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, 0.0)   # fully-masked rows
    p = torch.where(ok, torch.exp(s - m), 0.0)
    l = torch.sum(p, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.to(torch.float32))
    return o / torch.clamp(l, min=1e-30).permute(0, 3, 1, 2)[..., None]


def attend(
    q: torch.Tensor,         # [B, Sq, Hq, Dqk]
    k: torch.Tensor,         # [B, Sk, Hkv, Dqk]
    v: torch.Tensor,         # [B, Sk, Hkv, Dv]
    *,
    q_pos: torch.Tensor,     # [Sq] absolute positions
    kv_pos: torch.Tensor,    # [Sk] absolute positions
    window: Optional[int] = None,
    kv_chunk: int = 1024,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Online-softmax causal attention; returns [B, Sq, Hq, Dv] in q's
    dtype."""
    B, Sq, Hq, Dqk = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    Dv = v.shape[-1]
    assert Hq % Hkv == 0, (Hq, Hkv)
    G = Hq // Hkv
    scale = scale if scale is not None else Dqk ** -0.5
    qr = q.reshape(B, Sq, Hkv, G, Dqk)

    if Sk <= kv_chunk:
        out = _attend_dense(qr, k, v, q_pos, kv_pos, window, scale)
        return out.reshape(B, Sq, Hq, Dv).to(q.dtype)

    # pad Sk to a multiple of the chunk; padded slots get kv_pos = POS_MAX
    n_chunks = -(-Sk // kv_chunk)
    pad = n_chunks * kv_chunk - Sk
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        kv_pos = torch.cat([kv_pos, torch.full((pad,), POS_MAX,
                                               dtype=kv_pos.dtype,
                                               device=kv_pos.device)])
    qf = qr.to(torch.float32)
    m = torch.full((B, Hkv, G, Sq), NEG_INF, device=q.device)
    l = torch.zeros((B, Hkv, G, Sq), device=q.device)
    acc = torch.zeros((B, Hkv, G, Sq, Dv), device=q.device)

    def chunk(tensors, lazy):
        m, l, acc, qf, kb, vb, qp, kp = tensors
        s = torch.einsum("bqhgd,bkhd->bhgqk", qf,
                         kb.to(torch.float32)) * scale
        ok = _mask(qp, kp, window)
        s = torch.where(ok, s, NEG_INF)
        m_new = torch.maximum(m, torch.amax(s, dim=-1))
        m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
        p = torch.where(ok, torch.exp(s - m_safe[..., None]), 0.0)
        corr = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
        l = l * corr + torch.sum(p, dim=-1)
        pv = (lazy_einsum if lazy else torch.einsum)(
            "bhgqk,bkhd->bhgqd", p, vb.to(torch.float32))
        return m_new, l, acc * corr[..., None] + pv

    # Under a gradient each chunk is rematerialized, as the reference's
    # scan body is (``jax.checkpoint``): without it every chunk's
    # probability block, the whole S×S score matrix in f32, would be kept
    # for the backward. The recompute leaves out the p·v product, which
    # only adds into the carry.
    remat = torch.is_grad_enabled() and any(
        t.requires_grad for t in (q, k, v))
    for c in range(n_chunks):
        cut = slice(c * kv_chunk, (c + 1) * kv_chunk)
        ins = (m, l, acc, qf, k[:, cut], v[:, cut], q_pos, kv_pos[cut])
        m, l, acc = checkpoint(chunk, *ins) if remat else chunk(ins, False)
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    out = out.permute(0, 3, 1, 2, 4).reshape(B, Sq, Hq, Dv)
    return out.to(q.dtype)


# ---------------------------------------------------------------------------
# GQA attention layer


def init_attention(generator: torch.Generator, cfg: ModelConfig,
                   dtype=torch.float32) -> Params:
    hd = cfg.resolved_head_dim
    return {
        "wq": init_linear(generator, cfg.d_model, cfg.n_heads * hd,
                          bias=cfg.qkv_bias, dtype=dtype),
        "wk": init_linear(generator, cfg.d_model, cfg.n_kv_heads * hd,
                          bias=cfg.qkv_bias, dtype=dtype),
        "wv": init_linear(generator, cfg.d_model, cfg.n_kv_heads * hd,
                          bias=cfg.qkv_bias, dtype=dtype),
        "wo": init_linear(generator, cfg.n_heads * hd, cfg.d_model,
                          dtype=dtype),
    }


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int,
                  dtype=torch.float32, window: Optional[int] = None,
                  device="cpu") -> Params:
    """KV cache. A sliding-window layer allocates a RING BUFFER of
    ``window`` slots instead of ``max_len``."""
    hd = cfg.resolved_head_dim
    slots = min(max_len, window) if window else max_len
    shape = (batch, slots, cfg.n_kv_heads, hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def positions(start: int, n: int, device) -> torch.Tensor:
    """[n] int64 absolute positions start, …, start + n − 1."""
    return torch.arange(start, start + n, dtype=torch.int64, device=device)


def apply_attention(
    p: Params,
    cfg: ModelConfig,
    spec: LayerSpec,
    x: torch.Tensor,   # [B, S, d]
    *,
    pos_offset: int = 0,
    cache: Optional[Params] = None,
    kv_chunk: int = 1024,
    use_pallas: bool = True,
) -> Tuple[torch.Tensor, Optional[Params]]:
    """Self-attention. With ``cache`` the new K/V are written at
    ``pos_offset`` (in place) and attention runs over the whole cache
    (prefill when S > 1, decode when S == 1); without it, attention is over
    ``x`` only. Returns the output and the cache (the same dict)."""
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    theta = spec.rope_theta or cfg.rope_theta
    off = int(pos_offset)
    q = linear(p["wq"], x).reshape(B, S, cfg.n_heads, hd)
    k = linear(p["wk"], x).reshape(B, S, cfg.n_kv_heads, hd)
    v = linear(p["wv"], x).reshape(B, S, cfg.n_kv_heads, hd)
    q_pos = positions(off, S, x.device)
    q = apply_rope(q, q_pos, theta)
    k = apply_rope(k, q_pos, theta)
    # the kernel's function: fresh keys at positions 0..S-1 (a linear cache
    # also holds them rounded to its dtype, so that must be k's)
    kernel = use_pallas and S > 1 and off == 0 and (
        cache is None or cache["k"].dtype == k.dtype
        or cache["k"].shape[1] == spec.window)

    def fresh():
        return gqa_flash_attention(q, k, v, causal=True, window=spec.window)

    if cache is None:
        out = fresh() if kernel else attend(
            q, k, v, q_pos=q_pos, kv_pos=q_pos, window=spec.window,
            kv_chunk=kv_chunk)
    else:
        ck, cv = cache["k"], cache["v"]
        Smax = ck.shape[1]
        if spec.window is not None and Smax == spec.window:
            # ring buffer: slot(p) = p % w. Attention runs over the PREVIOUS
            # ring contents (context positions off-w..off-1; unwritten slots
            # mask out) plus the fresh block, THEN the last min(S, w) new
            # tokens are written into their (unique) slots.
            w = spec.window
            if kernel:
                out = fresh()
            else:
                s_idx = torch.arange(w, dtype=torch.int64, device=x.device)
                last_old = off - 1
                pos_old = last_old - torch.remainder(last_old - s_idx, w)
                pos_old = torch.where(pos_old < 0, POS_MAX, pos_old)
                k_ctx = torch.cat([ck.to(k.dtype), k], dim=1)
                v_ctx = torch.cat([cv.to(v.dtype), v], dim=1)
                kv_pos = torch.cat([pos_old, q_pos])
                out = attend(q, k_ctx, v_ctx, q_pos=q_pos, kv_pos=kv_pos,
                             window=w, kv_chunk=kv_chunk)
            n = min(S, w)
            slots = torch.remainder(positions(off + S - n, n, x.device), w)
            ck[:, slots] = k[:, S - n:].to(ck.dtype)
            cv[:, slots] = v[:, S - n:].to(cv.dtype)
        else:
            ck[:, off:off + S] = k.to(ck.dtype)
            cv[:, off:off + S] = v.to(cv.dtype)
            if kernel:
                out = fresh()
            elif spec.window is not None and S == 1 and Smax > spec.window:
                # decode with sliding window over a full-length cache
                w = spec.window
                start = min(max(off - w + 1, 0), Smax - w)
                out = attend(q, ck[:, start:start + w], cv[:, start:start + w],
                             q_pos=q_pos,
                             kv_pos=positions(start, w, x.device), window=w,
                             kv_chunk=kv_chunk)
            else:
                out = attend(q, ck, cv, q_pos=q_pos,
                             kv_pos=positions(0, Smax, x.device),
                             window=spec.window, kv_chunk=kv_chunk)

    y = linear(p["wo"], out.reshape(B, S, cfg.n_heads * hd))
    return y, cache
