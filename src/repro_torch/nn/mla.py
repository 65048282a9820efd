"""Multi-head Latent Attention (DeepSeek-V2, arXiv:2405.04434; port of
``src/repro/nn/mla.py``).

K/V are compressed to a per-token latent ``c_kv`` (rank ``kv_lora_rank``)
plus one shared RoPE key head; only ``(c_kv, k_rope)`` is cached. Prefill
expands per-head K/V from the latent and attends; decode uses the
*absorbed* form: queries are pushed through W_uk into latent space, so
attention runs against the compressed cache directly. Both attends are the
model's own :func:`~.attention.attend` (q/k head dim 192 against v 128 in
prefill: no kernel of the port takes it); with ``use_pallas`` the two
latent norms run the RMSNorm kernel.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..configs.base import LayerSpec, MLAConfig, ModelConfig
from .attention import attend, positions
from .modules import (Params, apply_rope, init_linear, init_rmsnorm, linear,
                      rmsnorm)


def init_mla(generator: torch.Generator, cfg: ModelConfig,
             dtype=torch.float32) -> Params:
    m = cfg.mla or MLAConfig()
    d, H = cfg.d_model, cfg.n_heads
    qk_head = m.qk_nope_head_dim + m.qk_rope_head_dim
    dev = generator.device
    return {
        "wdq": init_linear(generator, d, m.q_lora_rank, dtype=dtype),
        "q_norm": init_rmsnorm(m.q_lora_rank, dtype, dev),
        "wuq": init_linear(generator, m.q_lora_rank, H * qk_head, dtype=dtype),
        # joint down-proj: [c_kv | k_rope]
        "wdkv": init_linear(generator, d, m.kv_lora_rank + m.qk_rope_head_dim,
                            dtype=dtype),
        "kv_norm": init_rmsnorm(m.kv_lora_rank, dtype, dev),
        "wuk": init_linear(generator, m.kv_lora_rank, H * m.qk_nope_head_dim,
                           dtype=dtype),
        "wuv": init_linear(generator, m.kv_lora_rank, H * m.v_head_dim,
                           dtype=dtype),
        "wo": init_linear(generator, H * m.v_head_dim, d, dtype=dtype),
    }


def init_mla_cache(cfg: ModelConfig, batch: int, max_len: int,
                   dtype=torch.float32, device="cpu") -> Params:
    m = cfg.mla or MLAConfig()
    return {
        "ckv": torch.zeros((batch, max_len, m.kv_lora_rank), dtype=dtype,
                           device=device),
        "kr": torch.zeros((batch, max_len, m.qk_rope_head_dim), dtype=dtype,
                          device=device),
    }


def _project_q(p, cfg: ModelConfig, m: MLAConfig, x, q_pos, theta,
               use_pallas):
    B, S, _ = x.shape
    H = cfg.n_heads
    qk_head = m.qk_nope_head_dim + m.qk_rope_head_dim
    q = linear(p["wuq"], rmsnorm(p["q_norm"], linear(p["wdq"], x),
                                 use_pallas=use_pallas))
    q = q.reshape(B, S, H, qk_head)
    q_nope, q_rope = q[..., :m.qk_nope_head_dim], q[..., m.qk_nope_head_dim:]
    q_rope = apply_rope(q_rope, q_pos, theta)
    return q_nope, q_rope


def _project_kv_latent(p, m: MLAConfig, x, kv_pos, theta, use_pallas):
    dkv = linear(p["wdkv"], x)
    ckv = rmsnorm(p["kv_norm"], dkv[..., :m.kv_lora_rank],
                  use_pallas=use_pallas)
    kr = dkv[..., m.kv_lora_rank:]
    kr = apply_rope(kr[:, :, None, :], kv_pos, theta)[:, :, 0, :]  # shared head
    return ckv, kr


def _expanded_attend(p, cfg, m, q_nope, q_rope, ckv, kr, q_pos, kv_pos,
                     kv_chunk):
    """Prefill path: expand per-head K/V from the latent, then attend."""
    B, Sk = ckv.shape[0], ckv.shape[1]
    H = cfg.n_heads
    k_nope = linear(p["wuk"], ckv).reshape(B, Sk, H, m.qk_nope_head_dim)
    vfull = linear(p["wuv"], ckv).reshape(B, Sk, H, m.v_head_dim)
    k = torch.cat([k_nope, kr[:, :, None, :].expand(
        B, Sk, H, m.qk_rope_head_dim)], dim=-1)
    q = torch.cat([q_nope, q_rope], dim=-1)
    scale = (m.qk_nope_head_dim + m.qk_rope_head_dim) ** -0.5
    return attend(q, k, vfull, q_pos=q_pos, kv_pos=kv_pos, kv_chunk=kv_chunk,
                  scale=scale)


def _absorbed_attend(p, cfg, m, q_nope, q_rope, ckv, kr, q_pos, kv_pos,
                     kv_chunk):
    """Decode path: attention in latent space against the compressed
    cache."""
    H = cfg.n_heads
    wuk = p["wuk"]["w"].reshape(m.kv_lora_rank, H, m.qk_nope_head_dim)
    q_lat = torch.einsum("bshd,rhd->bshr", q_nope, wuk)   # absorb W_uk into q
    q_cat = torch.cat([q_lat, q_rope], dim=-1)   # [B, Sq, H, r + rope]
    k_cat = torch.cat([ckv, kr], dim=-1)[:, :, None, :]   # Hkv = 1
    v_lat = ckv[:, :, None, :]
    scale = (m.qk_nope_head_dim + m.qk_rope_head_dim) ** -0.5
    o_lat = attend(q_cat, k_cat, v_lat, q_pos=q_pos, kv_pos=kv_pos,
                   kv_chunk=kv_chunk, scale=scale)
    wuv = p["wuv"]["w"].reshape(m.kv_lora_rank, H, m.v_head_dim)
    return torch.einsum("bshr,rhd->bshd", o_lat, wuv)


def apply_mla(
    p: Params,
    cfg: ModelConfig,
    spec: LayerSpec,
    x: torch.Tensor,
    *,
    pos_offset: int = 0,
    cache: Optional[Params] = None,
    kv_chunk: int = 1024,
    use_pallas: bool = True,
) -> Tuple[torch.Tensor, Optional[Params]]:
    """Returns the output and the cache (the same dict, the new latents
    written at ``pos_offset``)."""
    m = cfg.mla or MLAConfig()
    B, S, _ = x.shape
    H = cfg.n_heads
    theta = spec.rope_theta or cfg.rope_theta
    off = int(pos_offset)
    q_pos = positions(off, S, x.device)
    q_nope, q_rope = _project_q(p, cfg, m, x, q_pos, theta, use_pallas)
    ckv, kr = _project_kv_latent(p, m, x, q_pos, theta, use_pallas)

    if cache is None:
        out = _expanded_attend(p, cfg, m, q_nope, q_rope, ckv, kr, q_pos,
                               q_pos, kv_chunk)
    else:
        cc, cr = cache["ckv"], cache["kr"]
        cc[:, off:off + S] = ckv.to(cc.dtype)
        cr[:, off:off + S] = kr.to(cr.dtype)
        kv_pos = positions(0, cc.shape[1], x.device)
        attend_fn = _absorbed_attend if S == 1 else _expanded_attend
        out = attend_fn(p, cfg, m, q_nope, q_rope, cc, cr, q_pos, kv_pos,
                        kv_chunk)

    y = linear(p["wo"], out.reshape(B, S, H * m.v_head_dim))
    return y, cache
