"""Decoder layer = pre-norm token mixer (attention, MLA or mamba) +
pre-norm FFN (dense, MoE or none), with residuals (port of
``src/repro/nn/blocks.py``). One (x, cache, aux) interface for every kind,
so the model stack loops over stacked per-layer parameters."""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..configs.base import LayerSpec, ModelConfig
from .attention import apply_attention, init_attention, init_kv_cache
from .mamba import apply_mamba, init_mamba, init_mamba_cache
from .mla import apply_mla, init_mla, init_mla_cache
from .modules import Params, init_mlp, init_rmsnorm, mlp, rmsnorm
from .moe import apply_moe, init_moe


def init_layer(generator: torch.Generator, cfg: ModelConfig, spec: LayerSpec,
               dtype=torch.float32) -> Params:
    p: Params = {"norm1": init_rmsnorm(cfg.d_model, dtype, generator.device)}
    if spec.kind == "attn":
        if cfg.attn_impl == "mla":
            p["mixer"] = init_mla(generator, cfg, dtype)
        else:
            p["mixer"] = init_attention(generator, cfg, dtype)
    elif spec.kind == "mamba":
        p["mixer"] = init_mamba(generator, cfg, dtype)
    else:
        raise ValueError(spec.kind)
    if spec.ffn in ("dense", "moe"):
        p["norm2"] = init_rmsnorm(cfg.d_model, dtype, generator.device)
        p["ffn"] = (init_mlp(generator, cfg.d_model, cfg.d_ff, dtype)
                    if spec.ffn == "dense" else init_moe(generator, cfg, dtype))
    elif spec.ffn != "none":
        raise ValueError(spec.ffn)
    return p


def init_layer_cache(cfg: ModelConfig, spec: LayerSpec, batch: int,
                     max_len: int, dtype=torch.float32,
                     device="cpu") -> Params:
    if spec.kind == "mamba":
        return init_mamba_cache(cfg, batch, dtype, device)
    if cfg.attn_impl == "mla":
        return init_mla_cache(cfg, batch, max_len, dtype, device)
    return init_kv_cache(cfg, batch, max_len, dtype, window=spec.window,
                         device=device)


def apply_layer(
    p: Params,
    cfg: ModelConfig,
    spec: LayerSpec,
    x: torch.Tensor,
    *,
    pos_offset: int = 0,
    cache: Optional[Params] = None,
    kv_chunk: int = 1024,
    mamba_chunk: int = 256,
    use_pallas: bool = True,
) -> Tuple[torch.Tensor, Optional[Params], torch.Tensor]:
    h = rmsnorm(p["norm1"], x, use_pallas=use_pallas)
    if spec.kind == "mamba":
        y, new_cache = apply_mamba(p["mixer"], cfg, h, cache=cache,
                                   chunk=mamba_chunk, use_pallas=use_pallas)
    elif cfg.attn_impl == "mla":
        y, new_cache = apply_mla(p["mixer"], cfg, spec, h,
                                 pos_offset=pos_offset, cache=cache,
                                 kv_chunk=kv_chunk, use_pallas=use_pallas)
    else:
        y, new_cache = apply_attention(p["mixer"], cfg, spec, h,
                                       pos_offset=pos_offset, cache=cache,
                                       kv_chunk=kv_chunk,
                                       use_pallas=use_pallas)
    x = x + y
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if "ffn" in p:
        h = rmsnorm(p["norm2"], x, use_pallas=use_pallas)
        if spec.ffn == "moe":
            y, aux = apply_moe(p["ffn"], cfg, h)
        else:
            y = mlp(p["ffn"], h)
        x = x + y
    return x, new_cache, aux
