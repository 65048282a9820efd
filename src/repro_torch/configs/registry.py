"""Architecture registry.

Every assigned architecture registers a ``ModelConfig`` factory here, keyed
by its public id (``--arch <id>``). ``proxy_of`` derives the common proxy
architecture all ProxyFL clients agree on (paper §3.1: "all clients agree on
a common proxy model architecture"; "the proxy model is generally smaller
than the private model").
"""
from __future__ import annotations

from typing import Callable, Dict, List

from .base import LayerSpec, ModelConfig

_REGISTRY: Dict[str, Callable[[], ModelConfig]] = {}


def register(name: str):
    def deco(fn: Callable[[], ModelConfig]):
        _REGISTRY[name] = fn
        return fn

    return deco


def get_config(name: str) -> ModelConfig:
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]()


def list_archs() -> List[str]:
    return sorted(_REGISTRY)


def proxy_of(private: ModelConfig, *, n_layers: int = 4, d_model: int = 512) -> ModelConfig:
    """The common proxy architecture for a federation whose task matches
    ``private``'s input/output spaces (same vocab / modality / codebooks)."""
    return ModelConfig(
        name=f"proxy-of-{private.name}",
        arch_type="dense",
        vocab_size=private.vocab_size,
        d_model=d_model,
        n_layers=n_layers,
        n_heads=8,
        n_kv_heads=8,
        head_dim=d_model // 8,
        d_ff=4 * d_model,
        pattern=(LayerSpec(kind="attn", ffn="dense"),),
        modality=private.modality,
        n_codebooks=private.n_codebooks,
        n_image_tokens=private.n_image_tokens,
        tie_embeddings=True,
        dtype=private.dtype,
        source="ProxyFL common proxy spec",
    )


def smoke_variant(cfg: ModelConfig) -> ModelConfig:
    """Reduced same-family variant: 2 layers, d_model<=512, <=4 experts."""
    kw: dict = dict(
        n_layers=max(2, len(cfg.prefix) + (1 if len(cfg.prefix) < 2 else 0)),
        d_model=256,
        n_heads=4,
        n_kv_heads=min(4, cfg.n_kv_heads) if cfg.n_kv_heads else 0,
        head_dim=64,
        d_ff=512 if cfg.d_ff else 0,
        vocab_size=512,
    )
    # keep the pattern structure but cover >=1 full pattern when cheap
    kw["n_layers"] = max(2, len(cfg.prefix) + len(cfg.pattern))
    if kw["n_layers"] > 10:  # long patterns (jamba): truncate to 2 pattern slots
        kw["n_layers"] = len(cfg.prefix) + 2
    if cfg.moe is not None:
        kw["moe"] = cfg.moe.__class__(
            n_experts=4,
            top_k=min(2, cfg.moe.top_k),
            d_ff_expert=256,
            n_shared_experts=min(1, cfg.moe.n_shared_experts),
            dense_residual_d_ff=256 if cfg.moe.dense_residual_d_ff else 0,
        )
    if cfg.mla is not None:
        kw["mla"] = cfg.mla.__class__(
            kv_lora_rank=64, q_lora_rank=96, qk_nope_head_dim=32,
            qk_rope_head_dim=16, v_head_dim=32,
        )
    if cfg.mamba is not None:
        kw["mamba"] = cfg.mamba.__class__(d_state=8, d_conv=4, expand=2, dt_rank=16)
    if cfg.n_image_tokens:
        kw["n_image_tokens"] = 16
    # shrink sliding windows so they are exercised at smoke seq lens
    def shrink(spec: LayerSpec) -> LayerSpec:
        if spec.window:
            return LayerSpec(kind=spec.kind, ffn=spec.ffn, window=8, rope_theta=spec.rope_theta)
        return spec

    kw["prefix"] = tuple(shrink(s) for s in cfg.prefix)
    kw["pattern"] = tuple(shrink(s) for s in cfg.pattern)
    return cfg.with_(name=cfg.name + "-smoke", **kw)
