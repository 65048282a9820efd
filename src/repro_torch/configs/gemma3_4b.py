"""gemma3-4b [dense] — [hf:google/gemma-3-1b-pt family]

34L d_model=2560 8H (GQA kv=4, head_dim=256) d_ff=10240 vocab=262144.
5:1 local:global attention — 5 sliding-window (1024) layers per 1 global
layer; local layers use rope_theta=10k, global layers 1M (128k context).
"""
from .base import LayerSpec, ModelConfig
from .registry import register

_LOCAL = LayerSpec(kind="attn", ffn="dense", window=1024, rope_theta=10000.0)
_GLOBAL = LayerSpec(kind="attn", ffn="dense", rope_theta=1000000.0)


@register("gemma3-4b")
def gemma3_4b() -> ModelConfig:
    return ModelConfig(
        name="gemma3-4b",
        arch_type="dense",
        vocab_size=262144,
        d_model=2560,
        n_layers=34,
        n_heads=8,
        n_kv_heads=4,
        head_dim=256,
        d_ff=10240,
        pattern=(_LOCAL, _LOCAL, _LOCAL, _LOCAL, _LOCAL, _GLOBAL),
        rope_theta=1000000.0,
        tie_embeddings=True,
        dtype="bfloat16",
        source="hf:google/gemma-3-1b-pt",
    )
