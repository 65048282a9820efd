"""qwen2-7b [dense] — [arXiv:2407.10671]

28L d_model=3584 28H (GQA kv=4) d_ff=18944 vocab=152064, QKV bias.
"""
from .base import LayerSpec, ModelConfig
from .registry import register


@register("qwen2-7b")
def qwen2_7b() -> ModelConfig:
    return ModelConfig(
        name="qwen2-7b",
        arch_type="dense",
        vocab_size=152064,
        d_model=3584,
        n_layers=28,
        n_heads=28,
        n_kv_heads=4,
        head_dim=128,
        qkv_bias=True,
        d_ff=18944,
        pattern=(LayerSpec(kind="attn", ffn="dense"),),
        rope_theta=1000000.0,
        dtype="bfloat16",
        source="arXiv:2407.10671",
    )


@register("qwen2-7b-swa")
def qwen2_7b_swa() -> ModelConfig:
    """Beyond-paper variant: sliding-window (4096) attention on 27/28 layers
    so the dense family can exercise the long_500k decode shape."""
    base = qwen2_7b()
    return base.with_(
        name="qwen2-7b-swa",
        prefix=(LayerSpec(kind="attn", ffn="dense"),),  # one global layer
        pattern=(LayerSpec(kind="attn", ffn="dense", window=4096),),
        source="arXiv:2407.10671 (+SWA override, ours)",
    )
