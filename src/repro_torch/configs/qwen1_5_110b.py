"""qwen1.5-110b [dense] — [hf:Qwen/Qwen1.5-0.5B family]

80L d_model=8192 64H (GQA kv=8) d_ff=49152 vocab=152064, QKV bias.
"""
from .base import LayerSpec, ModelConfig
from .registry import register


@register("qwen1.5-110b")
def qwen1_5_110b() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-110b",
        arch_type="dense",
        vocab_size=152064,
        d_model=8192,
        n_layers=80,
        n_heads=64,
        n_kv_heads=8,
        head_dim=128,
        qkv_bias=True,
        d_ff=49152,
        pattern=(LayerSpec(kind="attn", ffn="dense"),),
        rope_theta=1000000.0,
        dtype="bfloat16",
        source="hf:Qwen/Qwen1.5-0.5B",
    )
