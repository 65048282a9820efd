"""qwen1.5-4b [dense] — [hf:Qwen/Qwen1.5-0.5B family]

40L d_model=2560 20H (MHA kv=20) d_ff=6912 vocab=151936, QKV bias.
"""
from .base import LayerSpec, ModelConfig
from .registry import register


@register("qwen1.5-4b")
def qwen1_5_4b() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-4b",
        arch_type="dense",
        vocab_size=151936,
        d_model=2560,
        n_layers=40,
        n_heads=20,
        n_kv_heads=20,
        head_dim=128,
        qkv_bias=True,
        d_ff=6912,
        pattern=(LayerSpec(kind="attn", ffn="dense"),),
        rope_theta=1000000.0,
        dtype="bfloat16",
        source="hf:Qwen/Qwen1.5-0.5B",
    )
