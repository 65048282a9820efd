"""musicgen-medium [audio] — [arXiv:2306.05284]

48L d_model=1536 24H (MHA kv=24) d_ff=6144 vocab=2048. Decoder-only
transformer over EnCodec RVQ tokens: 4 parallel codebooks (delay pattern),
embeddings summed at the input, 4 parallel LM heads at the output.
The EnCodec conv codec frontend is a STUB per the task carve-out.
"""
from .base import LayerSpec, ModelConfig
from .registry import register


@register("musicgen-medium")
def musicgen_medium() -> ModelConfig:
    return ModelConfig(
        name="musicgen-medium",
        arch_type="audio",
        modality="audio",
        vocab_size=2048,
        d_model=1536,
        n_layers=48,
        n_heads=24,
        n_kv_heads=24,
        head_dim=64,
        d_ff=6144,
        n_codebooks=4,
        pattern=(LayerSpec(kind="attn", ffn="dense"),),
        rope_theta=10000.0,
        dtype="bfloat16",
        source="arXiv:2306.05284",
    )
