"""phi-3-vision-4.2b [vlm] — [hf:microsoft/Phi-3-vision-128k-instruct]

32L d_model=3072 32H (GQA kv=32) d_ff=8192 vocab=32064.
phi3-mini text backbone + CLIP ViT frontend. The vision encoder is a STUB
per the task carve-out: ``input_specs()`` feeds precomputed patch
embeddings of shape [B, n_image_tokens, d_model].
"""
from .base import LayerSpec, ModelConfig
from .registry import register


@register("phi-3-vision-4.2b")
def phi_3_vision_4_2b() -> ModelConfig:
    return ModelConfig(
        name="phi-3-vision-4.2b",
        arch_type="vlm",
        modality="vlm",
        vocab_size=32064,
        d_model=3072,
        n_layers=32,
        n_heads=32,
        n_kv_heads=32,
        head_dim=96,
        d_ff=8192,
        n_image_tokens=576,  # CLIP ViT-L/14 @336px -> 24x24 patches
        pattern=(LayerSpec(kind="attn", ffn="dense"),),
        rope_theta=10000.0,
        dtype="bfloat16",
        source="hf:microsoft/Phi-3-vision-128k-instruct",
    )
