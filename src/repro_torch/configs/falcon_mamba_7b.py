"""falcon-mamba-7b [ssm] — [arXiv:2410.05355]

64L d_model=4096, attention-free Mamba-1 blocks (no separate FFN; the Mamba
block is the whole layer), vocab=65024, ssm_state=16, d_inner=2*d_model,
dt_rank=ceil(d_model/16)=256, d_conv=4.
"""
from .base import LayerSpec, MambaConfig, ModelConfig
from .registry import register


@register("falcon-mamba-7b")
def falcon_mamba_7b() -> ModelConfig:
    return ModelConfig(
        name="falcon-mamba-7b",
        arch_type="ssm",
        vocab_size=65024,
        d_model=4096,
        n_layers=64,
        n_heads=0,
        n_kv_heads=0,
        d_ff=0,
        mamba=MambaConfig(d_state=16, d_conv=4, expand=2, dt_rank=0),
        pattern=(LayerSpec(kind="mamba", ffn="none"),),
        dtype="bfloat16",
        source="arXiv:2410.05355",
    )
