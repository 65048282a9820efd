"""jamba-1.5-large-398b [hybrid] — [arXiv:2403.19887]

72L d_model=8192 64H (GQA kv=8) d_ff=24576 vocab=65536, MoE 16e top-2.
Jamba block structure: period of 8 layers with 1 attention : 7 Mamba
(attention at in-block index 4), and MoE replacing the dense MLP on every
second layer (odd in-block indices).
"""
from .base import LayerSpec, MambaConfig, ModelConfig, MoEConfig
from .registry import register


def _slot(i: int) -> LayerSpec:
    kind = "attn" if i == 4 else "mamba"
    ffn = "moe" if i % 2 == 1 else "dense"
    return LayerSpec(kind=kind, ffn=ffn)


@register("jamba-1.5-large-398b")
def jamba_1_5_large_398b() -> ModelConfig:
    return ModelConfig(
        name="jamba-1.5-large-398b",
        arch_type="hybrid",
        vocab_size=65536,
        d_model=8192,
        n_layers=72,
        n_heads=64,
        n_kv_heads=8,
        head_dim=128,
        d_ff=24576,
        moe=MoEConfig(n_experts=16, top_k=2, d_ff_expert=24576, capacity_factor=1.25),
        mamba=MambaConfig(d_state=16, d_conv=4, expand=2, dt_rank=0),
        pattern=tuple(_slot(i) for i in range(8)),
        rope_theta=10000.0,
        dtype="bfloat16",
        source="arXiv:2403.19887",
    )
