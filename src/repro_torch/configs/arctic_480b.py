"""arctic-480b [moe] — [hf:Snowflake/snowflake-arctic-base]

35L d_model=7168 56H (GQA kv=8) d_ff=4864 vocab=32000, MoE 128e top-2,
dense-MoE hybrid: every layer has a (residual) dense MLP in parallel with
the 128-expert top-2 MoE.
"""
from .base import LayerSpec, ModelConfig, MoEConfig
from .registry import register


@register("arctic-480b")
def arctic_480b() -> ModelConfig:
    return ModelConfig(
        name="arctic-480b",
        arch_type="moe",
        vocab_size=32000,
        d_model=7168,
        n_layers=35,
        n_heads=56,
        n_kv_heads=8,
        head_dim=128,
        d_ff=4864,
        moe=MoEConfig(
            n_experts=128,
            top_k=2,
            d_ff_expert=4864,
            dense_residual_d_ff=4864,  # arctic's parallel dense residual MLP
            capacity_factor=1.25,
        ),
        pattern=(LayerSpec(kind="attn", ffn="moe"),),
        rope_theta=10000.0,
        dtype="bfloat16",
        source="hf:Snowflake/snowflake-arctic-base",
    )
