"""deepseek-v2-236b [moe] — [arXiv:2405.04434]

60L d_model=5120 128H d_ff(expert)=1536 vocab=102400, MoE 160e top-6,
MLA kv_lora=512, 2 shared + 160 routed experts. First layer uses a dense
FFN (intermediate 12288) per the paper; all subsequent layers are MoE.
"""
from .base import LayerSpec, MLAConfig, ModelConfig, MoEConfig
from .registry import register


@register("deepseek-v2-236b")
def deepseek_v2_236b() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-236b",
        arch_type="moe",
        vocab_size=102400,
        d_model=5120,
        n_layers=60,
        n_heads=128,
        n_kv_heads=128,
        attn_impl="mla",
        mla=MLAConfig(
            kv_lora_rank=512,
            q_lora_rank=1536,
            qk_nope_head_dim=128,
            qk_rope_head_dim=64,
            v_head_dim=128,
        ),
        d_ff=12288,  # layer-0 dense MLP (paper table 1)
        moe=MoEConfig(
            n_experts=160,
            top_k=6,
            d_ff_expert=1536,
            n_shared_experts=2,
            capacity_factor=1.25,
        ),
        prefix=(LayerSpec(kind="attn", ffn="dense"),),
        pattern=(LayerSpec(kind="attn", ffn="moe"),),
        rope_theta=10000.0,
        dtype="bfloat16",
        source="arXiv:2405.04434",
    )
