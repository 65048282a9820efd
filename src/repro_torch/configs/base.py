"""Model and run configuration dataclasses (port of
``src/repro/configs/base.py``, with the same field names and defaults, so
one set of knobs describes a run in both packages).

Every registered architecture is a ``ModelConfig``. Layer heterogeneity
(sliding-window patterns, hybrid attention/mamba interleave, MoE every k
layers) is expressed with ``LayerSpec`` patterns: the stack is ``prefix``
followed by ``pattern`` repeated until ``n_layers`` (a trailing partial
pattern is allowed). ``param_counts`` is the analytic count fig. 4 reports
for the LLM-scale rows; the LLM stack that runs these configurations is
``repro_torch.nn.model`` (serving; its training is ROADMAP.md Queue 1
item 13).

In this port ``ProxyFLConfig.use_pallas=True`` runs the hand-written
kernels of :mod:`repro_torch.kernels` on a CUDA device and their plain
versions on a CPU device the caller chose.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# Layer specification


@dataclass(frozen=True)
class LayerSpec:
    """One decoder layer: token mixer + channel mixer."""

    kind: str = "attn"  # "attn" | "mamba"
    ffn: str = "dense"  # "dense" | "moe" | "none"
    window: Optional[int] = None  # sliding-window size for kind=="attn"
    rope_theta: Optional[float] = None  # per-layer RoPE base override


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 8
    top_k: int = 2
    d_ff_expert: int = 0  # per-expert hidden dim
    n_shared_experts: int = 0  # deepseek-style always-on experts
    dense_residual_d_ff: int = 0  # arctic-style parallel dense MLP
    capacity_factor: float = 1.25
    router_aux_loss_coef: float = 0.01


@dataclass(frozen=True)
class MLAConfig:
    """Multi-head Latent Attention (DeepSeek-V2)."""

    kv_lora_rank: int = 512
    q_lora_rank: int = 1536
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class MambaConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0  # 0 -> ceil(d_model / 16)


@dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    arch_type: str = "dense"  # dense | moe | ssm | hybrid | vlm | audio
    vocab_size: int = 32000
    d_model: int = 512
    n_layers: int = 4
    # attention
    n_heads: int = 8
    n_kv_heads: int = 8
    head_dim: int = 0  # 0 -> d_model // n_heads
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    attn_impl: str = "gqa"  # "gqa" | "mla"
    mla: Optional[MLAConfig] = None
    # ffn
    d_ff: int = 2048
    moe: Optional[MoEConfig] = None
    # ssm
    mamba: Optional[MambaConfig] = None
    # stack layout
    prefix: Tuple[LayerSpec, ...] = ()
    pattern: Tuple[LayerSpec, ...] = (LayerSpec(),)
    # modality
    modality: str = "text"  # text | vlm | audio
    n_codebooks: int = 1  # audio: parallel codebooks
    n_image_tokens: int = 0  # vlm: stub patch-embedding count
    frontend_dim: int = 1024  # vlm: dim of (stubbed) vision-encoder outputs
    # misc
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    dtype: str = "float32"
    # provenance
    source: str = ""

    # -- derived -----------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.n_heads if self.n_heads else 0

    @property
    def d_inner(self) -> int:
        m = self.mamba or MambaConfig()
        return m.expand * self.d_model

    @property
    def resolved_dt_rank(self) -> int:
        m = self.mamba or MambaConfig()
        return m.dt_rank or int(math.ceil(self.d_model / 16))

    def layout(self) -> Tuple[LayerSpec, ...]:
        """Full per-layer spec list of length n_layers."""
        specs = list(self.prefix)
        i = 0
        while len(specs) < self.n_layers:
            specs.append(self.pattern[i % len(self.pattern)])
            i += 1
        return tuple(specs[: self.n_layers])

    def pattern_plan(self) -> Tuple[int, int]:
        """(full pattern repeats, remainder positions) after the prefix."""
        n = self.n_layers - len(self.prefix)
        assert n >= 0
        return n // len(self.pattern), n % len(self.pattern)

    def with_(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # -- parameter count (analytic, for roofline MODEL_FLOPS) ---------------
    def param_counts(self) -> dict:
        """Analytic parameter counts: total and active-per-token."""
        d = self.d_model
        hd = self.resolved_head_dim
        total = 0
        active = 0
        emb = self.vocab_size * d * self.n_codebooks
        head = 0 if self.tie_embeddings else self.vocab_size * d * self.n_codebooks
        total += emb + head
        active += emb + head
        for spec in self.layout():
            t = a = 0
            if spec.kind == "attn":
                if self.attn_impl == "mla":
                    m = self.mla or MLAConfig()
                    qk_head = m.qk_nope_head_dim + m.qk_rope_head_dim
                    t += d * m.q_lora_rank + m.q_lora_rank * self.n_heads * qk_head
                    t += d * (m.kv_lora_rank + m.qk_rope_head_dim)
                    t += m.kv_lora_rank * self.n_heads * (m.qk_nope_head_dim + m.v_head_dim)
                    t += self.n_heads * m.v_head_dim * d
                else:
                    t += d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd
                    t += self.n_heads * hd * d
                a += t
            elif spec.kind == "mamba":
                di, ds, dt = self.d_inner, (self.mamba or MambaConfig()).d_state, self.resolved_dt_rank
                t += d * 2 * di  # in_proj
                t += di * (self.mamba or MambaConfig()).d_conv  # conv
                t += di * (dt + 2 * ds)  # x_proj
                t += dt * di + di  # dt_proj
                t += di * ds + di  # A_log, D
                t += di * d  # out_proj
                a += t
            if spec.ffn == "dense":
                f = 3 * d * self.d_ff
                t += f
                a += f
            elif spec.ffn == "moe":
                mo = self.moe or MoEConfig()
                per_exp = 3 * d * mo.d_ff_expert
                t += mo.n_experts * per_exp + d * mo.n_experts
                a += mo.top_k * per_exp + d * mo.n_experts
                if mo.n_shared_experts:
                    sh = mo.n_shared_experts * per_exp
                    t += sh
                    a += sh
                if mo.dense_residual_d_ff:
                    r = 3 * d * mo.dense_residual_d_ff
                    t += r
                    a += r
            total += t
            active += a
        return {"total": total, "active": active}


# ---------------------------------------------------------------------------
# Input shapes (assigned)


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}


# ---------------------------------------------------------------------------
# ProxyFL protocol configuration (the paper's knobs)


@dataclass(frozen=True)
class DPConfig:
    enabled: bool = True
    clip_norm: float = 1.0  # C
    noise_multiplier: float = 1.0  # sigma
    delta: float = 1e-5
    sample_rate: float = 0.0  # q; 0 -> batch/dataset size at runtime
    vectorized: bool = False  # all units clipped in one contraction (same
    # result; plain torch, it launches no kernel: core/dp.py)


@dataclass(frozen=True)
class ProxyFLConfig:
    alpha: float = 0.5  # private-model DML weight (Eq. 4)
    beta: float = 0.5  # proxy-model DML weight (Eq. 5)
    n_clients: int = 8
    rounds: int = 10
    local_steps: int = 0  # 0 -> one epoch over local data
    lr: float = 1e-3
    weight_decay: float = 1e-4
    batch_size: int = 250
    dp: DPConfig = field(default_factory=DPConfig)
    topology: str = "exponential"  # exponential | ring | full
    seed: int = 0
    dropout_rate: float = 0.0  # §3.4 dropout
    min_active: int = 1
    backend: str = "auto"  # "auto" | "loop" | "vmap" | "async" | "hier"
    staleness: int = 0  # gossip delay τ (async; hier's cross-shard edges)
    n_shards: int = 1  # hier layout: shards of n_clients / n_shards
    use_pallas: bool = False  # hand-written kernels on CUDA
    compress: str = "none"  # "none" | "topk" | "int8" (core/compress.py)
    compress_ratio: float = 0.25  # top-k kept fraction of D
    verify_commitments: bool = False  # check received proxies (loop)
