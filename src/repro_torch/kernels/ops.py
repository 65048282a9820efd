"""The public kernel API, the counterpart of ``repro.kernels.ops``: grouped
query attention on the model layout and pytree-level DP clipping built on
the flat kernels, beside re-exports of the rest."""
from __future__ import annotations

import torch

from ..nn.modules import tree_flatten_vector, tree_unflatten_vector
from . import _build
from .dp_clip import clip_accumulate, scale_accumulate, sumsq
from .flash_attention import attention, check_attention, flash_attention
from .mamba_scan import mamba_scan
from .rmsnorm import rmsnorm


def gqa_flash_attention(q, k, v, *, causal=True, window=None, scale=None,
                        block_q=128, block_k=128):
    """q: [B, S, Hq, D]; k/v: [B, S, Hkv, D] (model-stack layout), Hkv
    dividing Hq. On the CPU the KV heads are repeated and the [B, H, S, D]
    plain version runs; on CUDA the kernel reads KV head h // (Hq/Hkv) and
    the model layout in place (no repeat, no transpose). Under
    ``torch.func.vmap`` the vmapped dim is folded into B: one launch."""
    check_attention("gqa_flash_attention", q, k, v, head_axis=2)
    if block_q < 1 or block_k < 1:
        raise ValueError("gqa_flash_attention: block sizes must be >= 1")
    scale = float(scale if scale is not None else q.shape[3] ** -0.5)
    _build.refuse_grad("gqa_flash_attention", q, k, v)
    return attention(q, k, v, head_axis=2, causal=causal, window=window,
                     scale=scale)


def tree_clip_accumulate(acc_tree, grad_tree, clip_norm: float):
    """Eq. (7) clip+accumulate on whole parameter trees via the flat
    kernels (norm over ALL leaves jointly, as DP-SGD requires)."""
    flat_g = tree_flatten_vector(grad_tree)
    flat_a = tree_flatten_vector(acc_tree).to(torch.float32)
    out = clip_accumulate(flat_a, flat_g, float(clip_norm))
    return tree_unflatten_vector(out, acc_tree)


__all__ = [
    "flash_attention",
    "gqa_flash_attention",
    "mamba_scan",
    "rmsnorm",
    "sumsq",
    "scale_accumulate",
    "clip_accumulate",
    "tree_clip_accumulate",
]
