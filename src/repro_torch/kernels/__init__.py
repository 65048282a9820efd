"""Hand-written Hopper kernels, each beside its plain PyTorch version in
:mod:`.ref`: the counterpart of the JAX package's ``repro.kernels`` public
API (every name of its ``__all__``).

Dispatch policy
---------------
A wrapper launches its CUDA kernel (``csrc/*.cu``, built by ``nvcc`` for
``sm_90a`` at first use, see :mod:`._build`) when its tensors lie on a CUDA
device, and runs the plain version only when they lie on the CPU. There is
no fallback: a CUDA tensor the kernel does not take raises.
:func:`default_interpret` and :func:`resolve_interpret` state that policy
where the JAX package chose interpret mode by platform.

Kernel → path map
-----------------
The round hot path (``ProxyFLConfig.use_pallas``):

- :func:`sumsq_rows` / :func:`clip_accumulate_rows` — the clip and
  accumulate of DP-SGD over the ``[B, D]`` per-example gradients, one
  launch each per step (``repro_torch.core.dp``): the ``"rows"`` route of
  :func:`sumsq` and :func:`scale_accumulate`.
- :func:`scale_accumulate` — the noise add of ``dp_gradient`` (its 1-D
  ``"vector"`` route).
- :func:`noise_adam_step` — noise add, clipped mean, weight decay and Adam
  in one pass (``repro_torch.core.dp.dp_adam_update``).
- :func:`fused_pushsum_mix` — the de-biased PushSum exchange
  (``repro_torch.core.gossip.pushsum_mix_debiased``).
- :func:`fused_pushsum_mix_blocks` — the hier backend's intra-shard mix,
  S shards' [L, L] blocks in one launch of the mix kernel on a shard grid
  (``repro_torch.core.gossip.hier_mix_debiased``,
  ``hier_stale_mix_apply``).
- :func:`fused_stale_mix` — the async backend's stale exchange at
  staleness τ>0: re-bias, send, merge the delayed delivery, de-bias
  (``repro_torch.core.gossip.stale_mix_apply``).

The LLM serving path (``repro_torch.nn.model`` with ``use_pallas``, where
the reference's model calls no kernel):

- :func:`rmsnorm` — every RMSNorm of the model (each layer's two, MLA's
  latent norms, the final norm), in prefill and decode.
- :func:`gqa_flash_attention` — GQA/MHA attention of a block of fresh
  tokens at position 0 (the no-cache forward and a prefill).
- :func:`mamba_scan` — the selective scan of a mamba block of more than
  one token, from the cache's state, with its final state out.

The ops API (:mod:`.ops`; no training path calls these):

- :func:`noise_sgd_step` — noise add, clipped mean, weight decay and SGD
  in one pass.
- :func:`clip_accumulate` / :func:`tree_clip_accumulate` — Eq. (7) clip
  and accumulate on a flat vector or a parameter tree (``sumsq`` then
  ``scale_accumulate``; no kernel of their own).
- :func:`rmsnorm`, :func:`flash_attention` / :func:`gqa_flash_attention`
  and :func:`mamba_scan` as standalone kernels. Attention has two,
  both on the tensor cores at every head dim ≤ 256: bf16 on wgmma and f32
  on mma.sync in split TF32 (compiled at D ∈ {64, 128, 256}, the
  split-TF32 kernel also at 96, and zero-padded up to the next of them);
  ``flash_attention.flash_route`` picks by dtype, and
  ``flash_attention.flash_copy_width`` picks each kernel's loader by
  alignment: 16-byte copies (TMA, cp.async) where every base, stride and
  row is 16-byte aligned, else the narrow loader (8-, 4- or 2-byte
  copies). All count as ``flash_attention`` launches. RMSNorm has a vector
  (16-byte) and a scalar instantiation, picked by alignment
  (``rmsnorm.rmsnorm_route``).

Each wrapper counts its kernel launches in a plain integer attribute
``launches``; :func:`launch_counts` and :func:`reset_launch_counts` read and
clear them all. Attention, RMSNorm, ``sumsq`` and ``scale_accumulate`` also
count by route (``route_launches``), read by :func:`route_launch_counts`.
"""
from typing import Dict, Optional

import torch

from . import ref
from .dp_clip import (clip_accumulate, clip_accumulate_rows,
                      scale_accumulate, sumsq, sumsq_rows)
from .dp_step import noise_adam_step, noise_sgd_step
from .flash_attention import flash_attention
from .mamba_scan import mamba_scan
from .ops import gqa_flash_attention, tree_clip_accumulate
from .pushsum_mix import (fused_pushsum_mix, fused_pushsum_mix_blocks,
                          fused_stale_mix)
from .rmsnorm import rmsnorm

KERNELS = {
    "sumsq": sumsq,
    "scale_accumulate": scale_accumulate,
    "noise_sgd_step": noise_sgd_step,
    "noise_adam_step": noise_adam_step,
    "fused_pushsum_mix": fused_pushsum_mix,
    "fused_pushsum_mix_blocks": fused_pushsum_mix_blocks,
    "fused_stale_mix": fused_stale_mix,
    "rmsnorm": rmsnorm,
    "flash_attention": flash_attention,
    "mamba_scan": mamba_scan,
}
# wrappers with more than one kernel or launch shape
ROUTED = (flash_attention, rmsnorm, sumsq, scale_accumulate)


def default_interpret(device="cuda") -> bool:
    """Whether a wrapper runs the plain version (True: tensors on the CPU)
    or launches its kernel (False: tensors on a CUDA device) — the port's
    counterpart of the reference's platform default for interpret mode."""
    dev = torch.device(device)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev.type == "cpu"


def resolve_interpret(interpret: Optional[bool], device="cuda") -> bool:
    """``None`` -> :func:`default_interpret`; an explicit bool must agree
    with the device, since the device alone decides (no fallback)."""
    default = default_interpret(device)
    if interpret is not None and bool(interpret) != default:
        raise ValueError(
            f"interpret={interpret} on {torch.device(device)}: the plain "
            "versions run only on CPU tensors and the kernels only on CUDA "
            "tensors")
    return default


def launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}


def route_launch_counts() -> Dict[str, int]:
    """Launches by route: ``flash_attention/<route>``,
    ``rmsnorm/<route>``, ``sumsq/<route>`` and
    ``scale_accumulate/<route>``."""
    return {f"{fn.__name__}/{route}": n for fn in ROUTED
            for route, n in fn.route_launches.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
    for fn in ROUTED:
        fn.route_launches = dict.fromkeys(fn.route_launches, 0)


__all__ = [
    "ref",
    "default_interpret",
    "resolve_interpret",
    "clip_accumulate",
    "clip_accumulate_rows",
    "flash_attention",
    "fused_pushsum_mix",
    "fused_pushsum_mix_blocks",
    "fused_stale_mix",
    "gqa_flash_attention",
    "mamba_scan",
    "noise_adam_step",
    "noise_sgd_step",
    "scale_accumulate",
    "sumsq",
    "sumsq_rows",
    "tree_clip_accumulate",
    "rmsnorm",
    "KERNELS",
    "launch_counts",
    "route_launch_counts",
    "reset_launch_counts",
]
