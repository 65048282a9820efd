"""Hand-written Hopper kernels of the round hot path, each beside its plain
PyTorch version in :mod:`.ref`.

Dispatch policy
---------------
A wrapper launches its CUDA kernel (``csrc/*.cu``, built by ``nvcc`` for
``sm_90a`` at first use, see :mod:`._build`) when its tensors lie on a CUDA
device, and runs the plain version only when they lie on the CPU. There is
no fallback: a CUDA tensor the kernel does not take raises.

Kernel → path map (the ``ProxyFLConfig.use_pallas`` path)
---------------------------------------------------------
- :func:`sumsq` / :func:`scale_accumulate` — per-example clip and
  accumulate of DP-SGD (``repro_torch.core.dp``).
- :func:`noise_adam_step` — noise add, clipped mean, weight decay and Adam
  in one pass (``repro_torch.core.dp.dp_adam_update``).
- :func:`fused_pushsum_mix` — the de-biased PushSum exchange
  (``repro_torch.core.gossip.pushsum_mix_debiased``).
- :func:`fused_stale_mix` — the async backend's stale exchange at
  staleness τ>0: re-bias, send, merge the delayed delivery, de-bias
  (``repro_torch.core.gossip.stale_mix_apply``).

Each wrapper counts its kernel launches in a plain integer attribute
``launches``; :func:`launch_counts` and :func:`reset_launch_counts` read and
clear them all.
"""
from typing import Dict

from . import ref
from .dp_clip import scale_accumulate, sumsq
from .dp_step import noise_adam_step
from .pushsum_mix import fused_pushsum_mix, fused_stale_mix

KERNELS = {
    "sumsq": sumsq,
    "scale_accumulate": scale_accumulate,
    "noise_adam_step": noise_adam_step,
    "fused_pushsum_mix": fused_pushsum_mix,
    "fused_stale_mix": fused_stale_mix,
}


def launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


__all__ = ["KERNELS", "fused_pushsum_mix", "fused_stale_mix", "launch_counts",
           "noise_adam_step", "ref", "reset_launch_counts",
           "scale_accumulate", "sumsq"]
