"""ProxyFL on PyTorch and CUDA: the port of the JAX package ``repro``.

The layout mirrors ``repro`` module for module (``configs``, ``convert``,
``nn``, ``optim``, ``core``, ``data``, ``kernels``, and ``benchmarks`` for
the figure drivers) so each function has an
obvious counterpart, and the state layout is the reference's: parameter
trees are nested dicts with the same key paths and leaf shapes, flattened
in sorted-key order. The package imports torch, numpy and the standard
library only — never jax and never ``repro``.

Entry points (``core.baselines.run_federated``, ``core.engine.dml_engine``,
``core.engine.single_model_engine``, ``core.engine.FederationEngine``,
``benchmarks.common.bench_methods``) take a ``device``: ``"cuda"`` by default,
where ``use_pallas`` runs the hand-written kernels of :mod:`.kernels`; the
CPU only when the caller asks for it, where the kernels' plain versions
run. A missing GPU is an error, never a silent switch to the CPU.
"""
import torch

# The reference computes in full f32. TF32 would keep ~3 decimal digits in
# matrix products and convolutions on the card, so it is off for the whole
# process from the moment the port is imported.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
# One seed gives one trajectory, as in the reference: cuDNN picks its
# convolution algorithms deterministically instead of by timing them.
torch.backends.cudnn.deterministic = True
torch.backends.cudnn.benchmark = False


def resolve_device(device, *, shapes_only: bool = False) -> torch.device:
    """``device`` as a torch.device; raises when CUDA is asked for and
    absent (the caller must pass ``device="cpu"`` to run on the CPU).
    ``shapes_only`` (a caller that builds shapes: the dry-run) also admits
    ``"meta"``, where nothing is allocated or computed."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: repro_torch runs on the GPU by default; "
            "pass device='cpu' to run the plain versions on the CPU")
    if dev.type not in ("cuda", "cpu") + (("meta",) if shapes_only else ()):
        raise ValueError(f"unsupported device {dev}")
    return dev
