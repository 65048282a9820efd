"""Basic building blocks and parameter-tree utilities (port of
``src/repro/nn/modules.py``): initializers, linear, RMSNorm, embedding,
RoPE and the gated MLP of the LLM stack.

Parameters are nested dicts of tensors with the reference's key paths and
leaf shapes; a linear weight is ``[d_in, d_out]`` and applies as ``x @ w``.
An initializer draws from an explicit ``torch.Generator`` on the device the
generator lives on (threefry and Philox draws cannot match, so a run that
must start from the reference's numbers converts them instead:
:mod:`repro_torch.convert`).
Leaves are visited as ``jax.tree_util`` visits a nested dict — keys sorted
at every level — so :func:`tree_flatten_vector` gives the same ``[D]`` wire
vector as the reference (for ``mlp``: fc1/b, fc1/w, fc2/b, fc2/w, fc3/b,
fc3/w).
"""
from __future__ import annotations

from typing import Any, Callable, List, Optional

import torch

Params = dict


def _children(tree) -> Optional[List]:
    """The ordered subtrees of a container node, or None for a leaf. Dicts
    go in sorted-key order, tuples (NamedTuples included) and lists in
    order; None is an empty subtree, as in jax.tree_util."""
    if isinstance(tree, dict):
        return [tree[k] for k in sorted(tree)]
    if isinstance(tree, (tuple, list)):
        return list(tree)
    return None


def tree_leaves(tree) -> List[torch.Tensor]:
    if tree is None:
        return []
    kids = _children(tree)
    if kids is None:
        return [tree]
    return [leaf for kid in kids for leaf in tree_leaves(kid)]


def tree_map(fn: Callable, tree, *rest) -> Any:
    """``fn`` over the leaves of ``tree`` (and the matching leaves of
    ``rest``), keeping the structure: dicts, tuples, NamedTuples, lists.
    Leaves are visited in :func:`tree_leaves` order."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, (tuple, list)):
        out = [tree_map(fn, t, *(r[i] for r in rest))
               for i, t in enumerate(tree)]
        return type(tree)(*out) if hasattr(tree, "_fields") else type(tree)(out)
    return fn(tree, *rest)


def torch_dtype(name) -> torch.dtype:
    """A configuration's dtype name (``"float32"``, ``"bfloat16"``) as a
    torch dtype; a torch dtype passes through."""
    return name if isinstance(name, torch.dtype) else getattr(torch, name)


# ---------------------------------------------------------------------------
# Initializers


def normal_init(generator: torch.Generator, shape, scale: float = 0.02,
                dtype=torch.float32) -> torch.Tensor:
    return scale * torch.randn(tuple(shape), generator=generator, dtype=dtype,
                               device=generator.device)


def zeros_init(generator: torch.Generator, shape,
               dtype=torch.float32) -> torch.Tensor:
    return torch.zeros(tuple(shape), dtype=dtype, device=generator.device)


# ---------------------------------------------------------------------------
# Linear


def init_linear(generator: torch.Generator, d_in: int, d_out: int,
                bias: bool = False, scale: float = 0.02,
                dtype=torch.float32) -> Params:
    p = {"w": normal_init(generator, (d_in, d_out), scale, dtype)}
    if bias:
        p["b"] = zeros_init(generator, (d_out,), dtype)
    return p


def linear(p: Params, x: torch.Tensor) -> torch.Tensor:
    y = x @ p["w"]
    if "b" in p:
        y = y + p["b"]
    return y


# ---------------------------------------------------------------------------
# RMSNorm


def init_rmsnorm(d: int, dtype=torch.float32, device="cpu") -> Params:
    return {"g": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm(p: Params, x: torch.Tensor, eps: float = 1e-6,
            use_pallas: bool = True) -> torch.Tensor:
    """The model's RMSNorm: normalised in f32, rounded to x's dtype, then
    times the gain. With ``use_pallas`` the kernel wrapper
    (``kernels.rmsnorm``) runs instead: on a CUDA tensor the kernel of
    ``csrc/rmsnorm.cu``, on a CPU tensor its plain version. Both apply the
    gain in f32 and round once, so in bf16 they differ from this path by up
    to one bf16 rounding (in f32 by an ulp)."""
    if use_pallas:
        # imported here: kernels.ops imports this module
        from ..kernels.rmsnorm import rmsnorm as rmsnorm_kernel
        return rmsnorm_kernel(x.contiguous(), p["g"], eps=eps)
    dt = x.dtype
    x32 = x.to(torch.float32)
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(dt) * p["g"]


# ---------------------------------------------------------------------------
# Embedding


def init_embedding(generator: torch.Generator, vocab: int, d: int,
                   scale: float = 0.02, dtype=torch.float32) -> Params:
    return {"e": normal_init(generator, (vocab, d), scale, dtype)}


def embed(p: Params, ids: torch.Tensor) -> torch.Tensor:
    return p["e"][ids]


def unembed(p: Params, x: torch.Tensor) -> torch.Tensor:
    return x @ p["e"].T


# ---------------------------------------------------------------------------
# RoPE


def rope_freqs(head_dim: int, theta: float, device="cpu") -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    # A CUDA graph cannot hold a copy from the host, so a capture fills the
    # base on the device. Elsewhere it stays a copy, which waits for the
    # device: without that wait qwen2-7b's and phi-3-vision's prefills ran
    # 30-40% slower on an H100 (the plain path too), by a cause not yet
    # measured.
    if torch.device(device).type == "cuda" \
            and torch.cuda.is_current_stream_capturing():
        base = torch.full((), theta, dtype=torch.float32, device=device)
    else:
        base = torch.tensor(theta, dtype=torch.float32, device=device)
    return 1.0 / torch.pow(base, exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [..., S, H, D]; positions: [..., S] (broadcastable). The angles
    and rotation in f32, the result in x's dtype."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)   # [D/2]
    ang = positions[..., :, None, None].to(torch.float32) * freqs
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., 0::2], x[..., 1::2]
    out1 = x1 * cos - x2 * sin
    out2 = x2 * cos + x1 * sin
    out = torch.stack([out1, out2], dim=-1).reshape(x.shape)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Gated MLP (SwiGLU), the dense FFN of every registered architecture


def init_mlp(generator: torch.Generator, d_model: int, d_ff: int,
             dtype=torch.float32) -> Params:
    return {
        "gate": init_linear(generator, d_model, d_ff, dtype=dtype),
        "up": init_linear(generator, d_model, d_ff, dtype=dtype),
        "down": init_linear(generator, d_ff, d_model, dtype=dtype),
    }


def mlp(p: Params, x: torch.Tensor) -> torch.Tensor:
    return linear(p["down"], torch.nn.functional.silu(linear(p["gate"], x))
                  * linear(p["up"], x))


# ---------------------------------------------------------------------------
# Parameter-tree utilities


def tree_size(tree) -> int:
    return sum(int(x.numel()) for x in tree_leaves(tree))


def tree_bytes(tree) -> int:
    return sum(int(x.numel() * x.element_size()) for x in tree_leaves(tree))


def tree_flatten_vector(tree) -> torch.Tensor:
    """Concatenate every leaf into one 1-D vector (proxy wire format)."""
    leaves = tree_leaves(tree)
    if not leaves:
        return torch.zeros((0,))
    return torch.cat([x.reshape(-1) for x in leaves])


def tree_unflatten_vector(vec: torch.Tensor, like) -> Any:
    """Inverse of :func:`tree_flatten_vector` against the structure, shapes
    and dtypes of ``like``."""
    pieces = iter(torch.split(vec, [x.numel() for x in tree_leaves(like)]))
    return tree_map(
        lambda leaf: next(pieces).reshape(leaf.shape).to(leaf.dtype), like)


def tree_global_norm(tree) -> torch.Tensor:
    leaves = tree_leaves(tree)
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in leaves))
