"""Basic building blocks and parameter-tree utilities (port of
``src/repro/nn/modules.py``): initializers, linear, RMSNorm, embedding,
RoPE and the gated MLP of the LLM stack.

Parameters are nested dicts of tensors with the reference's key paths and
leaf shapes; a linear weight is ``[d_in, d_out]`` and applies as ``x @ w``.
An initializer draws from an explicit ``torch.Generator`` on the device the
generator lives on (threefry and Philox draws cannot match, so a run that
must start from the reference's numbers converts them instead:
:mod:`repro_torch.convert`).
A :class:`ShapeOnly` in place of the generator draws nothing: the
initializers then build empty leaves on the ``meta`` device by the same
layout code (the dry-run's shapes, where the reference calls
``jax.eval_shape``).
Leaves are visited as ``jax.tree_util`` visits a nested dict — keys sorted
at every level — so :func:`tree_flatten_vector` gives the same ``[D]`` wire
vector as the reference (for ``mlp``: fc1/b, fc1/w, fc2/b, fc2/w, fc3/b,
fc3/w).
"""
from __future__ import annotations

import contextlib
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


class ShapeOnly:
    """Stands in for a ``torch.Generator`` where only shapes are wanted:
    an initializer given it draws nothing and returns an empty leaf of the
    right shape and dtype on the ``meta`` device (which has no
    generator)."""

    device = torch.device("meta")


def normal_init(generator: torch.Generator, shape, scale: float = 0.02,
                dtype=torch.float32) -> torch.Tensor:
    if generator.device.type == "meta":
        return torch.empty(tuple(shape), dtype=dtype, device="meta")
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


# the weights whose products :func:`linear` leaves uncomputed (see
# :func:`lazy_linears`)
_lazy_weights: tuple = ()


@contextlib.contextmanager
def lazy_linears(weights):
    """Within the context, :func:`linear` with one of ``weights`` (matched
    by identity) computes only its backward: the forward's product is left
    unwritten (:class:`_LazyMatmul`). A rematerialized layer runs its last
    projections so (``nn.model``), whose outputs only add into the
    residual stream and so are needed by no gradient, as the reference's
    ``jax.checkpoint`` drops them from its recompute."""
    global _lazy_weights
    old, _lazy_weights = _lazy_weights, tuple(weights)
    try:
        yield
    finally:
        _lazy_weights = old


def _mm_mat1_backward(g, w, x):
    # autograd's gradient of mm's first operand (its branch by x's layout)
    if x.stride(0) == 1 and x.stride(1) == x.shape[0]:
        return w.mm(g.t()).t()
    return g.mm(w.t())


def _mm_mat2_backward(g, x, w):
    # autograd's gradient of mm's second operand (its branch by w's layout)
    if w.stride(0) == 1 and w.stride(1) == w.shape[0]:
        return g.t().mm(x).t()
    return x.t().mm(g)


class _LazyMatmul(torch.autograd.Function):
    """``x @ w`` (w [d_in, d_out]) whose forward writes nothing: its
    output is an uninitialized tensor of the product's shape, and its
    backward is autograd's for the product (x folded to [N, d_in] and the
    two ``mm`` gradients, so the gradients are bit-equal to those of
    ``x @ w``). For an output no gradient reads."""

    generate_vmap_rule = True

    @staticmethod
    def forward(x, w):
        return x.new_empty(tuple(x.shape[:-1]) + (w.shape[-1],))

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        x2 = x.reshape(-1, x.shape[-1])
        g2 = g.reshape(-1, g.shape[-1])
        gx = _mm_mat1_backward(g2, w, x2).reshape(x.shape) \
            if ctx.needs_input_grad[0] else None
        gw = _mm_mat2_backward(g2, x2, w) if ctx.needs_input_grad[1] \
            else None
        return gx, gw


class _LazyEinsum(torch.autograd.Function):
    """``torch.einsum(eq, a, b)`` whose forward writes nothing (an
    uninitialized tensor of the product's shape) and whose backward is the
    two products of the output gradient with the other operand. For an
    output no gradient reads; every index of an operand must appear in
    the other operand or the output."""

    generate_vmap_rule = True

    @staticmethod
    def forward(eq, a, b):
        ins, out = eq.split("->")
        ia, ib = ins.split(",")
        size = {**dict(zip(ia, a.shape)), **dict(zip(ib, b.shape))}
        return a.new_empty(tuple(size[i] for i in out))

    @staticmethod
    def setup_context(ctx, inputs, output):
        eq, a, b = inputs
        ctx.eq = eq
        ctx.save_for_backward(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        ins, out = ctx.eq.split("->")
        ia, ib = ins.split(",")
        ga = torch.einsum(f"{out},{ib}->{ia}", g, b) \
            if ctx.needs_input_grad[1] else None
        gb = torch.einsum(f"{ia},{out}->{ib}", a, g) \
            if ctx.needs_input_grad[2] else None
        return None, ga, gb


def lazy_einsum(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """:class:`_LazyEinsum`: the product's gradients without the product,
    for the recompute of a rematerialized block whose product only adds
    into an output."""
    return _LazyEinsum.apply(eq, a, b)


class _Checkpoint(torch.autograd.Function):
    """A rematerialized block: the forward runs ``run(tensors, False)``
    keeping only its inputs; the backward runs ``run(tensors, True)``
    again under ``torch.func.grad`` and pulls the output gradients back
    through it (``True``: the block may leave out what no gradient reads).
    A ``torch.autograd.Function`` with ``setup_context`` and a generated
    vmap rule, so ``torch.func.grad`` and ``vmap`` take it, where
    ``torch.utils.checkpoint`` is refused."""

    generate_vmap_rule = True

    @staticmethod
    def forward(run, *tensors):
        return run(tensors, False)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.run = inputs[0]
        ctx.save_for_backward(*inputs[1:])

    @staticmethod
    def backward(ctx, *grads):
        saved = ctx.saved_tensors
        need = ctx.needs_input_grad[1:]
        wanted = [t for t, n in zip(saved, need) if n]

        def pulled(*w):
            # Σ ⟨output, its gradient⟩: its gradient is the vjp. Taken
            # under torch.func.grad, whose level stays open while the
            # backward of a block nested in this one runs (a vjp's closes
            # before its pull, and the nested block's own transform would
            # reuse its level).
            it = iter(w)
            outs = ctx.run(tuple(next(it) if n else t
                                 for t, n in zip(saved, need)), True)
            return sum((o * g).sum() for o, g in zip(outs, grads))

        out = iter(torch.func.grad(pulled, argnums=tuple(
            range(len(wanted))))(*wanted))
        return (None,) + tuple(next(out) if n else None for n in need)


def checkpoint(run: Callable, *tensors: torch.Tensor):
    """``run(tensors, lazy)`` (a tuple of tensors out) rematerialized: as
    ``jax.checkpoint``, only the inputs are kept for the backward, which
    recomputes the block, with ``lazy`` True (:class:`_Checkpoint`). The
    gradients are bit-equal to those of ``run(tensors, False)`` where the
    recompute runs the same ops."""
    return _Checkpoint.apply(run, *tensors)


def linear(p: Params, x: torch.Tensor) -> torch.Tensor:
    w = p["w"]
    if _lazy_weights and any(w is t for t in _lazy_weights):
        y = _LazyMatmul.apply(x, w)
    else:
        y = x @ w
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
    # On the meta device (the dry-run's shapes) there is no value to fill
    # and no host copy: an empty scalar stands for the base. The cost
    # counter charges it nothing, as it charges the host copy nothing, so
    # a step counts the same on meta as on the card.
    dev = torch.device(device)
    if dev.type == "meta":
        base = torch.empty((), dtype=torch.float32, device=dev)
    elif dev.type == "cuda" and torch.cuda.is_current_stream_capturing():
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
