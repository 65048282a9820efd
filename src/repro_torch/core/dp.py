"""DP-SGD (Abadi et al. 2016) — paper Eq. (7); port of ``src/repro/core/dp.py``.

Per-example gradients come from ``torch.func.vmap(grad)`` over the batch.
Each one is clipped to L2 norm C in example order — the order of the
reference's ``lax.scan``, so the clipped sums round alike — the clipped
gradients are summed, and Gaussian noise N(0, σ²C²) is added once to the
sum before dividing by B.

The noise is an argument: a flat ``[D]`` vector of N(0, 1) draws in
:func:`repro_torch.nn.modules.tree_flatten_vector` order. When it is
absent it is drawn flat from ``generator`` on the params' device. Parity
tests pass the reference's draws here.

``use_pallas`` runs the clip-and-accumulate over the ``[B, D]`` matrix of
flat per-example gradients through :mod:`repro_torch.kernels`, one launch
each per step: ``sumsq_rows`` for the norms and ``clip_accumulate_rows``
for the clipped sum, in example order and bit-equal to a per-example loop
of ``sumsq`` and ``scale_accumulate``. :func:`dp_adam_update` adds the
fused noise + Adam tail (``noise_adam_step``). Nothing on these paths
reads a device value on the host.

:func:`dp_gradient_chunked` is the LLM step's DP gradient (plain torch, a
batch tree in chunks, a hook for the peer logits once per chunk);
:func:`non_dp_gradient` takes the plain mean gradient, over ``accum``
microbatches when asked.
"""
from __future__ import annotations

from functools import reduce
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch.func import grad_and_value, vmap

from ..kernels import (clip_accumulate_rows, noise_adam_step,
                       scale_accumulate, sumsq_rows)
from ..nn.modules import (tree_flatten_vector, tree_leaves, tree_map,
                          tree_unflatten_vector)
from ..optim.optimizers import Adam, AdamState

Params = Any
LossFn = Callable[[Params, Any], torch.Tensor]


def clip_by_global_norm(tree: Params, max_norm: float
                        ) -> Tuple[Params, torch.Tensor]:
    leaves = tree_leaves(tree)
    norm = torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in leaves))
    scale = 1.0 / torch.clamp(norm / max_norm, min=1.0)
    # scale in f32 and cast the product: a scale cast to a low-precision
    # leaf dtype could round up and leave the clipped tree above C
    clipped = tree_map(lambda x: (x.to(torch.float32) * scale).to(x.dtype),
                       tree)
    return clipped, norm


def _draw_noise(params: Params, noise: Optional[torch.Tensor],
                generator: Optional[torch.Generator]) -> torch.Tensor:
    """The flat N(0, 1) draws of one noisy step: ``noise`` when given,
    else drawn from ``generator`` on the params' device."""
    if noise is not None:
        return noise
    if generator is None:
        raise ValueError("DP noise needs either `noise` or a `generator`")
    like = tree_leaves(params)[0]
    n = sum(x.numel() for x in tree_leaves(params))
    return torch.randn((n,), generator=generator, dtype=torch.float32,
                       device=like.device)


def add_gaussian_noise(tree: Params, noise: torch.Tensor,
                       stddev: float) -> Params:
    """``x + stddev·n`` per leaf, with ``noise`` the flat N(0, 1) draws in
    leaf order."""
    draws = tree_unflatten_vector(noise, tree_map(
        lambda x: x.to(torch.float32), tree))
    return tree_map(
        lambda x, n: (x.to(torch.float32) + stddev * n).to(x.dtype),
        tree, draws)


def _per_example(loss_fn: LossFn, params: Params, batch: Any):
    """(losses [B], grads with a leading B dim): each example's gradient of
    ``loss_fn`` on a batch of one, as the reference's scan takes it."""
    def unit_loss(p, ex):
        return loss_fn(p, tuple(t[None] for t in ex))

    grads, losses = vmap(grad_and_value(unit_loss), in_dims=(None, 0))(
        params, tuple(batch))
    return losses, grads


def _flat_clip_accumulate(losses, grads, clip_norm: float, D: int,
                          device) -> Tuple[torch.Tensor, Dict]:
    """The kernel path's clip and accumulate, the reference's per-unit scan
    in two launches: the flat per-example gradients as one [B, D] matrix
    (row stride padded to whole 128-byte cache lines, so the kernels read
    each row in whole lines), every row's norm, the clip scales formed on
    the device, then the clipped sum over the rows in example order into
    f32."""
    leaves = tree_leaves(grads)
    B = losses.shape[0]
    dtype = reduce(torch.promote_types, (g.dtype for g in leaves))
    per_line = 128 // torch.empty((), dtype=dtype).element_size()
    pad = torch.empty((B, -D % per_line), dtype=dtype, device=device)
    flat = torch.cat([g.reshape(B, -1) for g in leaves] + [pad], dim=1)
    flat = flat[:, :D]
    norms = torch.sqrt(sumsq_rows(flat))
    scales = 1.0 / torch.clamp(norms / clip_norm, min=1.0)
    acc = clip_accumulate_rows(flat, scales)
    metrics = {"loss": losses.sum() / B, "mean_grad_norm": norms.sum() / B}
    return acc, metrics


def dp_gradient(
    loss_fn: LossFn,
    params: Params,
    batch: Any,
    *,
    clip_norm: float,
    noise_multiplier: float,
    noise: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    vectorized: bool = False,
    use_pallas: bool = False,
) -> Tuple[Params, Dict]:
    """Noisy clipped mean gradient per Eq. (7). Returns (grad, metrics).

    ``use_pallas`` runs the clip-and-accumulate and the noise add through
    the kernels over flat vectors; the plain path clips tree-structured
    gradients with :func:`clip_by_global_norm`. Both are allclose (the
    difference is summation order only)."""
    if vectorized:
        raise NotImplementedError(
            "dp_gradient vectorized mode is not ported yet (ROADMAP.md "
            "Queue 1 item 6)")
    losses, grads = _per_example(loss_fn, params, batch)
    B = losses.shape[0]
    stddev = noise_multiplier * clip_norm
    noise = _draw_noise(params, noise, generator)
    zero = tree_map(lambda x: torch.zeros(x.shape, dtype=torch.float32,
                                          device=x.device), params)
    if use_pallas:
        acc, metrics = _flat_clip_accumulate(
            losses, grads, clip_norm, noise.shape[0], noise.device)
        # noise add through the same kernel: acc + noise·(σC), one pass
        sigma = torch.full((), stddev, dtype=torch.float32,
                           device=noise.device)
        noisy = scale_accumulate(acc, noise, sigma)
        return tree_unflatten_vector(noisy / B, zero), metrics
    acc, norms = zero, []
    for i in range(B):
        g_clip, norm = clip_by_global_norm(tree_map(lambda g: g[i], grads),
                                           clip_norm)
        acc = tree_map(lambda a, x: a + x.to(torch.float32), acc, g_clip)
        norms.append(norm)
    noisy = add_gaussian_noise(acc, noise, stddev)
    metrics = {"loss": losses.sum() / B,
               "mean_grad_norm": torch.stack(norms).sum() / B}
    return tree_map(lambda x: x / B, noisy), metrics


def dp_adam_update(
    loss_fn: LossFn,
    params: Params,
    opt_state: AdamState,
    batch: Any,
    *,
    opt: Adam,
    clip_norm: float,
    noise_multiplier: float,
    noise: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
) -> Tuple[Params, AdamState, Dict]:
    """Fused DP-SGD + Adam step: the clip and accumulate of
    ``sumsq_rows`` / ``clip_accumulate_rows``, then ``noise_adam_step``
    applies noise, clipped mean, weight decay, the moment updates and the
    bias-corrected step in one pass. Returns
    ``(params', opt_state', metrics)``.

    The fused chain repeats Adam's f32 update only; non-f32 params or
    moments (the reference's fallback at ``src/repro/core/dp.py:192-203``)
    are not ported yet and raise."""
    if opt.moment_dtype != "float32" or opt_state.p32 is not None or any(
            x.dtype != torch.float32 for x in tree_leaves(params)):
        raise NotImplementedError(
            "dp_adam_update on non-f32 params or moments is not ported yet "
            "(ROADMAP.md Queue 1 item 6)")
    losses, grads = _per_example(loss_fn, params, batch)
    p_flat = tree_flatten_vector(params)
    acc, metrics = _flat_clip_accumulate(losses, grads, clip_norm,
                                         p_flat.shape[0], p_flat.device)
    noise = _draw_noise(params, noise, generator)
    t2 = opt_state.t + 1
    tf = t2.to(torch.float32)
    p2, m2, v2 = noise_adam_step(
        acc, noise, p_flat, tree_flatten_vector(opt_state.m),
        tree_flatten_vector(opt_state.v), stddev=noise_multiplier * clip_norm,
        n_units=losses.shape[0], lr=opt.lr, weight_decay=opt.weight_decay,
        b1=opt.b1, b2=opt.b2, eps=opt.eps, c1=1 - opt.b1 ** tf,
        c2=1 - opt.b2 ** tf)
    opt2 = AdamState(tree_unflatten_vector(m2, opt_state.m),
                     tree_unflatten_vector(v2, opt_state.v), t2, None)
    return tree_unflatten_vector(p2, params), opt2, metrics


def _batch_size(batch: Any) -> int:
    return tree_leaves(batch)[0].shape[0]


def _rows(batch: Any, start: int, n: int) -> Any:
    """Rows ``start .. start+n-1`` of every leaf of a batch tree."""
    return tree_map(lambda x: x[start:start + n], batch)


def dp_gradient_chunked(
    loss_fn: LossFn,
    params: Params,
    batch: Any,
    *,
    clip_norm: float,
    noise_multiplier: float,
    chunk: int = 8,
    prepare_chunk: Callable[[Any], Any] = lambda b: b,
    noise: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
) -> Tuple[Params, Dict]:
    """Per-example DP-SGD gradient (Eq. 7) chunk by chunk: a loop over
    B/chunk chunks, the per-example gradients of a chunk from one
    ``torch.func.vmap(grad)``, each clipped to C, the clipped sum
    accumulated in f32; noise N(0, (σC)²) once, then the mean over B. The
    same function as :func:`dp_gradient`; ``chunk`` trades peak gradient
    memory (chunk × |θ|) against the number of chunks. ``batch`` is a tree
    (a dict of tensors) whose leaves share the leading B.

    ``prepare_chunk`` runs once per chunk, outside the per-example
    transform and without a gradient: the LLM step computes the private
    peer's logits there with one batched forward (kernels allowed), never
    once per example. The plain torch path, as the reference keeps this
    function on plain XLA: no clip kernel."""
    B = _batch_size(batch)
    if B % chunk:
        raise ValueError(f"batch {B} is not a multiple of chunk {chunk}")

    def unit_loss(p, ex):
        return loss_fn(p, tree_map(lambda x: x[None], ex))

    per_example = vmap(grad_and_value(unit_loss), in_dims=(None, 0))
    acc = tree_map(lambda x: torch.zeros(x.shape, dtype=torch.float32,
                                         device=x.device), params)
    like = tree_leaves(params)[0]
    loss_sum = torch.zeros((), dtype=torch.float32, device=like.device)
    norm_sum = torch.zeros((), dtype=torch.float32, device=like.device)
    for i in range(B // chunk):
        with torch.no_grad():
            cb = prepare_chunk(_rows(batch, i * chunk, chunk))
        grads, losses = per_example(params, cb)
        norms = torch.sqrt(sum(
            torch.sum(torch.square(g.to(torch.float32)).reshape(chunk, -1),
                      dim=1) for g in tree_leaves(grads)))
        scales = (1.0 / torch.clamp(norms / clip_norm, min=1.0)).to(
            torch.float32)
        acc = tree_map(lambda a, g: a + torch.einsum(
            "b...,b->...", g.to(torch.float32), scales), acc, grads)
        loss_sum = loss_sum + torch.sum(losses)
        norm_sum = norm_sum + torch.sum(norms)
    noise = _draw_noise(params, noise, generator)
    noisy = add_gaussian_noise(acc, noise, noise_multiplier * clip_norm)
    grad = tree_map(lambda x: x / B, noisy)
    return grad, {"loss": loss_sum / B, "mean_grad_norm": norm_sum / B}


def non_dp_gradient(loss_fn: LossFn, params: Params, batch: Any, *,
                    accum: int = 1,
                    prepare: Callable[[Any], Any] = lambda b: b
                    ) -> Tuple[Params, Dict]:
    """Plain mean gradient of ``loss_fn`` over the batch; with ``accum`` >
    1 accumulated over that many microbatch slices of a batch tree (the
    reference's scan), in f32: Σ g_i / accum. ``prepare`` runs on each
    microbatch before the loss, without a gradient (the LLM step's peer
    logits)."""
    def grad_of(b):
        with torch.no_grad():
            b = prepare(b)
        return grad_and_value(loss_fn)(params, b)

    if accum <= 1:
        g, loss = grad_of(batch)
        return g, {"loss": loss}
    B = _batch_size(batch)
    if B % accum:
        raise ValueError(f"batch {B} is not a multiple of accum {accum}")
    mb = B // accum
    acc = tree_map(lambda x: torch.zeros(x.shape, dtype=torch.float32,
                                         device=x.device), params)
    loss_sum = torch.zeros((), dtype=torch.float32,
                           device=tree_leaves(params)[0].device)
    for i in range(accum):
        g, loss = grad_of(_rows(batch, i * mb, mb))
        acc = tree_map(lambda a, x: a + x.to(torch.float32) / accum, acc, g)
        loss_sum = loss_sum + loss / accum
    return acc, {"loss": loss_sum}
