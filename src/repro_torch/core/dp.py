"""DP-SGD (Abadi et al. 2016) — paper Eq. (7); port of ``src/repro/core/dp.py``.

Per-example gradients come from ``torch.func.vmap(grad)`` over the batch.
Each one is clipped to L2 norm C in example order — the order of the
reference's ``lax.scan``, so the clipped sums round alike — the clipped
gradients are summed, and Gaussian noise N(0, σ²C²) is added once to the
sum before dividing by B. ``microbatch`` > 1 makes a DP unit of that many
examples (the mean loss over the group, its gradient clipped as one; the
guarantee is then per group) and divides by the ``B // microbatch``
units. ``vectorized=True`` clips and sums the units in one contraction
(the reference's vmap mode; plain torch, whatever ``use_pallas`` says).

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
batch tree in chunks, a hook for the peer logits once per chunk; the
stacked executor vmaps it over the cohort, the per-example vmap inside
the client one);
:func:`dp_gradient_poisson` is Eq. (7) under exact Poisson subsampling
(a masked padded batch, the mean over the EXPECTED batch size; plain
torch, as the reference's); :func:`non_dp_gradient` takes the plain mean
gradient, over ``accum`` microbatches when asked.
"""
from __future__ import annotations

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


def _per_example(loss_fn: LossFn, params: Params, batch: Any,
                 microbatch: int = 1):
    """(losses [n_units], grads with a leading n_units dim): each unit's
    gradient of ``loss_fn`` on its ``microbatch`` consecutive examples, as
    the reference's scan takes them (one example a unit by default)."""
    B = _batch_size(batch)
    if B % microbatch:
        raise ValueError(f"batch {B} is not a multiple of microbatch "
                         f"{microbatch}")
    units = tree_map(lambda x: x.reshape((B // microbatch, microbatch)
                                         + tuple(x.shape[1:])), batch)
    grads, losses = vmap(grad_and_value(loss_fn), in_dims=(None, 0))(
        params, units)
    return losses, grads


def _unit_norms(grads, n: int) -> torch.Tensor:
    """[n] f32 global L2 norms of the per-unit gradients."""
    return torch.sqrt(sum(
        torch.sum(torch.square(g.to(torch.float32)).reshape(n, -1), dim=1)
        for g in tree_leaves(grads)))


def _flat_clip_accumulate(losses, grads, clip_norm: float, D: int,
                          device) -> Tuple[torch.Tensor, Dict]:
    """The kernel path's clip and accumulate, the reference's per-unit scan
    in two launches: the flat per-unit gradients as one [B, D] f32 matrix
    (bf16 gradients widened exactly, as the reference's kernels take them
    in f32; row stride padded to whole 128-byte cache lines, so the
    kernels read each row in whole lines), every row's norm, the clip
    scales formed on the device, then the clipped sum over the rows in
    unit order into f32."""
    leaves = tree_leaves(grads)
    B = losses.shape[0]
    f32 = torch.float32
    pad = torch.empty((B, -D % 32), dtype=f32, device=device)
    flat = torch.cat([g.reshape(B, -1).to(f32) for g in leaves] + [pad],
                     dim=1)
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
    microbatch: int = 1,
    vectorized: bool = False,
    use_pallas: bool = False,
) -> Tuple[Params, Dict]:
    """Noisy clipped mean gradient per Eq. (7). Returns (grad, metrics).

    ``use_pallas`` runs the clip-and-accumulate and the noise add through
    the kernels over flat vectors; the plain path clips tree-structured
    gradients with :func:`clip_by_global_norm` unit by unit. Both are
    allclose (the difference is summation order only). ``vectorized``
    clips all units' gradients in one contraction, in plain torch (it
    ignores ``use_pallas`` and launches no kernel, as the reference's
    vmap mode ignores its flag)."""
    losses, grads = _per_example(loss_fn, params, batch, microbatch)
    n_units = losses.shape[0]
    stddev = noise_multiplier * clip_norm
    noise = _draw_noise(params, noise, generator)
    zero = tree_map(lambda x: torch.zeros(x.shape, dtype=torch.float32,
                                          device=x.device), params)
    if vectorized:
        norms = _unit_norms(grads, n_units)
        scales = 1.0 / torch.clamp(norms / clip_norm, min=1.0)
        acc = tree_map(lambda g: torch.einsum(
            "b...,b->...", g.to(torch.float32), scales), grads)
        noisy = add_gaussian_noise(acc, noise, stddev)
        return tree_map(lambda x: x / n_units, noisy), {
            "loss": torch.mean(losses), "mean_grad_norm": torch.mean(norms)}
    if use_pallas:
        acc, metrics = _flat_clip_accumulate(
            losses, grads, clip_norm, noise.shape[0], noise.device)
        # noise add through the same kernel: acc + noise·(σC), one pass
        sigma = torch.full((), stddev, dtype=torch.float32,
                           device=noise.device)
        noisy = scale_accumulate(acc, noise, sigma)
        return tree_unflatten_vector(noisy / n_units, zero), metrics
    acc, norms = zero, []
    for i in range(n_units):
        g_clip, norm = clip_by_global_norm(tree_map(lambda g: g[i], grads),
                                           clip_norm)
        acc = tree_map(lambda a, x: a + x.to(torch.float32), acc, g_clip)
        norms.append(norm)
    noisy = add_gaussian_noise(acc, noise, stddev)
    metrics = {"loss": losses.sum() / n_units,
               "mean_grad_norm": torch.stack(norms).sum() / n_units}
    return tree_map(lambda x: x / n_units, noisy), metrics


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
    microbatch: int = 1,
) -> Tuple[Params, AdamState, Dict]:
    """Fused DP-SGD + Adam step: the clip and accumulate of
    ``sumsq_rows`` / ``clip_accumulate_rows``, then ``noise_adam_step``
    applies noise, clipped mean, weight decay, the moment updates and the
    bias-corrected step in one pass. Returns
    ``(params', opt_state', metrics)``.

    The fused chain repeats Adam's f32 update only, so non-f32 params, a
    master copy (``p32``) or non-f32 moments take the reference's
    fallback: ``dp_gradient(use_pallas=True)`` (the rows kernels on the
    per-unit gradients widened to f32, the noise add on
    ``scale_accumulate``'s 1-D route) and then ``opt.update``."""
    if opt.moment_dtype != "float32" or opt_state.p32 is not None or any(
            x.dtype != torch.float32 for x in tree_leaves(params)):
        grad, metrics = dp_gradient(
            loss_fn, params, batch, clip_norm=clip_norm,
            noise_multiplier=noise_multiplier, noise=noise,
            generator=generator, microbatch=microbatch, use_pallas=True)
        params2, opt2 = opt.update(grad, opt_state, params)
        return params2, opt2, metrics
    losses, grads = _per_example(loss_fn, params, batch, microbatch)
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
        norms = _unit_norms(grads, chunk)
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


def dp_gradient_poisson(
    loss_fn: LossFn,
    params: Params,
    batch: Any,
    mask: torch.Tensor,
    *,
    clip_norm: float,
    noise_multiplier: float,
    expected_batch: float,
    noise: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
) -> Tuple[Params, Dict]:
    """Eq. (7) under EXACT Poisson subsampling (Yu et al. 2019): the
    clipped per-example gradients of the masked examples (``mask`` [max_B],
    1.0 a real example, 0.0 padding; the batch from
    :func:`repro_torch.data.loader.poisson_batch`) are summed, Gaussian
    noise N(0, σ²C²) added once, and the sum divided by the EXPECTED batch
    size qN, the estimator whose sensitivity the sampled-Gaussian RDP
    accountant analyzes. Padding contributes exactly zero. Plain torch, as
    the reference's."""
    losses, grads = _per_example(loss_fn, params, batch)
    norms = _unit_norms(grads, losses.shape[0])
    mask = mask.to(torch.float32)
    scales = mask / torch.clamp(norms / clip_norm, min=1.0)
    acc = tree_map(lambda g: torch.einsum(
        "b...,b->...", g.to(torch.float32), scales), grads)
    noisy = add_gaussian_noise(acc, _draw_noise(params, noise, generator),
                               noise_multiplier * clip_norm)
    grad = tree_map(lambda x: x / expected_batch, noisy)
    n_real = torch.clamp(torch.sum(mask), min=1.0)
    return grad, {"loss": torch.sum(losses * mask) / n_real,
                  "mean_grad_norm": torch.sum(norms * mask) / n_real}


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
