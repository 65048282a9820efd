"""Decoder-only model stack for every registered architecture family
(port of ``src/repro/nn/model.py``).

The layer layout is ``prefix`` + ``pattern`` × R + ``tail`` (the remainder
of a partial pattern), with the reference's param tree: ``params["stack"]``
holds one tree a pattern position whose leaves are stacked ``[R, …]``, and
the loop over repeats indexes them (views, no copies) where the reference
runs ``lax.scan``. KV/SSM caches mirror the same structure and are written
in place.

Modality frontends are stubs, as in the reference: the VLM forward takes
precomputed patch embeddings [B, n_img, frontend_dim], the audio forward
EnCodec token ids [B, S, n_codebooks].

``use_pallas`` (True by default) runs the RMSNorm, flash attention and
selective-scan kernels where they compute the model's function (see
:mod:`.attention` and :mod:`.mamba`); False runs the model's own plain
path. On CPU tensors the kernel wrappers run their plain versions.
"""
from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from .. import resolve_device
from ..configs.base import ModelConfig
from .blocks import (apply_layer, init_layer, init_layer_cache,
                     trailing_weights)
from .modules import (Params, checkpoint, init_linear, init_rmsnorm,
                      lazy_linears, linear, normal_init, rmsnorm, torch_dtype,
                      tree_leaves, tree_map)

Cache = Dict[str, Any]


def _plan(cfg: ModelConfig):
    P = len(cfg.prefix)
    L = len(cfg.pattern)
    R, rem = cfg.pattern_plan()
    return P, L, R, rem


def _stacked(make: Callable[[], Any], R: int):
    """R trees from ``make`` as one tree of [R, …] leaves, filled one tree
    at a time (one layer's leaves live beside the stack, not R)."""
    out = None
    for r in range(R):
        tree = make()
        if out is None:
            out = tree_map(lambda t: t.new_empty((R,) + tuple(t.shape)), tree)
        for dst, src in zip(tree_leaves(out), tree_leaves(tree)):
            dst[r].copy_(src)
    return out


# ---------------------------------------------------------------------------
# init


def init_model(generator: torch.Generator, cfg: ModelConfig) -> Params:
    """Random weights on the generator's device, in the configuration's
    dtype, with the reference's tree and leaf shapes."""
    dtype = torch_dtype(cfg.dtype)
    P, L, R, rem = _plan(cfg)
    params: Params = {}
    nb = cfg.n_codebooks
    if cfg.modality == "audio":
        params["embed"] = {"e": normal_init(
            generator, (nb, cfg.vocab_size, cfg.d_model), 0.02, dtype)}
    else:
        params["embed"] = {"e": normal_init(
            generator, (cfg.vocab_size, cfg.d_model), 0.02, dtype)}
    if cfg.modality == "vlm":
        params["img_proj"] = init_linear(generator, cfg.frontend_dim,
                                         cfg.d_model, bias=True, dtype=dtype)
    params["prefix"] = tuple(init_layer(generator, cfg, cfg.prefix[i], dtype)
                             for i in range(P))
    params["stack"] = tuple(
        _stacked(lambda: init_layer(generator, cfg, cfg.pattern[pos], dtype),
                 R) for pos in range(L)) if R > 0 else ()
    params["tail"] = tuple(init_layer(generator, cfg, cfg.pattern[i], dtype)
                           for i in range(rem))
    params["norm_f"] = init_rmsnorm(cfg.d_model, dtype, generator.device)
    if not cfg.tie_embeddings:
        if cfg.modality == "audio":
            params["head"] = {"w": normal_init(
                generator, (nb, cfg.d_model, cfg.vocab_size), 0.02, dtype)}
        else:
            params["head"] = init_linear(generator, cfg.d_model,
                                         cfg.vocab_size, dtype=dtype)
    return params


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None,
               device="cuda") -> Cache:
    """Zero KV/SSM caches for ``batch`` sequences of up to ``max_len``
    positions, in the model's layout (stacked [R, …] for the pattern)."""
    dtype = torch_dtype(dtype or cfg.dtype)
    dev = resolve_device(device, shapes_only=True)
    P, L, R, rem = _plan(cfg)

    def layer(spec, lead=()):
        one = init_layer_cache(cfg, spec, batch, max_len, dtype, dev)
        return tree_map(lambda t: t.new_zeros(lead + tuple(t.shape)), one) \
            if lead else one

    return {
        "prefix": tuple(layer(cfg.prefix[i]) for i in range(P)),
        "stack": tuple(layer(cfg.pattern[pos], (R,)) for pos in range(L))
        if R > 0 else (),
        "tail": tuple(layer(cfg.pattern[i]) for i in range(rem)),
    }


# ---------------------------------------------------------------------------
# forward


def _embed_inputs(params, cfg: ModelConfig, tokens, img):
    e = params["embed"]["e"]
    if cfg.modality == "audio":
        # tokens: [B, S, K]; sum codebook embeddings
        return sum(e[k][tokens[..., k]] for k in range(cfg.n_codebooks))
    x = e[tokens]
    if cfg.modality == "vlm" and img is not None:
        xi = linear(params["img_proj"], img.to(x.dtype))
        x = torch.cat([xi, x], dim=1)
    return x


def _logits(params, cfg: ModelConfig, x):
    if cfg.modality == "audio":
        if cfg.tie_embeddings:
            return torch.einsum("bsd,kvd->bskv", x, params["embed"]["e"])
        return torch.einsum("bsd,kdv->bskv", x, params["head"]["w"])
    if cfg.tie_embeddings:
        return x @ params["embed"]["e"].T
    return linear(params["head"], x)


def layer_plan(cfg: ModelConfig):
    """Every layer in the order the forward runs it, as (spec, group, i, r):
    group "prefix", "stack" or "tail", i the index in that group, r the
    repeat (None outside the stack). :func:`layer_of` picks a layer's
    params or cache."""
    P, L, R, rem = _plan(cfg)
    plan = [(cfg.prefix[i], "prefix", i, None) for i in range(P)]
    plan += [(cfg.pattern[pos], "stack", pos, r)
             for r in range(R) for pos in range(L)]
    plan += [(cfg.pattern[i], "tail", i, None) for i in range(rem)]
    return plan


def layer_of(tree, group: str, i: int, r: Optional[int]):
    """One layer's params or cache (repeat r of a stacked tree: views of
    its leaves)."""
    one = tree[group][i]
    return one if r is None else tree_map(lambda t: t[r], one)


def forward(
    params: Params,
    cfg: ModelConfig,
    tokens: torch.Tensor,
    img: Optional[torch.Tensor] = None,
    *,
    cache: Optional[Cache] = None,
    pos_offset: int = 0,
    kv_chunk: int = 1024,
    mamba_chunk: int = 256,
    use_pallas: bool = True,
    remat: bool = False,
) -> Tuple[torch.Tensor, Optional[Cache], torch.Tensor]:
    """Returns (logits, cache, aux_loss). ``cache=None`` → pure forward;
    with a cache → prefill (S > 1) or decode (S == 1) at ``pos_offset``
    (a Python int), the cache written in place and returned. ``remat``
    rematerializes each repeat of the pattern in a forward that takes a
    gradient (grad mode on, no cache): it keeps only the repeat's inputs
    and recomputes its L layers in the backward (:func:`_remat_repeat`),
    as the reference's ``jax.checkpoint`` of its layer-stack scan body. A
    forward under ``torch.no_grad()`` runs as without it."""
    x = _embed_inputs(params, cfg, tokens, img)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    use_cache = cache is not None
    rematerialize = remat and not use_cache and torch.is_grad_enabled()
    done = set()
    for spec, group, i, r in layer_plan(cfg):
        if rematerialize and group == "stack":
            if r not in done:   # the repeat's L layers, rematerialized
                done.add(r)
                x, aux = _remat_repeat(params, cfg, r, x, aux, kv_chunk,
                                       mamba_chunk, use_pallas)
            continue
        x, _, a = apply_layer(
            layer_of(params, group, i, r), cfg, spec, x,
            pos_offset=pos_offset,
            cache=layer_of(cache, group, i, r) if use_cache else None,
            kv_chunk=kv_chunk, mamba_chunk=mamba_chunk,
            use_pallas=use_pallas)
        aux = aux + a
    x = rmsnorm(params["norm_f"], x, use_pallas=use_pallas)
    return _logits(params, cfg, x), cache, aux


def _repeat_run(cfg: ModelConfig, stack, kv_chunk: int, mamba_chunk: int,
                use_pallas: bool):
    """``run((x, aux, *leaves), lazy)``: the L layers of one repeat of the
    pattern on its flat leaves (the stack's per-position trees, indexed at
    the repeat), adding each layer's aux loss as the forward does. With
    ``lazy`` the last layer's trailing projections
    (:func:`.blocks.trailing_weights`) compute only their backward."""

    def run(tensors, lazy):
        x, aux, *leaves = tensors
        it = iter(leaves)
        layers = [tree_map(lambda _: next(it), tree) for tree in stack]
        for pos, (p, spec) in enumerate(zip(layers, cfg.pattern)):
            trailing = lazy and pos == len(layers) - 1
            with lazy_linears(trailing_weights(p, spec)) if trailing \
                    else contextlib.nullcontext():
                x, _, a = apply_layer(p, cfg, spec, x,
                                      kv_chunk=kv_chunk,
                                      mamba_chunk=mamba_chunk,
                                      use_pallas=use_pallas)
            aux = aux + a
        return x, aux

    return run


def _remat_repeat(params, cfg: ModelConfig, r: int, x, aux, kv_chunk: int,
                  mamba_chunk: int, use_pallas: bool):
    """Repeat ``r`` of the pattern, rematerialized (:func:`forward`'s
    ``remat``): only its inputs are kept, and its recompute in the
    backward leaves out the last layer's trailing projections, whose
    outputs no gradient reads, as the reference's recompute does."""
    stack = [layer_of(params, "stack", pos, r)
             for pos in range(len(cfg.pattern))]
    run = _repeat_run(cfg, stack, kv_chunk, mamba_chunk, use_pallas)
    return checkpoint(run, x, aux,
                      *(t for tree in stack for t in tree_leaves(tree)))


def decode_step(params, cfg: ModelConfig, tokens_last, cache, pos: int, *,
                use_pallas: bool = True):
    """One-token decode. tokens_last: [B, 1] (or [B, 1, K] audio)."""
    logits, cache, _ = forward(params, cfg, tokens_last, cache=cache,
                               pos_offset=pos, use_pallas=use_pallas)
    return logits, cache
