"""ProxyFL steps on the LLM stack (port of ``src/repro/launch/steps.py``):
one client's training step (Algorithm 1 lines 2–5) and the serving steps
on its private model (the paper: "after training, a client's private
model can be used for inference").

Training
--------
:func:`init_train_state` builds one client's state ``{"private":
{"params", "opt"}, "proxy": {"params", "opt"}, "w", "t"}`` (the
reference's layout) and :func:`make_train_step` its local DML step,
``step(state, batch, generator=None, noise=None) -> (state, metrics)``, the
engine's contract: the private model takes a plain Adam step on Eq. (4),
the proxy a DP-SGD Adam step on Eq. (5) with per-example clipping (Eq. 7,
``core.dp.dp_gradient_chunked``). ``noise`` is the proxy's flat N(0, 1)
draws (absent: drawn from ``generator``).

The peer logits take no gradient (θ₀ and φ₀ are constants of the step),
so they are computed outside every gradient transform, under
``torch.no_grad()``: the proxy peer once per microbatch of the private
loss, the private peer once per DP chunk (``prepare_chunk``). There, with
``fl.use_pallas``, the model runs its RMSNorm, attention and scan kernels.
The forwards a gradient passes through run the model's plain path
(``use_pallas=False``): the kernels have no backward, and the reference
trains through XLA's autodiff of its plain path.

Serving
-------
A serving step takes a state ``{"params", "cache"}`` and a batch and
returns the state and the last position's logits. The cache is written in
place (the returned state holds the same tensors). ``use_pallas`` runs
the RMSNorm, attention and scan kernels where they compute the model's
function (``nn.model``); False runs the model's plain path.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import torch

from ..configs.base import InputShape, ModelConfig, ProxyFLConfig
from ..core.dp import dp_gradient_chunked, non_dp_gradient
from ..nn.losses import dml_loss
from ..nn.model import forward, init_cache, init_model
from ..optim import Adam


@dataclass(frozen=True)
class StepOptions:
    """Implementation knobs of the steps (the reference's mesh fields
    ``shard_acts``, ``expert_parallel`` and ``serve_2d`` wait for
    ROADMAP.md Queue 1 item 12; ``remat`` and ``logits_dtype``, which its
    train driver pins or leaves unread, for the dryrun port, item 14)."""

    accum: int = 8                # private-grad microbatch accumulation chunks
    dp_chunk: int = 8             # examples per DP vmap chunk
    moment_dtype: str = "float32"  # Adam m/v dtype ("bfloat16" halves them)
    kv_chunk: int = 1024          # online-softmax KV chunk length
    mamba_chunk: int = 256        # chunked-scan block length


def init_train_state(generator: torch.Generator, cfg_priv: ModelConfig,
                     cfg_proxy: ModelConfig, fl: ProxyFLConfig,
                     opts: StepOptions = StepOptions()) -> Dict:
    """One client's random private and proxy models (drawn in that order
    from ``generator``, on its device) with their Adam states."""
    opt = Adam(lr=fl.lr, weight_decay=fl.weight_decay,
               moment_dtype=opts.moment_dtype)
    phi = init_model(generator, cfg_priv)
    theta = init_model(generator, cfg_proxy)
    dev = generator.device
    return {
        "private": {"params": phi, "opt": opt.init(phi)},
        "proxy": {"params": theta, "opt": opt.init(theta)},
        "w": torch.ones((), dtype=torch.float32, device=dev),
        "t": torch.zeros((), dtype=torch.int32, device=dev),
    }


def _text_logits(cfg: ModelConfig, logits: torch.Tensor) -> torch.Tensor:
    """Drop image-position logits so labels align with text tokens."""
    if cfg.modality == "vlm" and cfg.n_image_tokens:
        return logits[:, cfg.n_image_tokens:]
    return logits


def _forward_logits(params, cfg: ModelConfig, batch: Dict,
                    opts: StepOptions, *, use_pallas: bool):
    logits, _, aux = forward(params, cfg, batch["tokens"], batch.get("img"),
                             kv_chunk=opts.kv_chunk,
                             mamba_chunk=opts.mamba_chunk,
                             use_pallas=use_pallas)
    return _text_logits(cfg, logits), aux


def make_train_step(cfg_priv: ModelConfig, cfg_proxy: ModelConfig,
                    fl: ProxyFLConfig, opts: StepOptions = StepOptions()):
    """One client's local DML step (module docstring). A batch is a dict
    ``{"tokens", "labels"[, "img"]}`` with a leading batch dim B, a
    multiple of ``opts.accum`` and, under DP, of ``opts.dp_chunk``."""
    opt = Adam(lr=fl.lr, weight_decay=fl.weight_decay,
               moment_dtype=opts.moment_dtype)
    kernels = fl.use_pallas

    def step(state, batch, generator=None, noise=None):
        phi0 = state["private"]["params"]
        theta0 = state["proxy"]["params"]

        # ---- private model: Eq. (4), non-DP, microbatch-accumulated; the
        # proxy peer's logits once per microbatch, without a gradient
        def add_proxy_peer(mb):
            peer, _ = _forward_logits(theta0, cfg_proxy, mb, opts,
                                      use_pallas=kernels)
            return dict(mb, peer=peer)

        def ploss(phi, mb):
            own, aux = _forward_logits(phi, cfg_priv, mb, opts,
                                       use_pallas=False)
            return dml_loss(own, mb["peer"], mb["labels"], fl.alpha) + aux

        g_phi, m_phi = non_dp_gradient(ploss, phi0, batch, accum=opts.accum,
                                       prepare=add_proxy_peer)

        # ---- proxy model: Eq. (5) with per-example DP-SGD (Eq. 7); the
        # private peer's logits once per DP chunk, one batched forward
        def add_peer(cb):
            peer, _ = _forward_logits(phi0, cfg_priv, cb, opts,
                                      use_pallas=kernels)
            return dict(cb, peer=peer)

        def xloss(theta, ex):
            own, aux = _forward_logits(theta, cfg_proxy, ex, opts,
                                       use_pallas=False)
            return dml_loss(own, ex["peer"], ex["labels"], fl.beta) + aux

        if fl.dp.enabled:
            g_theta, m_theta = dp_gradient_chunked(
                xloss, theta0, batch, clip_norm=fl.dp.clip_norm,
                noise_multiplier=fl.dp.noise_multiplier,
                chunk=opts.dp_chunk, prepare_chunk=add_peer, noise=noise,
                generator=generator)
        else:
            g_theta, m_theta = non_dp_gradient(
                xloss, theta0, batch, accum=opts.accum, prepare=add_peer)

        phi1, opt_phi1 = opt.update(g_phi, state["private"]["opt"], phi0)
        theta1, opt_theta1 = opt.update(g_theta, state["proxy"]["opt"],
                                        theta0)
        new_state = {
            "private": {"params": phi1, "opt": opt_phi1},
            "proxy": {"params": theta1, "opt": opt_theta1},
            "w": state["w"],
            "t": state["t"] + 1,
        }
        return new_state, {"private_loss": m_phi["loss"],
                           "proxy_loss": m_theta["loss"]}

    return step


def init_serve_state(generator: torch.Generator, cfg: ModelConfig,
                     shape: InputShape) -> Dict:
    """Random params (on the generator's device) and empty caches for
    ``shape.global_batch`` sequences of ``shape.seq_len`` tokens (plus the
    image tokens of a VLM)."""
    max_len = shape.seq_len + (cfg.n_image_tokens
                               if cfg.modality == "vlm" else 0)
    return {"params": init_model(generator, cfg),
            "cache": init_cache(cfg, shape.global_batch, max_len,
                                device=generator.device)}


def make_prefill_step(cfg: ModelConfig, opts: StepOptions = StepOptions(),
                      *, use_pallas: bool = True):
    def prefill(state, batch):
        logits, cache, _ = forward(state["params"], cfg, batch["tokens"],
                                   batch.get("img"), cache=state["cache"],
                                   pos_offset=0, kv_chunk=opts.kv_chunk,
                                   mamba_chunk=opts.mamba_chunk,
                                   use_pallas=use_pallas)
        return {"params": state["params"], "cache": cache}, logits[:, -1]

    return prefill


def make_decode_step(cfg: ModelConfig, opts: StepOptions = StepOptions(),
                     *, use_pallas: bool = True):
    def decode(state, batch):
        # tokens [B, 1] (or [B, 1, K] audio); pos: the current length (int)
        logits, cache, _ = forward(state["params"], cfg, batch["tokens"],
                                   cache=state["cache"],
                                   pos_offset=int(batch["pos"]),
                                   kv_chunk=opts.kv_chunk,
                                   mamba_chunk=opts.mamba_chunk,
                                   use_pallas=use_pallas)
        return {"params": state["params"], "cache": cache}, logits[:, -1]

    return decode
