"""Serving steps on a client's private model (port of the serve half of
``src/repro/launch/steps.py``; the paper: "after training, a client's
private model can be used for inference").

A step takes a state ``{"params", "cache"}`` and a batch and returns the
state and the last position's logits. The cache is written in place (the
returned state holds the same tensors). ``use_pallas`` runs the RMSNorm,
attention and scan kernels where they compute the model's function
(``nn.model``); False runs the model's plain path.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import torch

from ..configs.base import InputShape, ModelConfig
from ..nn.model import forward, init_cache, init_model


@dataclass(frozen=True)
class StepOptions:
    """Implementation knobs of the serving steps (the reference's mesh
    fields wait for ROADMAP.md Queue 1 item 12, its training fields for
    the training half of item 13)."""

    kv_chunk: int = 1024      # online-softmax KV chunk length
    mamba_chunk: int = 256    # chunked-scan block length


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


def _text_logits(cfg: ModelConfig, logits: torch.Tensor) -> torch.Tensor:
    """Drop image-position logits so labels align with text tokens."""
    if cfg.modality == "vlm" and cfg.n_image_tokens:
        return logits[:, cfg.n_image_tokens:]
    return logits


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
