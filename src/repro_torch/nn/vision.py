"""The paper's image-classification models (port of ``src/repro/nn/vision.py``;
this slice ports ``mlp``, the main path's model).

A model is the pair ``VisionModel(name, init, apply)``:
``init(generator, image_shape, n_classes) -> params`` draws a nested dict of
tensors in the reference's layout on the generator's device, and
``apply(params, images) -> logits`` runs the ``nn.Module`` on those params
through :func:`torch.func.functional_call`, so the same params serve
per-example gradients (``torch.func.vmap``) and cohort-batched evaluation.
Images are NHWC, as in the reference.
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Callable, Dict

import torch
from torch import nn
from torch.func import functional_call

from .modules import Params, init_linear, linear


@dataclass(frozen=True)
class VisionModel:
    name: str
    init: Callable
    apply: Callable


class Linear(nn.Module):
    """``x @ w + b`` with ``w`` stored ``[d_in, d_out]``, the reference's
    layout (``torch.nn.Linear`` stores the transpose)."""

    def __init__(self, d_in: int, d_out: int):
        super().__init__()
        self.w = nn.Parameter(torch.empty(d_in, d_out))
        self.b = nn.Parameter(torch.empty(d_out))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return linear({"w": self.w, "b": self.b}, x)


class MLP(nn.Module):
    """Two hidden layers of 200 units (paper App. A)."""

    def __init__(self, d_in: int, n_classes: int, hidden: int = 200):
        super().__init__()
        self.fc1 = Linear(d_in, hidden)
        self.fc2 = Linear(hidden, hidden)
        self.fc3 = Linear(hidden, n_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.reshape(x.shape[0], -1)
        x = torch.relu(self.fc1(x))
        x = torch.relu(self.fc2(x))
        return self.fc3(x)


def init_mlp_vision(generator: torch.Generator, image_shape, n_classes: int,
                    dtype=torch.float32) -> Params:
    d_in = math.prod(image_shape)
    return {
        "fc1": init_linear(generator, d_in, 200, bias=True,
                           scale=d_in ** -0.5, dtype=dtype),
        "fc2": init_linear(generator, 200, 200, bias=True,
                           scale=200 ** -0.5, dtype=dtype),
        "fc3": init_linear(generator, 200, n_classes, bias=True,
                           scale=200 ** -0.5, dtype=dtype),
    }


@functools.lru_cache(maxsize=None)
def _mlp_module(d_in: int, n_classes: int) -> MLP:
    """The structure only: built on the meta device (no memory), its
    parameters are always replaced by the caller's in functional_call."""
    with torch.device("meta"):
        return MLP(d_in, n_classes)


def _named(params: Params, prefix: str = "") -> Dict[str, torch.Tensor]:
    out = {}
    for k, v in params.items():
        if isinstance(v, dict):
            out.update(_named(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def apply_mlp_vision(p: Params, x: torch.Tensor) -> torch.Tensor:
    module = _mlp_module(p["fc1"]["w"].shape[0], p["fc3"]["w"].shape[1])
    return functional_call(module, _named(p), (x,))


MODELS = {
    "mlp": VisionModel("mlp", init_mlp_vision, apply_mlp_vision),
}


def get_vision_model(name: str) -> VisionModel:
    if name not in MODELS:
        raise NotImplementedError(
            f"vision model {name!r} is not ported yet (ROADMAP.md Queue 1 "
            f"item 4); ported: {sorted(MODELS)}")
    return MODELS[name]
