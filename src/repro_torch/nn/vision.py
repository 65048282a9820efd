"""The paper's image-classification models (port of ``src/repro/nn/vision.py``):
MLP, LeNet5, CNN1, CNN2 (Shen et al. 2020), the small VGG of Kvasir and a
GroupNorm residual CNN standing in for Camelyon-17's ResNet18-GN.

A model is the pair ``VisionModel(name, init, apply)``:
``init(generator, image_shape, n_classes) -> params`` draws a nested dict of
tensors in the reference's layout on the generator's device (linear ``w``
``[d_in, d_out]``, conv ``w`` HWIO ``[kh, kw, cin, cout]``, GroupNorm ``g``
and ``b``), and ``apply(params, images) -> logits`` runs the ``nn.Module``
on those params through :func:`torch.func.functional_call`, so the same
params serve per-example gradients (``torch.func.vmap``) and cohort-batched
evaluation. Images are NHWC, as in the reference; the conv models compute
in NCHW and permute back to NHWC before a flatten, so ``fc1``/``fc`` rows
keep the reference's (h, w, c) order. Convolutions pad as XLA's
``"SAME"``, max pooling is VALID, and GroupNorm groups contiguous channels
with the population variance, as the reference's ``_groupnorm``.
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Callable, Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call

from .modules import Params, init_linear, linear


@dataclass(frozen=True)
class VisionModel:
    name: str
    init: Callable
    apply: Callable


# ---------------------------------------------------------------------------
# layers


class Linear(nn.Module):
    """``x @ w + b`` with ``w`` stored ``[d_in, d_out]``, the reference's
    layout (``torch.nn.Linear`` stores the transpose)."""

    def __init__(self, d_in: int, d_out: int):
        super().__init__()
        self.w = nn.Parameter(torch.empty(d_in, d_out))
        self.b = nn.Parameter(torch.empty(d_out))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return linear({"w": self.w, "b": self.b}, x)


def same_pads(size: int, k: int, stride: int) -> Tuple[int, int]:
    """XLA's ``"SAME"`` padding of one spatial dim: (low, high), the low
    side taking the smaller half (a stride-2 3×3 conv pads (0, 1) at even
    sizes, (1, 1) at odd ones)."""
    total = max((-(-size // stride) - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


class Conv(nn.Module):
    """A 2-D convolution on NCHW activations with ``w`` stored HWIO (the
    reference's layout), ``"SAME"`` padding and the bias added after."""

    def __init__(self, kh: int, kw: int, cin: int, cout: int,
                 stride: int = 1):
        super().__init__()
        self.w = nn.Parameter(torch.empty(kh, kw, cin, cout))
        self.b = nn.Parameter(torch.empty(cout))
        self.stride = stride

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        kh, kw = self.w.shape[:2]
        (top, bottom), (left, right) = (
            same_pads(x.shape[-2], kh, self.stride),
            same_pads(x.shape[-1], kw, self.stride))
        if (top, left) == (bottom, right):
            padding = (top, left)
        else:
            x, padding = F.pad(x, (left, right, top, bottom)), 0
        y = F.conv2d(x, self.w.permute(3, 2, 0, 1), stride=self.stride,
                     padding=padding)
        return y + self.b[:, None, None]


class GroupNorm(nn.Module):
    """The reference's ``_groupnorm`` on NCHW: ``min(8, C)`` groups,
    lowered until they divide C, of contiguous channels, normalised by the
    population variance over (channels of the group, H, W)."""

    def __init__(self, c: int, groups: int = 8, eps: float = 1e-5):
        super().__init__()
        self.g = nn.Parameter(torch.empty(c))
        self.b = nn.Parameter(torch.empty(c))
        self.groups, self.eps = groups, eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, C, H, W = x.shape
        g = min(self.groups, C)
        while C % g:
            g -= 1
        xr = x.reshape(B, g, C // g, H, W)
        mu = xr.mean(dim=(2, 3, 4), keepdim=True)
        var = xr.var(dim=(2, 3, 4), keepdim=True, correction=0)
        xr = (xr - mu) * torch.rsqrt(var + self.eps)
        return (xr.reshape(B, C, H, W) * self.g[:, None, None]
                + self.b[:, None, None])


def _pool(x: torch.Tensor) -> torch.Tensor:
    """2×2 max pooling, stride 2, VALID (odd sizes drop the last row)."""
    return F.max_pool2d(x, 2)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _flatten_nhwc(x: torch.Tensor) -> torch.Tensor:
    """NCHW activations flattened in the reference's NHWC (h, w, c) order."""
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)


# ---------------------------------------------------------------------------
# models (the structure only: the caller's params replace every parameter)


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


class LeNet5(nn.Module):
    def __init__(self, cin: int, fc_in: int, n_classes: int):
        super().__init__()
        self.c1 = Conv(5, 5, cin, 6)
        self.c2 = Conv(5, 5, 6, 16)
        self.fc1 = Linear(fc_in, 120)
        self.fc2 = Linear(120, 84)
        self.fc3 = Linear(84, n_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _pool(torch.relu(self.c1(_nchw(x))))
        x = _flatten_nhwc(_pool(torch.relu(self.c2(x))))
        x = torch.relu(self.fc1(x))
        x = torch.relu(self.fc2(x))
        return self.fc3(x)


class CNN1(nn.Module):
    def __init__(self, cin: int, fc_in: int, n_classes: int):
        super().__init__()
        self.c1 = Conv(3, 3, cin, 6)
        self.c2 = Conv(3, 3, 6, 16)
        self.fc1 = Linear(fc_in, 64)
        self.fc2 = Linear(64, n_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _pool(torch.relu(self.c1(_nchw(x))))
        x = _flatten_nhwc(_pool(torch.relu(self.c2(x))))
        return self.fc2(torch.relu(self.fc1(x)))


class CNN2(nn.Module):
    def __init__(self, cin: int, fc_in: int, n_classes: int):
        super().__init__()
        self.c1 = Conv(3, 3, cin, 128)
        self.c2 = Conv(3, 3, 128, 128)
        self.fc = Linear(fc_in, n_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _pool(torch.relu(self.c1(_nchw(x))))
        return self.fc(_flatten_nhwc(_pool(torch.relu(self.c2(x)))))


class VGGSmall(nn.Module):
    def __init__(self, cin: int, n_classes: int):
        super().__init__()
        self.c1 = Conv(3, 3, cin, 32)
        self.c2 = Conv(3, 3, 32, 64)
        self.c3 = Conv(3, 3, 64, 128)
        self.fc1 = Linear(128, 128)
        self.fc2 = Linear(128, n_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _pool(torch.relu(self.c1(_nchw(x))))
        x = _pool(torch.relu(self.c2(x)))
        x = _pool(torch.relu(self.c3(x)))
        x = torch.relu(self.fc1(x.mean(dim=(2, 3))))
        return self.fc2(x)


RESNET_WIDTHS = (32, 64, 128)


class ResNetGN(nn.Module):
    """Three residual blocks, each halving H and W with a stride-2 conv;
    the skip is a stride-2 1×1 conv where the width changes, else
    ``x[:, ::2, ::2]``."""

    def __init__(self, cin: int, n_classes: int):
        super().__init__()
        self.stem = Conv(3, 3, cin, RESNET_WIDTHS[0])
        cin = RESNET_WIDTHS[0]
        for i, cout in enumerate(RESNET_WIDTHS):
            setattr(self, f"b{i}_c1", Conv(3, 3, cin, cout, stride=2))
            setattr(self, f"b{i}_n1", GroupNorm(cout))
            setattr(self, f"b{i}_c2", Conv(3, 3, cout, cout))
            setattr(self, f"b{i}_n2", GroupNorm(cout))
            if cin != cout:
                setattr(self, f"b{i}_skip", Conv(1, 1, cin, cout, stride=2))
            cin = cout
        self.fc = Linear(cin, n_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.relu(self.stem(_nchw(x)))
        for i in range(len(RESNET_WIDTHS)):
            c1, n1, c2, n2 = (getattr(self, f"b{i}_{layer}")
                              for layer in ("c1", "n1", "c2", "n2"))
            h = n2(c2(torch.relu(n1(c1(x)))))
            skip = getattr(self, f"b{i}_skip", None)
            xs = skip(x) if skip is not None else x[:, :, ::2, ::2]
            x = torch.relu(h + xs)
        return self.fc(x.mean(dim=(2, 3)))


@functools.lru_cache(maxsize=None)
def _structure(cls, *dims) -> nn.Module:
    """A model's structure only: built on the meta device (no memory), its
    parameters are always replaced by the caller's in functional_call."""
    with torch.device("meta"):
        return cls(*dims)


def _named(params: Params, prefix: str = "") -> Dict[str, torch.Tensor]:
    out = {}
    for k, v in params.items():
        if isinstance(v, dict):
            out.update(_named(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def _run(cls, p: Params, x: torch.Tensor, *dims) -> torch.Tensor:
    return functional_call(_structure(cls, *dims), _named(p), (x,))


# ---------------------------------------------------------------------------
# init and apply, one pair a model


def init_conv(generator: torch.Generator, kh: int, kw: int, cin: int,
              cout: int, dtype=torch.float32) -> Params:
    scale = (kh * kw * cin) ** -0.5
    return {"w": scale * torch.randn((kh, kw, cin, cout), generator=generator,
                                     dtype=dtype, device=generator.device),
            "b": torch.zeros((cout,), dtype=dtype, device=generator.device)}


def init_groupnorm(generator: torch.Generator, c: int,
                   dtype=torch.float32) -> Params:
    return {"g": torch.ones((c,), dtype=dtype, device=generator.device),
            "b": torch.zeros((c,), dtype=dtype, device=generator.device)}


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


def apply_mlp_vision(p: Params, x: torch.Tensor) -> torch.Tensor:
    return _run(MLP, p, x, p["fc1"]["w"].shape[0], p["fc3"]["w"].shape[1])


def init_lenet5(generator: torch.Generator, image_shape, n_classes: int,
                dtype=torch.float32) -> Params:
    H, W, C = image_shape
    h, w = H // 4, W // 4   # two 2x2 pools
    return {
        "c1": init_conv(generator, 5, 5, C, 6, dtype),
        "c2": init_conv(generator, 5, 5, 6, 16, dtype),
        "fc1": init_linear(generator, h * w * 16, 120, bias=True, scale=0.05,
                           dtype=dtype),
        "fc2": init_linear(generator, 120, 84, bias=True, scale=0.1,
                           dtype=dtype),
        "fc3": init_linear(generator, 84, n_classes, bias=True, scale=0.1,
                           dtype=dtype),
    }


def apply_lenet5(p: Params, x: torch.Tensor) -> torch.Tensor:
    return _run(LeNet5, p, x, p["c1"]["w"].shape[2], p["fc1"]["w"].shape[0],
                p["fc3"]["w"].shape[1])


def init_cnn1(generator: torch.Generator, image_shape, n_classes: int,
              dtype=torch.float32) -> Params:
    H, W, C = image_shape
    h, w = H // 4, W // 4
    return {
        "c1": init_conv(generator, 3, 3, C, 6, dtype),
        "c2": init_conv(generator, 3, 3, 6, 16, dtype),
        "fc1": init_linear(generator, h * w * 16, 64, bias=True, scale=0.05,
                           dtype=dtype),
        "fc2": init_linear(generator, 64, n_classes, bias=True, scale=0.1,
                           dtype=dtype),
    }


def apply_cnn1(p: Params, x: torch.Tensor) -> torch.Tensor:
    return _run(CNN1, p, x, p["c1"]["w"].shape[2], p["fc1"]["w"].shape[0],
                p["fc2"]["w"].shape[1])


def init_cnn2(generator: torch.Generator, image_shape, n_classes: int,
              dtype=torch.float32) -> Params:
    H, W, C = image_shape
    h, w = H // 4, W // 4
    return {
        "c1": init_conv(generator, 3, 3, C, 128, dtype),
        "c2": init_conv(generator, 3, 3, 128, 128, dtype),
        "fc": init_linear(generator, h * w * 128, n_classes, bias=True,
                          scale=0.02, dtype=dtype),
    }


def apply_cnn2(p: Params, x: torch.Tensor) -> torch.Tensor:
    return _run(CNN2, p, x, p["c1"]["w"].shape[2], p["fc"]["w"].shape[0],
                p["fc"]["w"].shape[1])


def init_vgg_small(generator: torch.Generator, image_shape, n_classes: int,
                   dtype=torch.float32) -> Params:
    C = image_shape[2]
    return {
        "c1": init_conv(generator, 3, 3, C, 32, dtype),
        "c2": init_conv(generator, 3, 3, 32, 64, dtype),
        "c3": init_conv(generator, 3, 3, 64, 128, dtype),
        "fc1": init_linear(generator, 128, 128, bias=True, scale=0.05,
                           dtype=dtype),
        "fc2": init_linear(generator, 128, n_classes, bias=True, scale=0.1,
                           dtype=dtype),
    }


def apply_vgg_small(p: Params, x: torch.Tensor) -> torch.Tensor:
    return _run(VGGSmall, p, x, p["c1"]["w"].shape[2], p["fc2"]["w"].shape[1])


def init_resnet_gn(generator: torch.Generator, image_shape, n_classes: int,
                   dtype=torch.float32) -> Params:
    """Small residual CNN with GroupNorm (the DP-compatible norm, §4.4)."""
    cin = image_shape[2]
    p: Params = {"stem": init_conv(generator, 3, 3, cin, RESNET_WIDTHS[0],
                                   dtype)}
    cin = RESNET_WIDTHS[0]
    for i, cout in enumerate(RESNET_WIDTHS):
        p[f"b{i}_c1"] = init_conv(generator, 3, 3, cin, cout, dtype)
        p[f"b{i}_n1"] = init_groupnorm(generator, cout, dtype)
        p[f"b{i}_c2"] = init_conv(generator, 3, 3, cout, cout, dtype)
        p[f"b{i}_n2"] = init_groupnorm(generator, cout, dtype)
        if cin != cout:
            p[f"b{i}_skip"] = init_conv(generator, 1, 1, cin, cout, dtype)
        cin = cout
    p["fc"] = init_linear(generator, cin, n_classes, bias=True, scale=0.1,
                          dtype=dtype)
    return p


def apply_resnet_gn(p: Params, x: torch.Tensor) -> torch.Tensor:
    return _run(ResNetGN, p, x, p["stem"]["w"].shape[2], p["fc"]["w"].shape[1])


MODELS = {
    "mlp": VisionModel("mlp", init_mlp_vision, apply_mlp_vision),
    "lenet5": VisionModel("lenet5", init_lenet5, apply_lenet5),
    "cnn1": VisionModel("cnn1", init_cnn1, apply_cnn1),
    "cnn2": VisionModel("cnn2", init_cnn2, apply_cnn2),
    "vgg": VisionModel("vgg", init_vgg_small, apply_vgg_small),
    "resnet_gn": VisionModel("resnet_gn", init_resnet_gn, apply_resnet_gn),
}


def get_vision_model(name: str) -> VisionModel:
    return MODELS[name]
