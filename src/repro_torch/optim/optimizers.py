"""Functional optimizers on tensor dicts (port of
``src/repro/optim/optimizers.py``), not ``torch.optim``: the update takes
and returns param trees, so the fused DP kernel can take over its tail.
Adam matches ``torch.optim.Adam`` with additive L2 weight decay (the
paper's lr 1e-3, weight decay 1e-4), not AdamW.

Params below f32 (the registry's bf16 models) get an f32 master copy
``AdamState.p32``: the update runs on it and the params are its rounding.
Without it a bf16 weight near 1.0 (resolution ~8e-3) cannot absorb a 1e-3
step at all. ``moment_dtype="bfloat16"`` stores the moments in bf16 and
updates them in f32, as the reference does.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, NamedTuple, Tuple

import torch

from ..nn.modules import torch_dtype, tree_leaves, tree_map

Params = Any


class AdamState(NamedTuple):
    m: Params
    v: Params
    t: torch.Tensor  # 0-d int32 step count, on the params' device
    # f32 master copy of sub-f32 params (None when every param is f32)
    p32: Params = None


@dataclass(frozen=True)
class Adam:
    lr: float = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    moment_dtype: str = "float32"
    master_weights: bool = True

    def _needs_master(self, params: Params) -> bool:
        return self.master_weights and any(
            x.dtype != torch.float32 for x in tree_leaves(params))

    def init(self, params: Params) -> AdamState:
        md = torch_dtype(self.moment_dtype)
        zeros = lambda p: tree_map(  # noqa: E731
            lambda x: torch.zeros(x.shape, dtype=md, device=x.device), p)
        p32 = None
        if self._needs_master(params):
            # a copy, also of the leaves already in f32: the master copy
            # never aliases the params it rounds to
            p32 = tree_map(lambda x: x.to(torch.float32, copy=True), params)
        device = tree_leaves(params)[0].device
        return AdamState(zeros(params), zeros(params),
                         torch.zeros((), dtype=torch.int32, device=device),
                         p32)

    def update(self, grads: Params, state: AdamState, params: Params
               ) -> Tuple[Params, AdamState]:
        t = state.t + 1
        b1, b2 = self.b1, self.b2
        md = torch_dtype(self.moment_dtype)
        f32 = torch.float32
        base = state.p32 if state.p32 is not None else params
        if self.weight_decay:
            grads = tree_map(lambda g, p: g + self.weight_decay * p.to(g.dtype),
                             grads, base)
        gf = tree_map(lambda g: g.to(f32), grads)
        m = tree_map(lambda m, g: (b1 * m.to(f32) + (1 - b1) * g).to(md),
                     state.m, gf)
        v = tree_map(lambda v, g: (b2 * v.to(f32) + (1 - b2) * g * g).to(md),
                     state.v, gf)
        tf = t.to(f32)
        c1 = 1 - b1 ** tf
        c2 = 1 - b2 ** tf

        def upd32(p, m, v):
            step = self.lr * (m.to(f32) / c1) / (
                torch.sqrt(v.to(f32) / c2) + self.eps)
            return p.to(f32) - step

        new32 = tree_map(upd32, base, m, v)
        new_params = tree_map(lambda n, p: n.to(p.dtype), new32, params)
        p32 = new32 if state.p32 is not None else None
        return new_params, AdamState(m, v, t, p32)


@dataclass(frozen=True)
class SGD:
    lr: float = 0.1
    weight_decay: float = 0.0

    def init(self, params: Params):
        return ()

    def update(self, grads: Params, state, params: Params):
        if self.weight_decay:
            grads = tree_map(lambda g, p: g + self.weight_decay * p.to(g.dtype),
                             grads, params)
        new = tree_map(
            lambda p, g: (p.to(torch.float32)
                          - self.lr * g.to(torch.float32)).to(p.dtype),
            params, grads)
        return new, state
