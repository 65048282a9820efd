"""Functional Adam on tensor dicts (port of ``src/repro/optim/optimizers.py``),
not ``torch.optim``: the update takes and returns param trees, so the fused
DP kernel can take over its tail. Matches ``torch.optim.Adam`` with
additive L2 weight decay (the paper's lr 1e-3, weight decay 1e-4), not
AdamW. This slice ports the f32 update path; f32 master copies (``p32``) of
sub-f32 params and non-f32 moments are not ported yet (ROADMAP.md Queue 1
item 6).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, NamedTuple, Tuple

import torch

from ..nn.modules import tree_leaves, tree_map

Params = Any


class AdamState(NamedTuple):
    m: Params
    v: Params
    t: torch.Tensor  # 0-d int32 step count, on the params' device
    p32: Params = None  # always None in this slice


@dataclass(frozen=True)
class Adam:
    lr: float = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    moment_dtype: str = "float32"
    master_weights: bool = True

    def _check(self, params: Params) -> None:
        if self.moment_dtype != "float32":
            raise NotImplementedError(
                "Adam moment_dtype other than float32 is not ported yet "
                "(ROADMAP.md Queue 1 item 6)")
        if self.master_weights and any(x.dtype != torch.float32
                                       for x in tree_leaves(params)):
            raise NotImplementedError(
                "Adam on sub-f32 params needs the f32 master copy p32, "
                "which is not ported yet (ROADMAP.md Queue 1 item 6)")

    def init(self, params: Params) -> AdamState:
        self._check(params)
        zeros = lambda p: tree_map(torch.zeros_like, p)  # noqa: E731
        device = tree_leaves(params)[0].device
        return AdamState(zeros(params), zeros(params),
                         torch.zeros((), dtype=torch.int32, device=device),
                         None)

    def update(self, grads: Params, state: AdamState, params: Params
               ) -> Tuple[Params, AdamState]:
        self._check(params)
        t = state.t + 1
        b1, b2 = self.b1, self.b2
        if self.weight_decay:
            grads = tree_map(lambda g, p: g + self.weight_decay * p.to(g.dtype),
                             grads, params)
        gf = tree_map(lambda g: g.to(torch.float32), grads)
        m = tree_map(lambda m, g: b1 * m + (1 - b1) * g, state.m, gf)
        v = tree_map(lambda v, g: b2 * v + (1 - b2) * g * g, state.v, gf)
        tf = t.to(torch.float32)
        c1 = 1 - b1 ** tf
        c2 = 1 - b2 ** tf

        def upd32(p, m, v):
            step = self.lr * (m / c1) / (torch.sqrt(v / c2) + self.eps)
            return p - step

        new_params = tree_map(upd32, params, m, v)
        return new_params, AdamState(m, v, t, None)
