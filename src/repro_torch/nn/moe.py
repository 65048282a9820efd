"""Mixture-of-Experts FFN with sort-based capacity dispatch (port of
``src/repro/nn/moe.py``).

Tokens are sorted by expert (a stable sort, so a full expert keeps its
earliest tokens, as ``argsort(stable=True)`` does in the reference) and
placed into [E, C] capacity slots; the expert products are plain batched
matmuls. Top-k takes the lower expert index first among equal
probabilities, as ``lax.top_k`` does (a stable descending sort, since
``torch.topk`` promises no order among ties). DeepSeek-style shared experts
and Arctic-style dense residual MLPs add to the routed output.

The combine adds each token's k expert outputs with ``index_add``: on the
CPU in order, on CUDA by atomics in any order, so a bf16 run there is not
bit-reproducible from run to run. Every op is out of place and reads no
value on the host, so ``torch.func.vmap`` batches the layer per example
(the capacity then comes from one example's tokens, as under the
reference's ``vmap``).
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig, MoEConfig
from .modules import Params, init_mlp, mlp, normal_init


def init_moe(generator: torch.Generator, cfg: ModelConfig,
             dtype=torch.float32) -> Params:
    mo = cfg.moe or MoEConfig()
    d, E, f = cfg.d_model, mo.n_experts, mo.d_ff_expert
    p = {
        "router": normal_init(generator, (d, E), 0.02, torch.float32),
        "gate": normal_init(generator, (E, d, f), 0.02, dtype),
        "up": normal_init(generator, (E, d, f), 0.02, dtype),
        "down": normal_init(generator, (E, f, d), 0.02, dtype),
    }
    if mo.n_shared_experts:
        p["shared"] = init_mlp(generator, d, mo.n_shared_experts * f, dtype)
    if mo.dense_residual_d_ff:
        p["residual"] = init_mlp(generator, d, mo.dense_residual_d_ff, dtype)
    return p


def capacity(n_tokens: int, mo: MoEConfig) -> int:
    return max(1, int(-(-n_tokens * mo.top_k * mo.capacity_factor
                        // mo.n_experts)))


def top_k(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest of each row, lower index first among ties."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def apply_moe(p: Params, cfg: ModelConfig,
              x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B, S, d] -> (y [B, S, d], aux_loss scalar)."""
    mo = cfg.moe or MoEConfig()
    B, S, d = x.shape
    T, E, K = B * S, mo.n_experts, mo.top_k
    C = capacity(T, mo)
    xf = x.reshape(T, d)
    dev = x.device

    logits = xf.to(torch.float32) @ p["router"]
    probs = torch.softmax(logits, dim=-1)   # [T, E]
    topw, topi = top_k(probs, K)   # [T, K]
    topw = topw / torch.clamp(topw.sum(-1, keepdim=True), min=1e-9)

    # load-balance auxiliary loss (Switch-style); one-hot rows by
    # comparison (F.one_hot reads its input's range on the host, which
    # torch.func.vmap cannot batch)
    experts = torch.arange(E, device=dev)
    frac_tokens = torch.mean(
        (topi[..., None] == experts).to(torch.float32).sum(1), dim=0) / K
    frac_probs = torch.mean(probs, dim=0)
    aux = mo.router_aux_loss_coef * E * torch.sum(frac_tokens * frac_probs)

    # sort-based dispatch into [E, C] capacity slots
    flat_e = topi.reshape(-1)   # [T*K]
    flat_t = torch.arange(T * K, device=dev) // K
    flat_w = topw.reshape(-1)
    order = torch.sort(flat_e, stable=True).indices
    se, st, sw = flat_e[order], flat_t[order], flat_w[order]
    counts = (flat_e[:, None] == experts).sum(0)
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(T * K, device=dev) - starts[se]
    keep = pos < C

    slot_c = torch.where(keep, pos, 0)
    src = xf[st] * keep[:, None].to(x.dtype)
    be = torch.zeros((E, C, d), dtype=x.dtype, device=dev).index_put(
        (se, slot_c), src, accumulate=True)
    h = F.silu(torch.einsum("ecd,edf->ecf", be, p["gate"])) * torch.einsum(
        "ecd,edf->ecf", be, p["up"])
    ye = torch.einsum("ecf,efd->ecd", h, p["down"])

    w = (sw * keep).to(x.dtype)
    yf = torch.zeros((T, d), dtype=x.dtype, device=dev).index_add(
        0, st, ye[se, slot_c] * w[:, None])

    y = yf.reshape(B, S, d)
    if "shared" in p:
        y = y + mlp(p["shared"], x)
    if "residual" in p:
        y = y + mlp(p["residual"], x)
    return y, aux
