"""Carry weights across frameworks: numpy trees in the reference's layout
to the port's tensors.

The caller turns jax arrays into numpy first (``jax.tree_util.tree_map(
np.asarray, tree)``); the port never sees a jax array. With these both
frameworks can start a run from the same numbers:

* :func:`params_from_numpy` — a nested dict of arrays (one param tree);
* :func:`state_from_numpy` — one client's engine state ``{"private":
  {"params", "opt": AdamState(m, v, t, p32)}, "proxy": …, "w"[, "t"]}``,
  the optimizer state given as any 4-field ``(m, v, t, p32)`` tuple, as
  the reference's ``AdamState`` NamedTuple is (``p32``, the f32 master
  copy of sub-f32 params, when present; ``"t"``, the LLM train state's
  step count, when present);
* :func:`async_state_from_numpy` — the engine's wrapper state, ``{"clients":
  [per-client state, …]}`` with the async backend's in-flight buffers
  ``"stale_theta"`` [τ, K, D] and ``"stale_w"`` [τ, K] at staleness τ>0
  and the compressed exchange's public copies ``"ef_state"`` [K, D], so a
  run can start with mail in flight and copies that lag;
* :func:`model_params_from_numpy` and :func:`cache_from_numpy` — an LLM's
  params and KV/SSM caches (``init_model`` / ``init_cache`` trees: dicts
  and tuples, stacked ``[R, …]`` leaves), bf16 leaves included (numpy's
  ``ml_dtypes`` bfloat16 carried bit for bit).
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from .nn.modules import tree_map
from .optim import AdamState


def tensor_from_numpy(a, device="cpu") -> torch.Tensor:
    """One array as a tensor of its own dtype; a bfloat16 array (numpy has
    none of its own: ``ml_dtypes``) moves by its bits."""
    a = np.array(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(
            torch.bfloat16).to(device)
    return torch.as_tensor(a, device=device)


def params_from_numpy(tree, device="cpu") -> Dict:
    return tree_map(lambda a: tensor_from_numpy(a, device), tree)


# an LLM's param tree and KV/SSM caches (nn.model's init_model and
# init_cache layouts: dicts and tuples, stacked [R, ...] leaves)
model_params_from_numpy = cache_from_numpy = params_from_numpy


def _adam_from_numpy(opt, device) -> AdamState:
    m, v, t, p32 = opt
    return AdamState(params_from_numpy(m, device), params_from_numpy(v, device),
                     torch.as_tensor(np.array(t, np.int32), device=device),
                     None if p32 is None else params_from_numpy(p32, device))


def state_from_numpy(state: Dict, device="cpu") -> Dict:
    """One client's engine state, for the two-model (DML) engine."""
    out: Dict[str, Any] = {
        role: {"params": params_from_numpy(state[role]["params"], device),
               "opt": _adam_from_numpy(state[role]["opt"], device)}
        for role in ("private", "proxy") if role in state}
    out["w"] = torch.as_tensor(np.array(state["w"], np.float32),
                               device=device)
    if "t" in state:
        out["t"] = torch.as_tensor(np.array(state["t"], np.int32),
                                   device=device)
    return out


def async_state_from_numpy(state: Dict, device="cpu") -> Dict:
    """The wrapper state: each client through :func:`state_from_numpy`,
    every other entry (buffers, public copies) as a tensor in its own
    dtype."""
    out = {key: torch.as_tensor(np.array(value), device=device)
           for key, value in state.items() if key != "clients"}
    out["clients"] = [state_from_numpy(s, device) for s in state["clients"]]
    return out

