"""The JAX package's mesh round programs (``repro.launch.steps``'s
``make_fl_round_step``, ``make_round_block_step`` and
``make_hier_round_block_step``) on a forced multi-device CPU host, for
``tests/test_torch_mesh_steps.py``.

    XLA_FLAGS=--xla_force_host_platform_device_count=4 \\
        python tests/jax_mesh_reference.py JOB OUT

JOB is a pickle of the inputs (the architecture, its dtype, the clients'
numpy states, batches and base keys, the block's n_rounds and t0); OUT
receives a pickle of each program's new stacked state and metrics as
numpy. The flag must reach this process only: the test process sees one
device (``tests/test_system.py``).
"""
import pickle
import sys

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh

from repro.configs import get_config
from repro.configs.base import DPConfig, ProxyFLConfig
from repro.configs.registry import proxy_of, smoke_variant
from repro.launch import steps

# each op rounded to its dtype; LLVM unoptimised (tests/test_torch_train_step.py)
XLA_OPTIONS = {"xla_allow_excess_precision": False,
               "xla_backend_optimization_level": 0}


def _stack(trees):
    return jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *trees)


def _run(fn, *args):
    out = jax.jit(fn).lower(*args).compile(XLA_OPTIONS)(*args)
    return jax.tree_util.tree_map(np.asarray, out)


def main(job_path: str, out_path: str) -> None:
    with open(job_path, "rb") as f:
        job = pickle.load(f)
    cfg = smoke_variant(get_config(job["arch"])).with_(dtype=job["dtype"])
    proxy = smoke_variant(proxy_of(cfg))
    fl = ProxyFLConfig(dp=DPConfig(enabled=True), batch_size=job["batch"])
    opts = steps.StepOptions(remat=False, **job["opts"])
    n_pods, L = job["pods"], job["clients_per_pod"]
    mesh = Mesh(np.array(jax.devices()[:n_pods]), ("pod",))
    states = [jax.tree_util.tree_map(jnp.asarray, s) for s in job["states"]]
    batches = [jax.tree_util.tree_map(jnp.asarray, b) for b in job["batches"]]
    keys = jnp.asarray(np.stack(job["keys"]), jnp.uint32)
    T, t0 = job["n_rounds"], job["t0"]
    flat = (_stack(states[:n_pods]), _stack(batches[:n_pods]), keys[:n_pods])
    out = {
        "fl": _run(steps.make_fl_round_step(cfg, proxy, fl, mesh, n_pods,
                                            opts, round_t=t0), *flat),
        "block": _run(steps.make_round_block_step(
            cfg, proxy, fl, mesh, n_pods, opts, n_rounds=T, t0=t0), *flat),
        "hier": _run(steps.make_hier_round_block_step(
            cfg, proxy, fl, mesh, n_pods, L, opts, n_rounds=T, t0=t0),
            _stack(states), _stack(batches), keys),
    }
    with open(out_path, "wb") as f:
        pickle.dump(out, f)


if __name__ == "__main__":
    main(*sys.argv[1:3])
