"""The JAX package's ``shard_map`` backend at K > 1 on a forced multi-device
CPU host, for ``tests/test_torch_shard_map.py``.

    XLA_FLAGS=--xla_force_host_platform_device_count=4 \\
        python tests/jax_shard_reference.py JOB OUT

JOB is a pickle of one federation: ``knobs`` (``ProxyFLConfig`` keywords,
DP on), the mlp's input ``shape`` and ``n_classes``, the clients' numpy
``data``, ``seed``, ``plan`` (the round-blocks ``(t0, T)``) and
``accountant`` (sigma, q, delta) and ``init``, the K clients' initial
states (numpy). The run: ``dml_engine``'s step and init functions on
``FederationEngine(backend="shard_map")`` over a ``("clients",)`` mesh of K
devices, from ``init``, base key ``PRNGKey(seed)``.
OUT receives a pickle of the exported client states, each block's metrics
and the accountants' epsilons, as numpy. The flag must reach this process
only: the test process sees one device (``tests/test_system.py``).
"""
import pickle
import sys

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh

from repro.configs.base import DPConfig, ProxyFLConfig
from repro.core import engine
from repro.core.accountant import PrivacyAccountant
from repro.core.protocol import ModelSpec
from repro.nn.vision import get_vision_model


def main(job_path: str, out_path: str) -> None:
    with open(job_path, "rb") as f:
        job = pickle.load(f)
    cfg = ProxyFLConfig(dp=DPConfig(enabled=True), **job["knobs"])
    vm = get_vision_model("mlp")
    shape, n_classes = tuple(job["shape"]), job["n_classes"]
    spec = ModelSpec("mlp", lambda k: vm.init(k, shape, n_classes), vm.apply)
    K = len(job["data"])
    like = engine.dml_engine((spec,) * K, spec, cfg, backend="vmap")
    # a Mesh's axes are Auto (``jax.make_mesh`` makes them Explicit, and
    # the engine's vmap over the unsharded data then refuses to trace)
    mesh = Mesh(np.array(jax.devices()[:K]), ("clients",))
    eng = engine.FederationEngine(
        cfg, n_clients=K, step_fns=like.step_fns[0],
        init_fns=like.init_fns[0], sample_fn=like.sample_fn,
        backend="shard_map", mix=job.get("mix", "pushsum"), mesh=mesh,
        axis="clients")
    eng.attach_accountants([PrivacyAccountant(*job["accountant"])
                            for _ in range(K)])
    key = jax.random.PRNGKey(job["seed"])
    data = [(jnp.asarray(x), jnp.asarray(y)) for x, y in job["data"]]
    state = engine.stack_states([jax.tree_util.tree_map(jnp.asarray, s)
                                 for s in job["init"]])
    metrics = []
    for t0, T in job["plan"]:
        state, m = eng.run_rounds(state, data, t0, T, key)
        metrics.append({k: np.asarray(v) for k, v in m.items()})
    out = {"states": [jax.tree_util.tree_map(np.asarray, s)
                      for s in eng.export_states(state)],
           "metrics": metrics,
           "eps": [a.epsilon() for a in eng.accountants]}
    with open(out_path, "wb") as f:
        pickle.dump(out, f)


if __name__ == "__main__":
    main(*sys.argv[1:3])
