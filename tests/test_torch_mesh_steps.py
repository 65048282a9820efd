"""The port's mesh round programs (``repro_torch.launch.steps``'s
``make_fl_round_step``, ``make_round_block_step`` and
``make_hier_round_block_step``) on 2 gloo pods against the JAX package's on
a forced 4-device CPU mesh (its first 2 devices), from the same states, on
the same batches and DP noise.

qwen1.5-4b's smoke variant in f32, B = 4 × 8 tokens, DP on, from warm Adam
moments (``test_torch_train_step.reference_state``, a state per client);
the port with ``use_pallas=True`` (the wrappers' plain versions on the
CPU). The one-client programs hold clients 0 and 1, one a pod; the hier
block 2 pods × L = 2 clients. Rounds 0 and 1: K = 4's exponential shifts
1 and 2 split as q·L + r = 0·2 + 1 (two pod blocks, the r-row splice) and
1·2 + 0 (one). Every state leaf and loss at the conformance ``close``
grade (atol 1e-5, rtol 1e-4). The port's block equals its rounds run one
by one, bit for bit.

The ranks run in spawned processes (``tests/torch_shard_ranks.py``, a
``file://`` store, one torch thread each); the reference in one
subprocess with ``XLA_FLAGS=--xla_force_host_platform_device_count=4``
(``tests/jax_mesh_reference.py``), never in this process, which sees one
device. Both start once for the module and run side by side.
"""
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from test_torch_threads import one_torch_thread  # noqa: E402,F401
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torch_shard_ranks as ranks  # noqa: E402
from repro.core.dp import _flat_gaussian_like  # noqa: E402
from repro.core.gossip import gossip_shift  # noqa: E402
from repro_torch.convert import state_from_numpy  # noqa: E402
from repro_torch.nn.modules import tree_leaves  # noqa: E402
from test_torch_train_step import (assert_step_matches, batch_of,  # noqa: E402
                                   jax_cfgs, port_batch, reference_state,
                                   to_numpy)

HERE = Path(__file__).resolve().parent
ARCH, DTYPE = "qwen1.5-4b", "float32"
PODS, L, T, T0 = 2, 2, 2, 0
B, SEQ = 4, 8
OPTS = dict(accum=2, dp_chunk=2)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's three programs and the port's, on the same inputs."""
    tmp = tmp_path_factory.mktemp("mesh")
    K = PODS * L
    cfg, _ = jax_cfgs(ARCH, DTYPE)
    states = [to_numpy(reference_state(ARCH, DTYPE, seed=k))
              for k in range(K)]
    batches = [batch_of(cfg, n=B, seq=SEQ, seed=3 + k) for k in range(K)]
    keys = [np.asarray(jax.random.PRNGKey(100 + k)) for k in range(K)]
    theta = states[0]["proxy"]["params"]

    def noise(key):
        return torch.as_tensor(np.array(_flat_gaussian_like(theta, key)))

    job = dict(arch=ARCH, dtype=DTYPE, batch=B, opts=OPTS, pods=PODS,
               clients_per_pod=L, n_rounds=T, t0=T0, states=states,
               batches=batches, keys=keys)
    with open(tmp / "ref_job.pkl", "wb") as f:
        pickle.dump(job, f)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.pathsep.join([str(HERE.parent / "src"),
                                           os.environ.get("PYTHONPATH", "")]))
    ref = subprocess.Popen(
        [sys.executable, str(HERE / "jax_mesh_reference.py"),
         str(tmp / "ref_job.pkl"), str(tmp / "ref_out.pkl")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    port_job = dict(
        arch=ARCH, dtype=DTYPE, batch=B, opts=OPTS, clients_per_pod=L,
        n_rounds=T, t0=T0, states=[state_from_numpy(s) for s in states],
        batches=[port_batch(b) for b in batches],
        noise_fl=[noise(jnp.asarray(k)) for k in keys],
        noise_block=[torch.stack([noise(jax.random.fold_in(jnp.asarray(k),
                                                           T0 + i))
                                  for i in range(T)]) for k in keys])
    torch.save(port_job, tmp / "port_job.pt")
    ctx, out = ranks.spawn(PODS, str(tmp / "port_job.pt"), tmp,
                           fn=ranks._mesh_rank_main)
    ranks.join(ctx)
    log, _ = ref.communicate(timeout=600)
    assert ref.returncode == 0, log
    with open(tmp / "ref_out.pkl", "rb") as f:
        want = pickle.load(f)
    got = [torch.load(os.path.join(out, f"mesh.r{p}.pt"), weights_only=False)
           for p in range(PODS)]
    return dict(got=got, want=want, states=states)


def _client(tree, k):
    """Client k of a tree stacked over clients (numpy or torch leaves)."""
    return jax.tree_util.tree_map(lambda x: x[k], tree)


def _rows(tree, k):
    """Client k of a reference metric dict stacked [T, K]."""
    return {n: v[:, k] for n, v in tree.items()}


def test_the_rounds_split_the_shift_both_ways():
    """Rounds T0.. of the hier block take one and two pod blocks."""
    splits = {divmod(gossip_shift(T0 + i, PODS * L), L) for i in range(T)}
    assert {r > 0 for _, r in splits} == {True, False}


@pytest.mark.parametrize("pod", range(PODS))
def test_fl_round_step_matches_reference(runs, pod):
    state, metrics = runs["got"][pod]["fl"]
    w_state, w_metrics = runs["want"]["fl"]
    assert_step_matches((state, metrics),
                        (_client(w_state, pod), _client(w_metrics, pod)),
                        DTYPE, runs["states"][pod])


@pytest.mark.parametrize("pod", range(PODS))
def test_round_block_step_matches_reference(runs, pod):
    state, metrics = runs["got"][pod]["block"]
    w_state, w_metrics = runs["want"]["block"]
    assert metrics["proxy_loss"].shape == (T,)
    assert_step_matches((state, metrics),
                        (_client(w_state, pod), _rows(w_metrics, pod)),
                        DTYPE, runs["states"][pod])
    assert int(state["t"]) == T + int(runs["states"][pod]["t"])


@pytest.mark.parametrize("pod", range(PODS))
def test_round_block_is_its_rounds_bit_for_bit(runs, pod):
    (state, metrics), (s1, rows) = (runs["got"][pod]["block"],
                                    runs["got"][pod]["rounds"])
    for a, b in zip(tree_leaves(state), tree_leaves(s1)):
        assert torch.equal(a, b)
    for key, v in metrics.items():
        assert torch.equal(v, torch.stack([m[key] for m in rows]))


@pytest.mark.parametrize("client", range(PODS * L))
def test_hier_round_block_step_matches_reference(runs, client):
    pod, j = divmod(client, L)
    state, metrics = runs["got"][pod]["hier"]
    w_state, w_metrics = runs["want"]["hier"]
    assert metrics["proxy_loss"].shape == (T, L)
    assert_step_matches(
        (_client(state, j), {n: v[:, j] for n, v in metrics.items()}),
        (_client(w_state, client), _rows(w_metrics, client)),
        DTYPE, runs["states"][client])
