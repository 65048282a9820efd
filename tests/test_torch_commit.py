"""Proxy commitments in the port (``repro_torch.core.commit``) against the
JAX package, and commitment verification of the loop backend's exchange.

* ``leaf_digest``, ``client_commitment``, ``chain_step``,
  ``snapshot_client_digests`` and ``flatten_with_paths``' key paths are
  string-equal to the reference's on the same values: an f32 tree, a bf16
  leaf (widened to f32 on both sides), an int32 leaf, a leaf of more than
  one 1 MiB chunk, NamedTuple and list nodes.
* Engine (``backend="loop"``, K = 4, mlp on 8x8x1, 2 rounds, DP on): a
  verified run is bit-identical to an unverified one; a bit flipped in
  flight (``bitflip_proxy``) is refused with ``CommitmentError`` naming
  the client and round; unverified, the same tamper makes the run diverge;
  ``"vmap"`` (the stacked executor) verifies nothing and takes no tamper,
  as in the reference (whose vmap round never calls
  ``_verified_exchange``): its run with both is the clean vmap run.
"""
from typing import NamedTuple

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from test_torch_threads import one_torch_thread  # noqa: E402,F401
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint.ckpt import flatten_with_paths as jax_flatten  # noqa: E402
from repro.core import commit as jax_commit  # noqa: E402
from repro_torch.configs import DPConfig, ProxyFLConfig  # noqa: E402
from repro_torch.core import commit  # noqa: E402
from repro_torch.core.attacks import bitflip_proxy  # noqa: E402
from repro_torch.core.baselines import run_federated  # noqa: E402
from repro_torch.core.commit import CommitmentError  # noqa: E402
from repro_torch.core.protocol import ModelSpec  # noqa: E402
from repro_torch.nn.modules import tree_leaves  # noqa: E402
from repro_torch.nn.vision import get_vision_model  # noqa: E402

K, SHAPE, N_CLASSES = 4, (8, 8, 1), 10


class Pair(NamedTuple):
    m: object
    v: object


def _trees():
    """The same values as a jax tree and a torch tree."""
    rng = np.random.default_rng(0)
    f32 = rng.normal(size=(3, 4)).astype(np.float32)
    bias = rng.normal(size=(5,)).astype(np.float32)
    bf = np.asarray(jnp.asarray(rng.normal(size=(7,)), jnp.bfloat16)
                    .astype(jnp.float32))
    ints = rng.integers(-5, 5, size=(2, 3)).astype(np.int32)
    big = rng.normal(size=(300_000,)).astype(np.float32)   # two chunks
    jt = {"fc": {"w": jnp.asarray(f32), "b": jnp.asarray(bias)},
          "norm": {"g": jnp.asarray(bf, jnp.bfloat16)},
          "steps": jnp.asarray(ints),
          "big": jnp.asarray(big),
          "opt": Pair(jnp.asarray(bias), [jnp.asarray(f32)])}
    tt = {"fc": {"w": torch.tensor(f32), "b": torch.tensor(bias)},
          "norm": {"g": torch.tensor(bf).to(torch.bfloat16)},
          "steps": torch.tensor(ints),
          "big": torch.tensor(big),
          "opt": Pair(torch.tensor(bias), [torch.tensor(f32)])}
    return jt, tt


def test_paths_and_leaf_digests_string_equal():
    jt, tt = _trees()
    ours, theirs = commit.flatten_with_paths(tt), jax_flatten(jt)
    assert list(ours) == list(theirs)
    for path in ours:
        assert commit.leaf_digest(ours[path]) == \
            jax_commit.leaf_digest(theirs[path]), path
        assert commit.canon_array(ours[path]).dtype == \
            jax_commit.canon_array(theirs[path]).dtype
    assert commit.canon_array(tt["norm"]["g"]).dtype == np.float32
    for chunk in (64, 1 << 20):
        assert commit.leaf_digest(tt["big"], chunk) == \
            jax_commit.leaf_digest(jt["big"], chunk)


def test_client_commitment_and_chain_string_equal():
    jt, tt = _trees()
    digest, leaves = commit.client_commitment(tt)
    jdigest, jleaves = jax_commit.client_commitment(jt)
    assert (digest, leaves) == (jdigest, jleaves)
    clients = {commit.CLIENT_KEY_FMT.format(k): digest for k in range(3)}
    h = commit.GENESIS
    jh = jax_commit.GENESIS
    for t in range(3):
        h = commit.chain_step(h, t + 1, 3, clients)
        jh = jax_commit.chain_step(jh, t + 1, 3, clients)
        assert h == jh
    # a flipped bit changes the commitment
    tt["fc"]["w"][0, 0] = torch.nextafter(tt["fc"]["w"][0, 0],
                                          torch.tensor(np.inf))
    assert commit.client_commitment(tt)[0] != jdigest


def test_snapshot_digests_string_equal():
    jt, tt = _trees()
    arrays = {}
    for k in range(2):
        for path, leaf in jax_flatten(jt).items():
            arrays[f"clients/c{k:04d}/proxy/params/{path}"] = np.asarray(
                leaf.astype(jnp.float32) if leaf.dtype == jnp.bfloat16
                else leaf)
    arrays["clients/c0000/private/params/w"] = np.zeros(3, np.float32)
    ours = commit.snapshot_client_digests(arrays, 2)
    assert ours == jax_commit.snapshot_client_digests(arrays, 2)
    assert ours[0]["c0001"] == commit.client_commitment(tt)[0]
    assert commit.npz_client_leaves(arrays, 0).keys() == \
        jax_commit.npz_client_leaves(arrays, 0).keys()


def test_commitment_error_carries_its_location():
    err = CommitmentError("x", round=3, leaf="fc/w", client=2)
    assert isinstance(err, ValueError)
    assert (err.round, err.leaf, err.client) == (3, "fc/w", 2)
    with pytest.raises(ValueError, match="duplicate"):
        commit.flatten_with_paths({"a": {"b": torch.ones(1)},
                                   "a/b": torch.ones(1)})


def _run(backend, verify, tamper=None):
    vm = get_vision_model("mlp")
    spec = ModelSpec("mlp", lambda g: vm.init(g, SHAPE, N_CLASSES), vm.apply)
    rng = np.random.default_rng(0)
    data = [(torch.as_tensor(rng.standard_normal((40,) + SHAPE,
                                                 dtype=np.float32)),
             torch.as_tensor(rng.integers(0, N_CLASSES, 40)))
            for _ in range(K)]
    cfg = ProxyFLConfig(n_clients=K, rounds=2, batch_size=8, local_steps=1,
                        use_pallas=True, verify_commitments=verify,
                        dp=DPConfig(enabled=True))
    res = run_federated("proxyfl", [spec] * K, spec, data, data[0], cfg,
                        backend=backend, device="cpu",
                        transmit_tamper=tamper)
    return [leaf for c in res["clients"]
            for leaf in tree_leaves((c.private_params, c.proxy_params))]


@pytest.fixture(scope="module")
def clean_loop():
    return _run("loop", False)


def test_verified_run_is_bit_identical(clean_loop):
    verified = _run("loop", True)
    assert len(verified) == len(clean_loop)
    assert all(torch.equal(a, b) for a, b in zip(verified, clean_loop))


def test_tampered_run_is_refused():
    with pytest.raises(CommitmentError, match="client 1 at round 1") as err:
        _run("loop", True, bitflip_proxy(1, bit=22, index=5, rounds=(1,)))
    assert (err.value.client, err.value.round) == (1, 1)


def test_unverified_tampered_run_diverges(clean_loop):
    tampered = _run("loop", False, bitflip_proxy(2, bit=22, index=5))
    assert not all(torch.equal(a, b) for a, b in zip(tampered, clean_loop))


def test_vmap_does_not_verify():
    """As in the reference, only the loop backend verifies (and takes the
    tamper): the vmap run with both is the clean vmap run."""
    got = _run("vmap", True, bitflip_proxy(1, bit=22, index=5))
    clean = _run("vmap", False)
    assert len(got) == len(clean)
    assert all(torch.equal(a, b) for a, b in zip(got, clean))
