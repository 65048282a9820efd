"""The port's modules against the JAX package on the same inputs: tree
layout and wire vector, losses, mlp logits and evaluation, one Adam
update, the accountant, the gossip schedules, the partitioner and the
PushSum exchange; and the port's own data generators.

Grades: array-equal where the computation is the same code (numpy schedule
functions, the pure-Python accountant, the leaf order), the conformance
``close`` grade (atol 1e-5, rtol 1e-4, tests/test_conformance.py) for
float paths whose summation order differs between the frameworks.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from test_torch_threads import one_torch_thread  # noqa: E402,F401
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import accountant as jax_accountant  # noqa: E402
from repro.core import gossip as jax_gossip  # noqa: E402
from repro.core.protocol import ModelSpec as JaxModelSpec  # noqa: E402
from repro.core.protocol import evaluate as jax_evaluate  # noqa: E402
from repro.data.partition import partition_major as jax_partition_major  # noqa: E402
from repro.nn import losses as jax_losses  # noqa: E402
from repro.nn import modules as jax_modules  # noqa: E402
from repro.nn.modules import tree_flatten_vector as jax_flatten  # noqa: E402
from repro.nn.vision import get_vision_model as jax_vision  # noqa: E402
from repro.optim.optimizers import Adam as JaxAdam  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import accountant, gossip  # noqa: E402
from repro_torch.core.protocol import ModelSpec, evaluate, evaluate_batched  # noqa: E402
from repro_torch.data.loader import sample_batch  # noqa: E402
from repro_torch.data.partition import partition_major  # noqa: E402
from repro_torch.data.synthetic import make_classification_data  # noqa: E402
from repro_torch.nn import losses  # noqa: E402
from repro_torch.nn.modules import (tree_bytes, tree_flatten_vector,  # noqa: E402
                                    tree_global_norm, tree_leaves,
                                    tree_size, tree_unflatten_vector)
from repro_torch.nn.vision import get_vision_model  # noqa: E402
from repro_torch.optim import Adam  # noqa: E402

CLOSE = dict(atol=1e-5, rtol=1e-4)
SHAPE, N_CLASSES = (14, 14, 1), 10


@pytest.fixture(scope="module")
def jax_mlp():
    return jax_vision("mlp").init(jax.random.PRNGKey(0), SHAPE, N_CLASSES)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def test_leaf_order_and_wire_vector(jax_mlp):
    params = convert.params_from_numpy(_np(jax_mlp))
    paths = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_flatten_with_path(jax_mlp)[0]]
    assert paths == ["['fc1']['b']", "['fc1']['w']", "['fc2']['b']",
                     "['fc2']['w']", "['fc3']['b']", "['fc3']['w']"]
    for ours, theirs in zip(tree_leaves(params),
                            jax.tree_util.tree_leaves(jax_mlp)):
        np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))
    flat = tree_flatten_vector(params)
    np.testing.assert_array_equal(flat.numpy(), np.asarray(jax_flatten(jax_mlp)))
    back = tree_unflatten_vector(flat, params)
    for a, b in zip(tree_leaves(back), tree_leaves(params)):
        assert torch.equal(a, b)
    assert tree_size(params) == jax_modules.tree_size(jax_mlp) == 81_610
    assert tree_bytes(params) == jax_modules.tree_bytes(jax_mlp)
    np.testing.assert_allclose(float(tree_global_norm(params)),
                               float(jax_modules.tree_global_norm(jax_mlp)),
                               **CLOSE)


def test_mlp_logits_from_jax_params(jax_mlp):
    x = np.random.default_rng(0).standard_normal((16,) + SHAPE,
                                                 dtype=np.float32)
    want = jax_vision("mlp").apply(jax_mlp, jnp.asarray(x))
    got = get_vision_model("mlp").apply(convert.params_from_numpy(
        _np(jax_mlp)), torch.as_tensor(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **CLOSE)


def test_evaluate_matches_reference(jax_mlp):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((700,) + SHAPE, dtype=np.float32)
    y = rng.integers(0, N_CLASSES, 700)
    jv, tv = jax_vision("mlp"), get_vision_model("mlp")
    want = jax_evaluate(JaxModelSpec("mlp", None, jv.apply), jax_mlp,
                        jnp.asarray(x), jnp.asarray(y))
    spec = ModelSpec("mlp", None, tv.apply)
    params = convert.params_from_numpy(_np(jax_mlp))
    xt, yt = torch.as_tensor(x), torch.as_tensor(y)
    assert evaluate(spec, params, xt, yt) == want
    stacked = {k: {kk: torch.stack([v, v]) for kk, v in d.items()}
               for k, d in params.items()}
    assert evaluate_batched(spec, stacked, xt, yt) == [want, want]


def test_losses():
    rng = np.random.default_rng(1)
    own = rng.standard_normal((32, N_CLASSES), dtype=np.float32) * 3
    peer = rng.standard_normal((32, N_CLASSES), dtype=np.float32) * 3
    y = rng.integers(0, N_CLASSES, 32)
    J = lambda a: jnp.asarray(a)  # noqa: E731
    T = lambda a: torch.as_tensor(a)  # noqa: E731
    pairs = [
        (losses.cross_entropy(T(own), T(y)),
         jax_losses.cross_entropy(J(own), J(y))),
        (losses.kl_divergence(T(own), T(peer)),
         jax_losses.kl_divergence(J(own), J(peer))),
        (losses.dml_loss(T(own), T(peer), T(y), 0.3),
         jax_losses.dml_loss(J(own), J(peer), J(y), 0.3)),
        (losses.accuracy(T(own), T(y)), jax_losses.accuracy(J(own), J(y))),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **CLOSE)
    # KL(own || peer), not the reverse: swapping the arguments changes it
    assert not np.isclose(float(losses.kl_divergence(T(own), T(peer))),
                          float(jax_losses.kl_divergence(J(peer), J(own))))


def test_dml_loss_detaches_the_peer():
    own = torch.randn(4, N_CLASSES, requires_grad=True)
    peer = torch.randn(4, N_CLASSES, requires_grad=True)
    losses.dml_loss(own, peer, torch.tensor([0, 1, 2, 3]), 0.5).backward()
    assert peer.grad is None and own.grad is not None


def test_adam_update(jax_mlp):
    rng = np.random.default_rng(2)
    grads = jax.tree_util.tree_map(
        lambda x: jnp.asarray(rng.standard_normal(x.shape, dtype=np.float32)),
        jax_mlp)
    jopt = JaxAdam(lr=1e-3, weight_decay=1e-4)
    jstate = jopt.init(jax_mlp)
    jp, jstate = jopt.update(grads, jstate, jax_mlp)
    jp, jstate = jopt.update(grads, jstate, jp)   # a second, non-sign-like step

    params = convert.params_from_numpy(_np(jax_mlp))
    tgrads = convert.params_from_numpy(_np(grads))
    opt = Adam(lr=1e-3, weight_decay=1e-4)
    state = opt.init(params)
    p, state = opt.update(tgrads, state, params)
    p, state = opt.update(tgrads, state, p)
    assert int(state.t) == int(jstate.t) == 2
    for ours, theirs in zip(tree_leaves((p, state.m, state.v)),
                            jax.tree_util.tree_leaves((jp, jstate.m,
                                                       jstate.v))):
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), **CLOSE)


@pytest.mark.parametrize("q", [0.01, 0.25, 1.0])
@pytest.mark.parametrize("sigma", [0.7, 1.0, 2.0])
def test_epsilon_exact(q, sigma):
    for steps in (1, 8, 400):
        for delta in (1e-5, 1e-3):
            kw = dict(noise_multiplier=sigma, sample_rate=q, steps=steps,
                      delta=delta)
            assert accountant.epsilon_for(**kw) == \
                jax_accountant.epsilon_for(**kw)


@pytest.mark.parametrize("K", [1, 2, 3, 8])
def test_gossip_schedules_array_equal(K):
    for t in range(6):
        np.testing.assert_array_equal(gossip.adjacency_matrix(t, K),
                                      jax_gossip.adjacency_matrix(t, K))
        for mix in ("pushsum", "mean", "ring", "none"):
            np.testing.assert_array_equal(gossip.mix_matrix(mix, t, K),
                                          jax_gossip.mix_matrix(mix, t, K))
    assert gossip.exponential_offsets(K) == jax_gossip.exponential_offsets(K)


def test_partition_major_array_equal():
    y = np.random.default_rng(3).integers(0, 10, 4_000)
    ours = partition_major(np.random.default_rng(4), y, 8, 200, 0.8, 10)
    theirs = jax_partition_major(np.random.default_rng(4), y, 8, 200, 0.8, 10)
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a, b)


def test_sample_batch_and_synthetic_data():
    gen = torch.Generator().manual_seed(0)
    x, y = make_classification_data(gen, 500, SHAPE, N_CLASSES, sep=2.0,
                                    task_seed=3)
    assert x.shape == (500,) + SHAPE and x.dtype == torch.float32
    assert y.shape == (500,) and 0 <= int(y.min()) and int(y.max()) < 10
    again = make_classification_data(torch.Generator().manual_seed(0), 500,
                                     SHAPE, N_CLASSES, sep=2.0, task_seed=3)
    assert torch.equal(x, again[0]) and torch.equal(y, again[1])
    # the class means come from task_seed alone: the same class has the
    # same mean under another sampling generator
    x2, y2 = make_classification_data(torch.Generator().manual_seed(1),
                                      5_000, SHAPE, N_CLASSES, sep=2.0,
                                      task_seed=3, noise=0.0)
    c = int(y2[0])
    np.testing.assert_allclose(x2[y2 == c].mean(0).numpy(),
                               x2[0].numpy(), **CLOSE)
    xb, yb = sample_batch(torch.Generator().manual_seed(2), x, y, 64)
    assert xb.shape == (64,) + SHAPE and yb.shape == (64,)
    hits = (xb.reshape(64, 1, -1) == x.reshape(1, 500, -1)).all(-1)
    assert bool(hits.any(1).all())        # every row is a row of x


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("K", [1, 4, 8])
def test_pushsum_mix_raw_and_debias(use_pallas, K):
    rng = np.random.default_rng(K + 100)
    flat = rng.standard_normal((K, 3_001), dtype=np.float32)
    w = (rng.random(K) + 0.5).astype(np.float32)
    P = gossip.mix_matrix("pushsum", 2, K)
    zj, wj = jax_gossip.pushsum_mix(
        jnp.asarray(flat), jnp.asarray(w), jnp.asarray(P, jnp.float32),
        use_pallas=use_pallas, interpret=True)
    zt, wt = gossip.pushsum_mix(torch.as_tensor(flat), torch.as_tensor(w), P,
                                use_pallas=use_pallas)
    np.testing.assert_allclose(zt.numpy(), np.asarray(zj), **CLOSE)
    np.testing.assert_allclose(wt.numpy(), np.asarray(wj), **CLOSE)
    np.testing.assert_allclose(gossip.debias(zt, wt).numpy(),
                               np.asarray(jax_gossip.debias(zj, wj)), **CLOSE)


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("K", [1, 4, 8])
def test_pushsum_mix_debiased(use_pallas, K):
    rng = np.random.default_rng(K)
    flat = rng.standard_normal((K, 3_001), dtype=np.float32)
    w = (rng.random(K) + 0.5).astype(np.float32)
    P = gossip.mix_matrix("pushsum", 1, K)
    zj, wj = jax_gossip.pushsum_mix_debiased(
        jnp.asarray(flat), jnp.asarray(w), jnp.asarray(P, jnp.float32),
        use_pallas=use_pallas, interpret=True)
    zt, wt = gossip.pushsum_mix_debiased(torch.as_tensor(flat),
                                         torch.as_tensor(w), P,
                                         use_pallas=use_pallas)
    np.testing.assert_allclose(zt.numpy(), np.asarray(zj), **CLOSE)
    np.testing.assert_allclose(wt.numpy(), np.asarray(wj), **CLOSE)
