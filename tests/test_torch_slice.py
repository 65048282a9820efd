"""The slice as a whole: two ProxyFL rounds in the port against the JAX
engine, from the same initial state and on the same random draws.

Reference: ``repro.core.engine.dml_engine(..., backend="vmap")`` with
``use_pallas=True`` (Pallas in interpret mode), K = 4 clients, mlp on
14x14x1 with 10 classes (the shapes of tests/test_conformance.py), B = 8,
one local step per round, DP on. The port starts from the reference's
initial state (``repro_torch.convert``) and replays the reference's batch
indices and DP noise through the engine's replay hook; the test rebuilds
those draws from the reference's key schedule (``round_key`` ->
``fold_in(·, k)`` -> ``split(·, 3)`` per step -> ``randint`` and
``_flat_gaussian_like``, as ``engine.py:1106-1123`` and
``protocol.py:75-83`` draw them).

Grades: params, Adam moments and the de-bias weights at the conformance
``close`` grade (atol 1e-5, rtol 1e-4); epsilon exactly.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from test_torch_threads import one_torch_thread  # noqa: E402,F401
import jax  # noqa: E402

from repro.configs.base import DPConfig as JaxDPConfig  # noqa: E402
from repro.configs.base import ProxyFLConfig as JaxProxyFLConfig  # noqa: E402
from repro.core import engine as jax_engine  # noqa: E402
from repro.core.accountant import PrivacyAccountant as JaxAccountant  # noqa: E402
from repro.core.dp import _flat_gaussian_like  # noqa: E402
from repro.core.protocol import ModelSpec as JaxModelSpec  # noqa: E402
from repro.data.synthetic import make_classification_data  # noqa: E402
from repro.nn.vision import get_vision_model as jax_vision  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import DPConfig, ProxyFLConfig  # noqa: E402
from repro_torch.core import engine  # noqa: E402
from repro_torch.core.accountant import PrivacyAccountant  # noqa: E402
from repro_torch.core.protocol import ModelSpec  # noqa: E402
from repro_torch.nn.modules import tree_leaves  # noqa: E402
from repro_torch.nn.vision import get_vision_model  # noqa: E402

K, N_CLASSES, SHAPE, B, N_PER, ROUNDS = 4, 10, (14, 14, 1), 8, 300, 2
CLOSE = dict(atol=1e-5, rtol=1e-4)
CFG = dict(n_clients=K, rounds=ROUNDS, local_steps=1, batch_size=B,
           use_pallas=True)


@pytest.fixture(scope="module")
def runs():
    x, y = make_classification_data(jax.random.PRNGKey(0), K * N_PER, SHAPE,
                                    N_CLASSES, sep=2.0)
    jdata = [(x[i * N_PER:(i + 1) * N_PER], y[i * N_PER:(i + 1) * N_PER])
             for i in range(K)]
    jv = jax_vision("mlp")
    jspec = JaxModelSpec("mlp", lambda k: jv.init(k, SHAPE, N_CLASSES),
                         jv.apply)
    jcfg = JaxProxyFLConfig(dp=JaxDPConfig(enabled=True), **CFG)
    ref = jax_engine.dml_engine((jspec,) * K, jspec, jcfg, backend="vmap")
    q = B / N_PER
    jaccs = [JaxAccountant(1.0, q, 1e-5) for _ in range(K)]
    ref.attach_accountants(jaccs)
    base = jax.random.PRNGKey(0)
    jstate = ref.init_states(base)
    init = [jax.tree_util.tree_map(np.asarray, s)
            for s in ref.export_states(jstate)]
    theta_like = init[0]["proxy"]["params"]
    jmetrics = []
    for t in range(ROUNDS):
        jstate, m = ref.run_round(jstate, jdata, t,
                                  jax_engine.round_key(base, t))
        jmetrics.append(m)

    def draws(k, t, s):
        """The reference's batch indices and DP noise of client k's local
        step s in round t."""
        ck = jax.random.fold_in(jax_engine.round_key(base, t), k)
        for _ in range(s + 1):
            ck, kb, kn = jax.random.split(ck, 3)
        idx = jax.random.randint(kb, (B,), 0, N_PER)
        return np.asarray(idx), np.asarray(_flat_gaussian_like(theta_like, kn))

    tv = get_vision_model("mlp")
    tspec = ModelSpec("mlp", lambda g: tv.init(g, SHAPE, N_CLASSES), tv.apply)
    tcfg = ProxyFLConfig(dp=DPConfig(enabled=True), **CFG)
    port = engine.dml_engine((tspec,) * K, tspec, tcfg, backend="vmap",
                             device="cpu", draws=draws)
    taccs = [PrivacyAccountant(1.0, q, 1e-5) for _ in range(K)]
    port.attach_accountants(taccs)
    tdata = [(torch.as_tensor(np.array(a)), torch.as_tensor(np.array(b)))
             for a, b in jdata]
    tstate = [convert.state_from_numpy(s) for s in init]
    tstate, tmetrics = port.run_rounds(tstate, tdata, 0, ROUNDS, seed=0)
    return dict(jstate=ref.export_states(jstate), tstate=tstate,
                jaccs=jaccs, taccs=taccs, jmetrics=jmetrics,
                tmetrics=tmetrics)


@pytest.mark.parametrize("role", ["private", "proxy"])
def test_params_and_moments_close(runs, role):
    for k in range(K):
        ours = runs["tstate"][k][role]
        theirs = runs["jstate"][k][role]
        pairs = [(ours["params"], theirs["params"]),
                 (ours["opt"].m, theirs["opt"].m),
                 (ours["opt"].v, theirs["opt"].v)]
        for o, t in pairs:
            for a, b in zip(tree_leaves(o), jax.tree_util.tree_leaves(t)):
                np.testing.assert_allclose(a.numpy(), np.asarray(b), **CLOSE)
        assert int(ours["opt"].t) == int(theirs["opt"].t) == ROUNDS


def test_debias_weights_close(runs):
    ours = np.asarray([float(s["w"]) for s in runs["tstate"]])
    theirs = np.asarray([float(s["w"]) for s in runs["jstate"]])
    np.testing.assert_allclose(ours, theirs, **CLOSE)


def test_epsilon_exact(runs):
    eps = [a.epsilon() for a in runs["taccs"]]
    assert eps == [a.epsilon() for a in runs["jaccs"]]
    assert all(a.steps == ROUNDS for a in runs["taccs"])


def test_losses_close(runs):
    ours = runs["tmetrics"]   # run_rounds: each metric stacked [ROUNDS, K]
    assert sorted(ours) == sorted(runs["jmetrics"][0])
    for k in ours:
        assert ours[k].shape == (ROUNDS, K)
        np.testing.assert_allclose(
            ours[k], np.stack([np.asarray(m[k]) for m in runs["jmetrics"]]),
            **CLOSE)
