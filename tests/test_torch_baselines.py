"""The six other fig. 3 methods in the port against the JAX package: the
single-model CE step on its three branches, and two engine rounds of FML,
FedAvg, AvgPush, CWT, Regular and Joint.

Reference: ``repro.core.protocol.ce_step_fn`` and the JAX engine
(``dml_engine(..., mix="mean")`` for FML, ``single_model_engine`` with
the method's mix for the others, ``backend="vmap"``) with
``use_pallas=True`` (Pallas in interpret mode), K = 4 clients, mlp on
14x14x1 with 10 classes, B = 8, one local step per round, DP on. Joint is
one client on the four clients' data pooled in client order, taking
``local_steps × K`` = 4 steps a round, as ``run_federated`` sets it. The
port starts from the reference's initial state (``repro_torch.convert``)
and replays the reference's batch indices and DP noise through the
engine's replay hook, rebuilt from the reference's key schedule
(``round_key`` -> ``fold_in(·, k)`` -> ``split(·, 3)`` per step), as
tests/test_torch_slice.py does.

Grades: params, Adam moments and the de-bias weights at the conformance
``close`` grade (atol 1e-5, rtol 1e-4); epsilon exactly.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from test_torch_threads import one_torch_thread  # noqa: E402,F401
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import DPConfig as JaxDPConfig  # noqa: E402
from repro.configs.base import ProxyFLConfig as JaxProxyFLConfig  # noqa: E402
from repro.core import engine as jax_engine  # noqa: E402
from repro.core import protocol as jax_protocol  # noqa: E402
from repro.core.accountant import PrivacyAccountant as JaxAccountant  # noqa: E402
from repro.core.dp import _flat_gaussian_like  # noqa: E402
from repro.core.protocol import ModelSpec as JaxModelSpec  # noqa: E402
from repro.data.synthetic import make_classification_data  # noqa: E402
from repro.nn.vision import get_vision_model as jax_vision  # noqa: E402
from repro.optim import Adam as JaxAdam  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import DPConfig, ProxyFLConfig  # noqa: E402
from repro_torch.core import engine, protocol  # noqa: E402
from repro_torch.core.accountant import PrivacyAccountant  # noqa: E402
from repro_torch.core.protocol import ModelSpec  # noqa: E402
from repro_torch.nn.modules import tree_leaves  # noqa: E402
from repro_torch.nn.vision import get_vision_model  # noqa: E402

K, N_CLASSES, SHAPE, B, N_PER, ROUNDS = 4, 10, (14, 14, 1), 8, 300, 2
CLOSE = dict(atol=1e-5, rtol=1e-4)
SINGLE_MIX = {"fedavg": "mean", "avgpush": "pushsum", "cwt": "ring",
              "regular": "none", "joint": "none"}


def jax_spec():
    jv = jax_vision("mlp")
    return JaxModelSpec("mlp", lambda k: jv.init(k, SHAPE, N_CLASSES),
                        jv.apply)


def torch_spec():
    tv = get_vision_model("mlp")
    return ModelSpec("mlp", lambda g: tv.init(g, SHAPE, N_CLASSES), tv.apply)


def jax_client_data():
    x, y = make_classification_data(jax.random.PRNGKey(0), K * N_PER, SHAPE,
                                    N_CLASSES, sep=2.0)
    return [(x[i * N_PER:(i + 1) * N_PER], y[i * N_PER:(i + 1) * N_PER])
            for i in range(K)]


def to_torch(data):
    return [(torch.as_tensor(np.array(a)), torch.as_tensor(np.array(b)))
            for a, b in data]


def export(eng, state):
    """The reference engine's state as numpy: a per-client list, wrapped
    with both buffers on the stale async backend and with the public
    copies of a compressed exchange."""
    clients = [jax.tree_util.tree_map(np.asarray, s)
               for s in eng.export_states(state)]
    extra = {key: np.asarray(state[key])
             for key in ("stale_theta", "stale_w", "ef_state")
             if isinstance(state, dict) and key in state}
    return {"clients": clients, **extra} if extra else clients


def to_port(state):
    if isinstance(state, dict):
        return convert.async_state_from_numpy(state)
    return [convert.state_from_numpy(s) for s in state]


def clients_of(state):
    return state["clients"] if isinstance(state, dict) else state


def federation(method: str, backend: str = "vmap", rounds: int = ROUNDS,
               **knobs):
    """``rounds`` rounds of ``method`` in the JAX engine and in the port's,
    from the reference's initial state and on its draws."""
    jdata = jax_client_data()
    base_cfg = dict(n_clients=K, rounds=rounds, local_steps=1, batch_size=B,
                    use_pallas=True, **knobs)
    jcfg = JaxProxyFLConfig(dp=JaxDPConfig(enabled=True), **base_cfg)
    tcfg = ProxyFLConfig(dp=DPConfig(enabled=True), **base_cfg)
    if method == "joint":
        jdata = [(jnp.concatenate([d[0] for d in jdata]),
                  jnp.concatenate([d[1] for d in jdata]))]
        jcfg = dataclasses.replace(jcfg, local_steps=K)
        tcfg = dataclasses.replace(tcfg, local_steps=K)
    n_clients, n = len(jdata), jdata[0][0].shape[0]
    jspec, tspec = jax_spec(), torch_spec()
    if method == "fml":
        ref = jax_engine.dml_engine((jspec,) * K, jspec, jcfg,
                                    backend=backend, mix="mean")
    else:
        ref = jax_engine.single_model_engine(
            jspec, jcfg, True, mix=SINGLE_MIX[method], backend=backend,
            n_clients=n_clients)
    jaccs = [JaxAccountant(1.0, B / n, 1e-5) for _ in range(n_clients)]
    ref.attach_accountants(jaccs)
    base = jax.random.PRNGKey(0)
    jstate = ref.init_states(base)
    init = export(ref, jstate)
    jmetrics = []
    for t in range(rounds):
        jstate, m = ref.run_round(jstate, jdata, t,
                                  jax_engine.round_key(base, t))
        jmetrics.append({k: np.asarray(v) for k, v in m.items()})
    theta_like = clients_of(init)[0]["proxy"]["params"]

    def draws(k, t, s):
        """The reference's batch indices and DP noise of client k's local
        step s in round t."""
        ck = jax.random.fold_in(jax_engine.round_key(base, t), k)
        for _ in range(s + 1):
            ck, kb, kn = jax.random.split(ck, 3)
        idx = jax.random.randint(kb, (B,), 0, n)
        return np.asarray(idx), np.asarray(_flat_gaussian_like(theta_like, kn))

    if method == "fml":
        port = engine.dml_engine((tspec,) * K, tspec, tcfg, backend=backend,
                                 mix="mean", device="cpu", draws=draws)
    else:
        port = engine.single_model_engine(
            tspec, tcfg, True, mix=SINGLE_MIX[method], backend=backend,
            n_clients=n_clients, device="cpu", draws=draws)
    taccs = [PrivacyAccountant(1.0, B / n, 1e-5) for _ in range(n_clients)]
    port.attach_accountants(taccs)
    tstate, tmetrics = port.run_rounds(to_port(init), to_torch(jdata), 0,
                                       rounds, seed=0)
    masks = [engine.active_mask(t, n_clients, tcfg) for t in range(rounds)]
    return dict(jstate=export(ref, jstate), tstate=tstate, jaccs=jaccs,
                taccs=taccs, jmetrics=jmetrics, tmetrics=tmetrics,
                masks=masks, steps=tcfg.local_steps)


def assert_states_close(tstate, jstate):
    """Params, Adam moments and step counts of every role of every client,
    and the de-bias weights, at the ``close`` grade."""
    ours, theirs = clients_of(tstate), clients_of(jstate)
    assert len(ours) == len(theirs)
    for o, t in zip(ours, theirs):
        assert sorted(o) == sorted(t)
        for role in sorted(set(o) - {"w"}):
            a, b = o[role], t[role]
            for a_tree, b_tree in ((a["params"], b["params"]),
                                   (a["opt"].m, b["opt"].m),
                                   (a["opt"].v, b["opt"].v)):
                la, lb = tree_leaves(a_tree), jax.tree_util.tree_leaves(b_tree)
                assert len(la) == len(lb)
                for x, y in zip(la, lb):
                    np.testing.assert_allclose(x.numpy(), y, **CLOSE)
            assert int(a["opt"].t) == int(b["opt"].t)
    np.testing.assert_allclose([float(s["w"]) for s in ours],
                               [float(s["w"]) for s in theirs], **CLOSE)


def assert_epsilon_exact(r):
    assert [a.epsilon() for a in r["taccs"]] == \
        [a.epsilon() for a in r["jaccs"]]
    steps = [r["steps"] * sum(m is None or bool(m[k]) for m in r["masks"])
             for k in range(len(r["taccs"]))]
    assert [a.steps for a in r["taccs"]] == steps


def assert_metrics_close(r):
    ours = r["tmetrics"]   # run_rounds: each metric stacked [rounds, K]
    assert sorted(ours) == sorted(r["jmetrics"][0])
    for key in ours:
        want = np.stack([m[key] for m in r["jmetrics"]])
        assert ours[key].shape == want.shape
        np.testing.assert_array_equal(np.isnan(ours[key]), np.isnan(want))
        np.testing.assert_allclose(ours[key], want, **CLOSE)


# ---------------------------------------------------------------------------
# ce_step_fn: one step on each branch


@pytest.mark.parametrize("branch", ["dp_pallas", "dp_plain", "no_dp"])
def test_ce_step_matches_reference(branch):
    dp, pallas = branch != "no_dp", branch == "dp_pallas"
    knobs = dict(batch_size=B, use_pallas=pallas, lr=1e-2)
    jcfg = JaxProxyFLConfig(dp=JaxDPConfig(enabled=dp), **knobs)
    tcfg = ProxyFLConfig(dp=DPConfig(enabled=dp), **knobs)
    jspec, tspec = jax_spec(), torch_spec()
    x, y = jax_client_data()[0]
    batch = (x[:B], y[:B])
    key = jax.random.PRNGKey(3)
    params = jspec.init(jax.random.PRNGKey(1))
    jopt = JaxAdam(lr=1e-2, weight_decay=1e-4).init(params)
    jp, jo, jloss = jax_protocol.ce_step_fn(jspec, jcfg, dp)(
        params, jopt, batch, key)
    state = convert.state_from_numpy(
        {"proxy": {"params": jax.tree_util.tree_map(np.asarray, params),
                   "opt": jax.tree_util.tree_map(np.asarray, jopt)},
         "w": np.float32(1)})["proxy"]
    noise = torch.as_tensor(np.array(_flat_gaussian_like(params, key)))
    tp, to, tloss = protocol.ce_step_fn(tspec, tcfg, dp)(
        state["params"], state["opt"], to_torch([batch])[0],
        noise=noise if dp else None)
    np.testing.assert_allclose(float(tloss), float(jloss), **CLOSE)
    for a_tree, b_tree in ((tp, jp), (to.m, jo.m), (to.v, jo.v)):
        for a, b in zip(tree_leaves(a_tree), jax.tree_util.tree_leaves(b_tree)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **CLOSE)
    assert int(to.t) == int(jo.t) == 1
    # the step moved the params by lr-sized amounts, not a no-op
    moved = max(float(np.abs(a.numpy() - np.asarray(b)).max()) for a, b in
                zip(tree_leaves(tp), jax.tree_util.tree_leaves(params)))
    assert moved > 1e-3


# ---------------------------------------------------------------------------
# two engine rounds of each method


@pytest.fixture(scope="module",
                params=["fml", "fedavg", "avgpush", "cwt", "regular", "joint"])
def runs(request):
    return federation(request.param)


def test_params_moments_and_debias_weights_close(runs):
    assert_states_close(runs["tstate"], runs["jstate"])


def test_epsilon_exact(runs):
    assert_epsilon_exact(runs)


def test_losses_close(runs):
    assert_metrics_close(runs)


def test_state_layout(runs):
    """FML keeps two models a client; the single-model methods keep one,
    in the exchanged proxy slot."""
    want = ({"private", "proxy", "w"} if "private_loss" in runs["tmetrics"]
            else {"proxy", "w"})
    assert all(set(s) == want for s in runs["tstate"])
