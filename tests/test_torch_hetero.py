"""Heterogeneous private architectures (paper fig. 5b) in the port against
the JAX package: ProxyFL and FML whose clients hold an mlp, a lenet5, a
cnn1 and a cnn2 private model around one mlp proxy.

The reference runs ``repro.core.baselines.run_federated`` on its
``"auto"`` backend, which is its per-client ``loop`` for a heterogeneous
cohort (``use_pallas=False``, as its figure drivers run it); the port runs
its own ``run_federated`` with ``use_pallas=True`` (the kernels' plain
versions on the CPU), from the reference engine's initial state and on its
batch indices and DP noise, replayed through the engine's ``draws`` hook
from the reference's key schedule (``round_key`` -> ``fold_in(·, k)`` ->
``split(·, 3)`` per step). K = 4 clients of 40 examples of a 12×12×1,
10-class task, B = 20 in epoch mode (2 steps a round), DP σ = 1, C = 1, 2
rounds evaluated every round.

Grades: private and proxy params, Adam moments, de-bias weights and every
history row's per-client test accuracy at the conformance ``close`` grade
(atol 1e-5, rtol 1e-4); epsilon and accountant steps exactly. Also: the
engine's backend rule (``"auto"`` means the loop on a heterogeneous
cohort, ``"vmap"`` and ``"async"`` refuse it) and ``_eval_clients``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from test_torch_threads import one_torch_thread  # noqa: E402,F401
import jax  # noqa: E402

from repro.configs.base import DPConfig as JaxDPConfig  # noqa: E402
from repro.configs.base import ProxyFLConfig as JaxProxyFLConfig  # noqa: E402
from repro.core import baselines as jax_baselines  # noqa: E402
from repro.core import engine as jax_engine  # noqa: E402
from repro.core.dp import _flat_gaussian_like  # noqa: E402
from repro.core.protocol import ModelSpec as JaxModelSpec  # noqa: E402
from repro.data.synthetic import make_classification_data  # noqa: E402
from repro.nn.vision import get_vision_model as jax_vision  # noqa: E402
from repro_torch.configs import DPConfig, ProxyFLConfig  # noqa: E402
from repro_torch.core import baselines, engine  # noqa: E402
from repro_torch.core.protocol import ModelSpec, evaluate  # noqa: E402
from repro_torch.nn.modules import tree_leaves  # noqa: E402
from repro_torch.nn.vision import get_vision_model  # noqa: E402
from test_torch_baselines import export, to_port, to_torch  # noqa: E402

CLOSE = dict(atol=1e-5, rtol=1e-4)
ARCHS = ("mlp", "lenet5", "cnn1", "cnn2")
K, N, SHAPE, C, B, ROUNDS = 4, 40, (12, 12, 1), 10, 20, 2


def specs(archs, shape, n_classes):
    """Reference and port ModelSpecs, one per name of ``archs``."""
    jspecs, tspecs = [], []
    for a in archs:
        jv, tv = jax_vision(a), get_vision_model(a)
        jspecs.append(JaxModelSpec(
            a, lambda k, jv=jv: jv.init(k, shape, n_classes), jv.apply))
        tspecs.append(ModelSpec(
            a, lambda g, tv=tv: tv.init(g, shape, n_classes), tv.apply))
    return jspecs, tspecs


def replay(method, jspecs, jproxy, tspecs, tproxy, jdata, jtest, *,
           batch_size, rounds, seed=0, dp=None):
    """``method`` through the reference's ``run_federated`` and the
    port's on the same arrays, the port from the reference engine's
    initial state and on its draws. Returns (port result, reference
    result)."""
    dp = dict(enabled=True, noise_multiplier=1.0, clip_norm=1.0,
              **(dp or {}))
    knobs = dict(n_clients=len(jdata), rounds=rounds, batch_size=batch_size,
                 seed=seed)
    jcfg = JaxProxyFLConfig(dp=JaxDPConfig(**dp), use_pallas=False, **knobs)
    tcfg = ProxyFLConfig(dp=DPConfig(**dp), use_pallas=True, **knobs)
    factory = ("dml_engine" if method in ("proxyfl", "fml")
               else "single_model_engine")
    made = []

    def capture(*args, **kwargs):
        made.append(getattr(jax_engine, factory)(*args, **kwargs))
        return made[-1]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_baselines, factory, capture)
        want = jax_baselines.run_federated(
            method, jspecs, jproxy, jdata, jtest, jcfg, seed=seed,
            eval_every=1)
    (ref,) = made
    base = jax.random.PRNGKey(seed)
    init = export(ref, ref.init_states(base))
    theta_like = init[0]["proxy"]["params"]
    sizes = [int(x.shape[0]) for x, _ in jdata]
    if method == "joint":
        sizes = [sum(sizes)]

    def draws(k, t, s):
        ck = jax.random.fold_in(jax_engine.round_key(base, t), k)
        for _ in range(s + 1):
            ck, kb, kn = jax.random.split(ck, 3)
        idx = jax.random.randint(kb, (batch_size,), 0, sizes[k])
        return np.asarray(idx), np.asarray(_flat_gaussian_like(theta_like, kn))

    port_factory = getattr(baselines, factory)

    def replay_engine(*args, **kwargs):
        eng = port_factory(*args, draws=draws, **kwargs)
        eng.init_states = lambda _seed: to_port(init)
        return eng

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(baselines, factory, replay_engine)
        got = baselines.run_federated(
            method, tspecs, tproxy, to_torch(jdata), to_torch([jtest])[0],
            tcfg, seed=seed, eval_every=1, device="cpu")
    return got, want


def assert_runs_close(got, want):
    """Epsilons and accountant steps exact; history accuracies, params,
    Adam moments and de-bias weights at the ``close`` grade."""
    assert got["epsilon"] == want["epsilon"]
    assert [r["round"] for r in got["history"]] == \
        [r["round"] for r in want["history"]]
    for row, ref_row in zip(got["history"], want["history"]):
        assert sorted(row) == sorted(ref_row)
        for key in set(row) - {"round"}:
            np.testing.assert_allclose(row[key], ref_row[key], **CLOSE)
    assert len(got["clients"]) == len(want["clients"])
    roles = (("private_params", "private_opt"), ("proxy_params", "proxy_opt"))
    for c, rc in zip(got["clients"], want["clients"]):
        pairs = (roles if hasattr(c, "private_params")
                 else (("params", "opt"),))
        for p_name, o_name in pairs:
            p, o = getattr(c, p_name), getattr(c, o_name)
            rp, ro = getattr(rc, p_name), getattr(rc, o_name)
            for a_tree, b_tree in ((p, rp), (o.m, ro.m), (o.v, ro.v)):
                la, lb = tree_leaves(a_tree), jax.tree_util.tree_leaves(b_tree)
                assert len(la) == len(lb)
                for x, y in zip(la, lb):
                    np.testing.assert_allclose(x.numpy(), np.asarray(y),
                                               **CLOSE)
            assert int(o.t) == int(ro.t)
        if hasattr(c, "w"):
            np.testing.assert_allclose(c.w, float(rc.w), **CLOSE)
        assert c.accountant.steps == rc.accountant.steps


def hetero_data():
    x, y = make_classification_data(jax.random.PRNGKey(3), K * N + 60, SHAPE,
                                    C, sep=2.0)
    data = [(x[k * N:(k + 1) * N], y[k * N:(k + 1) * N]) for k in range(K)]
    return data, (x[K * N:], y[K * N:])


@pytest.mark.parametrize("method", ["proxyfl", "fml"])
def test_hetero_run_federated_matches_reference_loop(method):
    jdata, jtest = hetero_data()
    jspecs, tspecs = specs(ARCHS, SHAPE, C)
    (jproxy,), (tproxy,) = specs(("mlp",), SHAPE, C)
    got, want = replay(method, jspecs, jproxy, tspecs, tproxy, jdata, jtest,
                       batch_size=B, rounds=ROUNDS)
    assert all(c.accountant.steps == ROUNDS * N // B for c in got["clients"])
    assert_runs_close(got, want)


def _tiny_engine(backend, tspecs=None):
    tspecs = tspecs or specs(ARCHS, (8, 8, 1), 3)[1]
    (proxy,) = specs(("mlp",), (8, 8, 1), 3)[1]
    cfg = ProxyFLConfig(n_clients=len(tspecs), rounds=1, local_steps=1,
                        batch_size=4)
    return engine.dml_engine(tuple(tspecs), proxy, cfg, backend=backend,
                             device="cpu")


@pytest.mark.parametrize("backend,resolved", [("auto", "loop"),
                                              ("loop", "loop")])
def test_hetero_cohort_runs_on_the_loop(backend, resolved):
    eng = _tiny_engine(backend)
    assert eng.backend == resolved
    assert len({id(f) for f in eng.step_fns}) == len(ARCHS)
    homo = _tiny_engine("auto", specs(("cnn1",), (8, 8, 1), 3)[1] * 4)
    assert homo.backend == "vmap" and homo.stacked and not eng.stacked
    assert len({id(f) for f in homo.step_fns}) == 1


@pytest.mark.parametrize("backend", ["vmap", "async"])
def test_stacked_backends_refuse_a_hetero_cohort(backend):
    with pytest.raises(ValueError, match="homogeneous"):
        _tiny_engine(backend)
    jspecs, _ = specs(ARCHS, (8, 8, 1), 3)
    (jproxy,), _ = specs(("mlp",), (8, 8, 1), 3)
    jcfg = JaxProxyFLConfig(n_clients=4, rounds=1, local_steps=1,
                            batch_size=4)
    with pytest.raises(AssertionError, match="homogeneous"):
        jax_engine.dml_engine(tuple(jspecs), jproxy, jcfg, backend=backend)


def test_eval_clients_per_client_on_a_hetero_cohort():
    eng = _tiny_engine("auto")
    state = eng.init_states(0)
    gen = torch.Generator().manual_seed(1)
    xt = torch.randn((30, 8, 8, 1), generator=gen)
    yt = torch.randint(0, 3, (30,), generator=gen)
    _, tspecs = specs(ARCHS, (8, 8, 1), 3)
    got = baselines._eval_clients(eng, state, tspecs, "private", xt, yt)
    assert got == [evaluate(s, eng.client_params(state, k, "private"), xt, yt)
                   for k, s in enumerate(tspecs)]
