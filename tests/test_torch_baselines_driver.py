"""The port's driver of the single-model fig. 3 methods (FedAvg, AvgPush,
CWT, Regular, Joint) against the JAX package; ProxyFL and FML's twin is
in tests/test_torch_fig3.py.

* ``run_federated`` for each method on ``device="cpu"`` against the
  reference's ``run_federated`` on the same configuration (K = 3 clients
  of 40 examples, mlp on 6x6x1 with 4 classes, B = 8 in epoch mode, DP on,
  2 rounds evaluated every round): epsilons exactly equal, the same
  history keys and row count, the reference's client record types; CWT
  at staleness > 0 refused by both.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from test_torch_threads import one_torch_thread  # noqa: E402,F401
import jax  # noqa: E402

from repro.configs.base import DPConfig as JaxDPConfig  # noqa: E402
from repro.configs.base import ProxyFLConfig as JaxProxyFLConfig  # noqa: E402
from repro.core import baselines as jax_baselines  # noqa: E402
from repro.core.protocol import ModelSpec as JaxModelSpec  # noqa: E402
from repro.nn.vision import get_vision_model as jax_vision  # noqa: E402
from repro_torch.configs import DPConfig, ProxyFLConfig  # noqa: E402
from repro_torch.core import baselines  # noqa: E402
from repro_torch.core.protocol import ClientState, ModelSpec  # noqa: E402
from repro_torch.nn.vision import get_vision_model  # noqa: E402

K, N, SHAPE, C, B, ROUNDS = 3, 40, (6, 6, 1), 4, 8, 2


def _setup(**knobs):
    rng = np.random.default_rng(0)
    data = [(rng.standard_normal((N,) + SHAPE).astype(np.float32),
             rng.integers(0, C, N).astype(np.int32)) for _ in range(K)]
    test = (rng.standard_normal((30,) + SHAPE).astype(np.float32),
            rng.integers(0, C, 30).astype(np.int32))
    jv, tv = jax_vision("mlp"), get_vision_model("mlp")
    jspec = JaxModelSpec("mlp", lambda k: jv.init(k, SHAPE, C), jv.apply)
    tspec = ModelSpec("mlp", lambda g: tv.init(g, SHAPE, C), tv.apply)
    cfg = dict(n_clients=K, rounds=ROUNDS, batch_size=B, **knobs)
    jcfg = JaxProxyFLConfig(dp=JaxDPConfig(enabled=True), **cfg)
    tcfg = ProxyFLConfig(dp=DPConfig(enabled=True), **cfg)
    jdata = [(jax.numpy.asarray(x), jax.numpy.asarray(y)) for x, y in data]
    tdata = [(torch.as_tensor(x), torch.as_tensor(y).long())
             for x, y in data]
    return (jspec, jdata, tuple(jax.numpy.asarray(t) for t in test), jcfg,
            tspec, tdata, tuple(torch.as_tensor(t) for t in test), tcfg)


def check_driver(method):
    """The port's ``run_federated(method)`` against the reference's."""
    jspec, jdata, jtest, jcfg, tspec, tdata, ttest, tcfg = _setup()
    want = jax_baselines.run_federated(method, [jspec] * K, jspec, jdata,
                                       jtest, jcfg, seed=0)
    got = baselines.run_federated(method, [tspec] * K, tspec, tdata, ttest,
                                  tcfg, seed=0, device="cpu")
    assert got["epsilon"] == want["epsilon"]
    assert all(e is not None and e > 0 for e in got["epsilon"])
    assert [sorted(r) for r in got["history"]] == \
        [sorted(r) for r in want["history"]]
    assert [r["round"] for r in got["history"]] == [1, 2]
    for row, ref_row in zip(got["history"], want["history"]):
        for key in set(row) - {"round"}:
            assert len(row[key]) == len(ref_row[key])
            assert all(0.0 <= a <= 1.0 for a in row[key])
    assert len(got["clients"]) == len(want["clients"])
    single = method not in ("proxyfl", "fml")
    kind = baselines.SingleModelClient if single else ClientState
    assert all(isinstance(c, kind) for c in got["clients"])
    assert type(want["clients"][0]).__name__ == kind.__name__
    assert [c.accountant.steps for c in got["clients"]] == \
        [c.accountant.steps for c in want["clients"]]


@pytest.mark.parametrize("method", sorted(baselines._SINGLE_MIX))
def test_run_federated_matches_reference_driver(method):
    check_driver(method)


def test_joint_takes_local_steps_times_k():
    """Joint's one client takes ``local_steps × K`` steps a round, on every
    client's data pooled, and its accountant samples at B / n_pooled."""
    jspec, jdata, jtest, jcfg, tspec, tdata, ttest, tcfg = _setup(
        local_steps=2)
    got = baselines.run_federated("joint", [tspec] * K, tspec, tdata, ttest,
                                  tcfg, device="cpu")
    want = jax_baselines.run_federated("joint", [jspec] * K, jspec, jdata,
                                       jtest, jcfg)
    (acc,) = [c.accountant for c in got["clients"]]
    assert acc.steps == ROUNDS * 2 * K
    assert acc.sample_rate == B / (K * N)
    assert got["epsilon"] == want["epsilon"]


@pytest.mark.parametrize("driver", ["port", "reference"])
def test_cwt_refused_at_positive_staleness(driver):
    jspec, jdata, jtest, jcfg, tspec, tdata, ttest, tcfg = _setup(
        staleness=2, local_steps=1)
    with pytest.raises(ValueError, match="ring"):
        if driver == "port":
            baselines.run_federated("cwt", [tspec] * K, tspec, tdata, ttest,
                                    tcfg, backend="async", device="cpu")
        else:
            jax_baselines.run_federated("cwt", [jspec] * K, jspec, jdata,
                                        jtest, jcfg, backend="async")


def test_single_model_methods_run_async_at_positive_staleness():
    *_, tspec, tdata, ttest, tcfg = _setup(staleness=2, local_steps=1)
    res = baselines.run_federated("avgpush", [tspec] * K, tspec, tdata,
                                  ttest, tcfg, backend="async", device="cpu")
    assert sorted(res["history"][-1]) == ["acc", "round"]
    assert all(c.accountant.steps == ROUNDS for c in res["clients"])


def test_unknown_method_refused():
    *_, tspec, tdata, ttest, tcfg = _setup()
    with pytest.raises(ValueError, match="unknown method"):
        baselines.run_federated("scaffold", [tspec] * K, tspec, tdata, ttest,
                                tcfg, device="cpu")


