"""The port's ``run_federated`` for the single-model fig. 3 methods, run on
the JAX package's own fig. 3 data, initial state and draws, against the
reference's ``run_federated`` on the same configuration.

The data are the reference's ``benchmarks/common.py::federation_data``
arrays (the mnist stand-in, K = 3 clients of 50 examples) and the
configuration is fig. 3's (``bench_methods``: DP σ = 1, C = 1, epoch
mode), at B = 20 and 2 rounds, so each client takes 2 steps a round and
Joint 7. The reference runs as its ``bench_methods`` runs it by default
(``use_pallas=False``), the port as its fig. 3 driver does
(``use_pallas=True``, the kernels' plain versions on the CPU). The port
starts from the reference engine's initial state and replays its batch
indices and DP noise through the engine's replay hook, as
tests/test_torch_baselines.py does.

Grades: final params, Adam moments and every history row's per-client
test accuracy at the conformance ``close`` grade (atol 1e-5, rtol 1e-4);
epsilon exactly.

Run as a script, it repeats the comparison at fig. 3's quick cifar10
configuration, and also trains the port on the reference's arrays with
its own draws and on its own data (about 15 minutes on a CPU):

    PYTHONPATH=src:. JAX_PLATFORMS=cpu python tests/test_torch_baselines_replay.py
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import benchmarks.common as jax_common  # noqa: E402
import jax  # noqa: E402

from repro.configs.base import DPConfig as JaxDPConfig  # noqa: E402
from repro.configs.base import ProxyFLConfig as JaxProxyFLConfig  # noqa: E402
from repro.core import baselines as jax_baselines  # noqa: E402
from repro.core import engine as jax_engine  # noqa: E402
from repro.core.dp import _flat_gaussian_like  # noqa: E402
from repro_torch.configs import DPConfig, ProxyFLConfig  # noqa: E402
from repro_torch.core import baselines  # noqa: E402
from repro_torch.benchmarks import common  # noqa: E402
from repro_torch.nn.modules import tree_leaves  # noqa: E402
from test_torch_baselines import export, to_port, to_torch  # noqa: E402

CLOSE = dict(atol=1e-5, rtol=1e-4)


def replay_run_federated(method, dataset, n_clients, rounds, seed, *,
                         n_train_factor, batch_size):
    """``method`` through the reference's ``run_federated`` and the port's,
    both on the reference's ``federation_data(dataset, ...)``; the port
    from the reference engine's initial state and on its draws. Returns
    (port result, reference result)."""
    jdata, jtest, d = jax_common.federation_data(
        dataset, n_clients, seed, n_train_factor=n_train_factor)
    knobs = dict(alpha=0.5, beta=0.5, n_clients=n_clients, rounds=rounds,
                 batch_size=batch_size, seed=seed)
    dp = dict(enabled=True, noise_multiplier=1.0, clip_norm=1.0)
    jcfg = JaxProxyFLConfig(dp=JaxDPConfig(**dp), use_pallas=False, **knobs)
    tcfg = ProxyFLConfig(dp=DPConfig(**dp), use_pallas=True, **knobs)
    jspec = jax_common.spec_of("mlp", d["shape"], d["n_classes"])
    tspec = common.spec_of("mlp", d["shape"], d["n_classes"])

    made = []

    def capture(*args, **kwargs):
        made.append(jax_engine.single_model_engine(*args, **kwargs))
        return made[-1]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_baselines, "single_model_engine", capture)
        want = jax_baselines.run_federated(
            method, [jspec] * n_clients, jspec, jdata, jtest, jcfg,
            seed=seed, eval_every=1)
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

    port_engine = baselines.single_model_engine

    def replay_engine(*args, **kwargs):
        eng = port_engine(*args, draws=draws, **kwargs)
        eng.init_states = lambda _seed: to_port(init)
        return eng

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(baselines, "single_model_engine", replay_engine)
        got = baselines.run_federated(
            method, [tspec] * n_clients, tspec, to_torch(jdata),
            to_torch([jtest])[0], tcfg, seed=seed, eval_every=1,
            device="cpu")
    return got, want


def assert_runs_close(got, want):
    assert got["epsilon"] == want["epsilon"]
    assert [r["round"] for r in got["history"]] == \
        [r["round"] for r in want["history"]]
    for row, ref_row in zip(got["history"], want["history"]):
        assert sorted(row) == sorted(ref_row) == ["acc", "round"]
        np.testing.assert_allclose(row["acc"], ref_row["acc"], **CLOSE)
    assert len(got["clients"]) == len(want["clients"])
    for c, rc in zip(got["clients"], want["clients"]):
        for a_tree, b_tree in ((c.params, rc.params), (c.opt.m, rc.opt.m),
                               (c.opt.v, rc.opt.v)):
            la, lb = tree_leaves(a_tree), jax.tree_util.tree_leaves(b_tree)
            assert len(la) == len(lb)
            for x, y in zip(la, lb):
                np.testing.assert_allclose(x.numpy(), np.asarray(y), **CLOSE)
        assert int(c.opt.t) == int(rc.opt.t)
        assert c.accountant.steps == rc.accountant.steps


@pytest.mark.parametrize("method", sorted(baselines._SINGLE_MIX))
def test_run_federated_on_reference_data_and_draws(method):
    got, want = replay_run_federated(method, "mnist", 3, 2, 0,
                                     n_train_factor=0.05, batch_size=20)
    steps = 7 if method == "joint" else 2
    assert all(c.accountant.steps == 2 * steps for c in got["clients"])
    assert_runs_close(got, want)


def reference_arrays(dataset, n_clients, seed, *, n_train_factor=1.0,
                     device="cpu"):
    """The reference's ``federation_data`` as CPU tensors, in the port's
    ``federation_data`` signature."""
    data, test, d = jax_common.federation_data(
        dataset, n_clients, seed, n_train_factor=n_train_factor)
    return to_torch(data), to_torch([test])[0], d


def main():
    """Fig. 3's quick cifar10 (4 clients of 1,200 examples, 3 rounds,
    B = 250, seeds 0-4) for FedAvg, Regular and AvgPush on the reference's
    arrays: the reference's run beside the port's on the reference's
    initial state and draws, then the port's on its own draws; last the
    port on its own data, drawn on the CPU. One JSON line per method and
    run."""
    for method in ("fedavg", "regular", "avgpush"):
        jax_accs, port_accs, acc_diff, param_diff = [], [], 0.0, 0.0
        for seed in range(5):
            got, want = replay_run_federated(method, "cifar10", 4, 3, seed,
                                             n_train_factor=0.4,
                                             batch_size=250)
            ga, wa = got["history"][-1]["acc"], want["history"][-1]["acc"]
            port_accs += ga
            jax_accs += wa
            acc_diff = max(acc_diff, float(np.abs(np.subtract(ga, wa)).max()))
            for c, rc in zip(got["clients"], want["clients"]):
                for x, y in zip(tree_leaves(c.params),
                                jax.tree_util.tree_leaves(rc.params)):
                    param_diff = max(param_diff, float(
                        np.abs(x.numpy() - np.asarray(y)).max()))
            assert got["epsilon"] == want["epsilon"]
        print(json.dumps(dict(
            method=method, run="reference", acc_mean=np.mean(jax_accs),
            acc_std=np.std(jax_accs))), flush=True)
        print(json.dumps(dict(
            method=method, run="port on the reference's draws",
            acc_mean=np.mean(port_accs), acc_std=np.std(port_accs),
            max_acc_diff=acc_diff, max_param_diff=param_diff)), flush=True)
        quick = dict(n_clients=4, rounds=3, seeds=range(5),
                     n_train_factor=0.4, device="cpu")
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(common, "federation_data", reference_arrays)
            (row,) = common.bench_methods("cifar10", (method,), **quick)
        print(json.dumps(dict(method=method, run="port on its own draws",
                              acc_mean=row["acc_mean"],
                              acc_std=row["acc_std"])), flush=True)
        (row,) = common.bench_methods("cifar10", (method,), **quick)
        print(json.dumps(dict(method=method,
                              run="port on its own data drawn on the CPU",
                              acc_mean=row["acc_mean"],
                              acc_std=row["acc_std"])), flush=True)


if __name__ == "__main__":
    main()
