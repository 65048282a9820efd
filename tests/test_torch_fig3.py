"""ProxyFL and FML through the port's ``run_federated`` against the
reference's (as tests/test_torch_baselines_driver.py holds the
single-model methods), ``macro_accuracy``, and the port's fig. 3 harness
against the JAX package's.

* ``macro_accuracy`` against the reference's on seeded logits, a class
  absent from the labels included.
* ``repro_torch.benchmarks``: ``task_seed_of``, the dataset entries and
  ``partition_major`` equal to the reference's, ``bench_methods`` rows
  with the reference's keys and epsilons, fig. 3's two configurations
  equal to the reference's, the Dirichlet datasets' ragged cohorts
  (shapes, sizes, a pool of ``per_client · K`` with no 2× over-draw), the
  ordering's verdicts, and the command line at a tiny size on the CPU.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from test_torch_threads import one_torch_thread  # noqa: E402,F401
import benchmarks.common as jax_common  # noqa: E402
import benchmarks.fig3_accuracy as jax_fig3  # noqa: E402

from repro.data import partition as jax_partition  # noqa: E402
from repro.nn import losses as jax_losses  # noqa: E402
from repro_torch.benchmarks import common, fig3_accuracy  # noqa: E402
from repro_torch.data.partition import partition_major  # noqa: E402
from repro_torch.nn.losses import macro_accuracy  # noqa: E402
from test_torch_baselines_driver import check_driver  # noqa: E402


@pytest.mark.parametrize("method", ["proxyfl", "fml"])
def test_run_federated_matches_reference_driver(method):
    check_driver(method)


# ---------------------------------------------------------------------------
# macro_accuracy


@pytest.mark.parametrize("n,n_classes,absent", [(50, 4, None), (64, 10, 3),
                                                (7, 5, 0)])
def test_macro_accuracy_matches_reference(n, n_classes, absent):
    rng = np.random.default_rng(n)
    logits = rng.standard_normal((n, n_classes)).astype(np.float32)
    labels = rng.integers(0, n_classes, n)
    if absent is not None:
        labels[labels == absent] = (absent + 1) % n_classes
        assert absent not in labels
    want = float(jax_losses.macro_accuracy(logits, labels, n_classes))
    got = float(macro_accuracy(torch.as_tensor(logits),
                               torch.as_tensor(labels), n_classes))
    assert got == pytest.approx(want, abs=1e-7)


# ---------------------------------------------------------------------------
# repro_torch.benchmarks


@pytest.mark.parametrize("dataset", sorted(jax_common.DATASETS))
def test_task_seed_and_dataset_entry_equal_reference(dataset):
    assert common.task_seed_of(dataset) == jax_common.task_seed_of(dataset)
    assert common.DATASETS[dataset] == jax_common.DATASETS[dataset]


@pytest.mark.parametrize("n_clients,per_client,p_major",
                         [(4, 30, 0.8), (8, 25, 0.3), (3, 40, 0.1)])
def test_partition_major_equals_reference(n_clients, per_client, p_major):
    y = np.random.default_rng(per_client).integers(0, 10, 2 * n_clients
                                                   * per_client)
    ours = partition_major(np.random.default_rng(5), y, n_clients,
                           per_client, p_major, 10)
    theirs = jax_partition.partition_major(np.random.default_rng(5), y,
                                           n_clients, per_client, p_major, 10)
    assert len(ours) == len(theirs) == n_clients
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a, b)


def test_bench_methods_rows_have_the_reference_keys():
    kw = dict(n_clients=2, rounds=1, seeds=(0,), n_train_factor=0.01)
    ours = common.bench_methods("mnist", ("proxyfl", "fedavg"),
                                device="cpu", **kw)
    theirs = jax_common.bench_methods("mnist", ("proxyfl", "fedavg"), **kw)
    assert [r["method"] for r in ours] == [r["method"] for r in theirs] == \
        ["proxyfl", "proxyfl-proxy", "fedavg"]
    assert [list(r) for r in ours] == [list(r) for r in theirs]
    assert [r["epsilon"] for r in ours] == [r["epsilon"] for r in theirs]


def test_federation_data_shapes():
    data, (xt, yt), d = common.federation_data("mnist", 3, 1,
                                               n_train_factor=0.02,
                                               device="cpu")
    assert [tuple(x.shape) for x, _ in data] == [(20, 28, 28, 1)] * 3
    assert tuple(xt.shape) == (1000, 28, 28, 1) and yt.shape == (1000,)
    assert all(int(y.max()) < d["n_classes"] for _, y in data)


@pytest.mark.parametrize("dataset,n_clients", [("kvasir", 8),
                                                ("camelyon", 4)])
def test_dirichlet_federation_data_shapes(dataset, n_clients):
    """Every example of a ``per_client · K`` pool goes to one client, each
    client at least one, at the dataset's image size; the sizes are
    ragged."""
    data, (xt, yt), d = common.federation_data(dataset, n_clients, 0,
                                               n_train_factor=0.1,
                                               device="cpu")
    per_client = int(d["per_client"] * 0.1)
    sizes = [x.shape[0] for x, _ in data]
    assert len(data) == n_clients and min(sizes) >= 1
    assert sum(sizes) == per_client * n_clients and len(set(sizes)) > 1
    assert all(tuple(x.shape[1:]) == d["shape"] and y.shape == x.shape[:1]
               and int(y.max()) < d["n_classes"] for x, y in data)
    assert tuple(xt.shape) == (1000,) + d["shape"] and yt.shape == (1000,)
    labels = torch.cat([y for _, y in data]).numpy()
    assert sorted(set(labels.tolist())) == list(range(d["n_classes"]))


@pytest.mark.parametrize("full", [False, True])
def test_fig3_configurations_equal_reference(monkeypatch, full):
    def record(calls):
        def fake(ds, methods, **kw):
            kw.pop("device", None)
            kw["seeds"] = list(kw["seeds"])
            calls.append((ds, tuple(methods), kw))
            return []
        return fake

    ours, theirs = [], []
    monkeypatch.setattr(jax_fig3, "bench_methods", record(theirs))
    monkeypatch.setattr(fig3_accuracy, "bench_methods", record(ours))
    jax_fig3.run(full)
    fig3_accuracy.run(full, device="cpu")
    assert set(fig3_accuracy.METHODS) == set(jax_fig3.METHODS)
    # the port runs one method a call, so its rows print as each finishes
    merged = {}
    for ds, methods, kw in ours:
        assert len(methods) == 1
        prev = merged.setdefault(ds, (methods, kw))
        if prev[1] is not kw:
            assert prev[1] == kw
            merged[ds] = (prev[0] + methods, kw)
    assert [(ds, m, kw) for ds, (m, kw) in merged.items()] == theirs


def test_ordering_marks_each_link():
    """Every link of the claimed ordering, per dataset, met or missed on
    the means; a dataset without one of a link's methods skips that
    link."""
    means = dict(proxyfl=0.9, fml=0.8, avgpush=0.5, cwt=0.6, fedavg=0.55,
                 regular=0.3, joint=0.85)
    rows = [dict(dataset="mnist", method=m, acc_mean=a, acc_std=0.01)
            for m, a in means.items()]
    rows.append(dict(dataset="mnist", method="proxyfl-proxy", acc_mean=0.2,
                     acc_std=0.0))
    rows.append(dict(dataset="cifar10", method="fml", acc_mean=0.4,
                     acc_std=0.0))
    rows.append(dict(dataset="cifar10", method="fedavg", acc_mean=0.4,
                     acc_std=0.0))
    verdicts = fig3_accuracy.ordering(rows)
    got = {(v["dataset"], v["link"]): v["met"] for v in verdicts}
    assert len(got) == len(verdicts) == len(fig3_accuracy.LINKS)
    assert got["mnist", "proxyfl >= fml"]
    assert not got["mnist", "avgpush >= fedavg"]
    assert got["mnist", "cwt >= fedavg"]
    assert not got["mnist", "joint >= proxyfl"]
    assert got["mnist", "joint >= fml"]
    assert all(ds == "mnist" for ds, _ in got)


def test_fig3_cli_prints_rows_then_verdicts(capsys):
    fig3_accuracy.main(["--device", "cpu", "--datasets", "mnist",
                        "--rounds", "1", "--clients", "2",
                        "--train-factor", "0.01"])
    lines = [json.loads(line) for line in
             capsys.readouterr().out.splitlines()]
    rows = [r for r in lines if "method" in r]
    assert [r["method"] for r in rows] == [
        "proxyfl", "proxyfl-proxy", "fml", "fml-proxy", "avgpush", "fedavg",
        "cwt", "regular", "joint"]
    assert all(r["rounds"] == 1 and r["clients"] == 2 for r in rows)
    assert len(lines) - len(rows) == len(fig3_accuracy.LINKS)
