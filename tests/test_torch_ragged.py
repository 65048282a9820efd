"""Ragged (Dirichlet, size-skewed) cohorts in the port against the JAX
package.

* Data: ``partition_dirichlet``, ``_ensure_nonempty`` (empty clients
  filled from the largest one), ``client_lengths`` and ``pad_compatible``
  equal to the reference's on the same numpy inputs.
* ``run_federated`` on the reference's own Dirichlet cohorts
  (``benchmarks/common.py::federation_data`` at 0.02 of the data: kvasir
  clients of 9, 10, 19 and 22 examples, camelyon of 30, 9, 9 and 8) with
  the conv models the figures DP-train there (cnn1 as table 2's private
  and proxy model, the small VGG as fig. 6's), B = 8 in epoch mode, so
  each client takes its own number of steps (``max(1, n_k // B)``), 2
  rounds. The reference runs on its ``"auto"`` backend (padded and
  mask-sampled), the port client by client from the reference's initial
  state and on its draws (tests/test_torch_hetero.py's ``replay``).

Grades: per-client accountant steps and epsilons exactly; params, Adam
moments, de-bias weights and accuracies at the conformance ``close`` grade
(atol 1e-5, rtol 1e-4).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from test_torch_threads import one_torch_thread  # noqa: E402,F401
import benchmarks.common as jax_common  # noqa: E402

from repro.core.accountant import epsilon_for as jax_epsilon_for  # noqa: E402
from repro.data import partition as jax_partition  # noqa: E402
from repro.data import ragged as jax_ragged  # noqa: E402
from repro_torch.benchmarks import common  # noqa: E402
from repro_torch.data import ragged  # noqa: E402
from repro_torch.data.partition import partition_dirichlet  # noqa: E402
from test_torch_hetero import assert_runs_close, replay, specs  # noqa: E402

B, ROUNDS = 8, 2


@pytest.mark.parametrize("n_clients,n,alpha,n_classes",
                         [(4, 200, 0.5, 8), (8, 700, 1.0, 2),
                          (3, 50, 0.1, 10)])
def test_partition_dirichlet_equals_reference(n_clients, n, alpha,
                                              n_classes):
    y = np.random.default_rng(n).integers(0, n_classes, n)
    ours = partition_dirichlet(np.random.default_rng(3), y, n_clients, alpha)
    theirs = jax_partition.partition_dirichlet(np.random.default_rng(3), y,
                                               n_clients, alpha)
    assert len(ours) == len(theirs) == n_clients
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("sizes", [[5, 0, 3, 0], [0, 0, 0, 4], [4, 4, 4],
                                   [0, 1, 7]])
def test_ensure_nonempty_equals_reference(sizes):
    starts = np.cumsum([0] + sizes)
    idxs = [np.arange(a, b) for a, b in zip(starts[:-1], starts[1:])]
    ours = common._ensure_nonempty(np.random.default_rng(1), idxs)
    theirs = jax_common._ensure_nonempty(np.random.default_rng(1), idxs)
    assert all(len(i) > 0 for i in ours)
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a, b)


def test_ensure_nonempty_refuses_fewer_samples_than_clients():
    idxs = [np.arange(1), np.arange(0), np.arange(0)]
    for fn in (common._ensure_nonempty, jax_common._ensure_nonempty):
        with pytest.raises(ValueError, match="fewer samples than clients"):
            fn(np.random.default_rng(0), idxs)


def _cohort(kind):
    rng = np.random.default_rng(0)

    def client(n, shape=(3, 2), dtype=np.float32):
        return (rng.standard_normal((n,) + shape).astype(dtype),
                rng.integers(0, 4, n).astype(np.int32))

    return {
        "equal": [client(5), client(5)],
        "ragged": [client(5), client(9), client(1)],
        "trailing_dims": [client(5), client(5, shape=(2, 3))],
        "dtypes": [client(5), client(5, dtype=np.float64)],
        "structure": [client(5), client(5) + (np.zeros(5),)],
        "leading_dims": [client(5), (np.zeros((5, 2)), np.zeros(4))],
        "empty": [],
    }[kind]


KINDS = ["equal", "ragged", "trailing_dims", "dtypes", "structure",
         "leading_dims", "empty"]


@pytest.mark.parametrize("kind", KINDS)
def test_pad_compatible_equals_reference(kind):
    data = _cohort(kind)
    ours = [tuple(torch.as_tensor(a) for a in d) for d in data]
    assert ragged.pad_compatible(ours) == jax_ragged.pad_compatible(data)


@pytest.mark.parametrize("kind", KINDS)
def test_client_lengths_equals_reference(kind):
    data = _cohort(kind)
    ours = [tuple(torch.as_tensor(a) for a in d) for d in data]
    try:
        want = jax_ragged.client_lengths(data)
    except ValueError:
        with pytest.raises(ValueError, match="leading"):
            ragged.client_lengths(ours)
        return
    got = ragged.client_lengths(ours)
    assert got.dtype == want.dtype == np.int64
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dataset,method,arch,seed", [
    ("kvasir", "proxyfl", "cnn1", 0),
    ("camelyon", "fml", "cnn1", 2),
    ("kvasir", "avgpush", "vgg", 0),
    ("camelyon", "joint", "cnn1", 2),
])
def test_dirichlet_run_federated_matches_reference(dataset, method, arch,
                                                   seed):
    jdata, jtest, d = jax_common.federation_data(dataset, 4, seed,
                                                 n_train_factor=0.02)
    sizes = [int(x.shape[0]) for x, _ in jdata]
    assert len(set(sizes)) > 1   # a ragged cohort
    (jspec,), (tspec,) = specs((arch,), d["shape"], d["n_classes"])
    got, want = replay(method, [jspec] * 4, jspec, [tspec] * 4, tspec, jdata,
                       jtest, batch_size=B, rounds=ROUNDS, seed=seed)
    if method == "joint":
        sizes = [sum(sizes)]
    steps = [ROUNDS * max(1, n // B) for n in sizes]
    assert [c.accountant.steps for c in got["clients"]] == steps
    assert len(set(steps)) > 1 or method == "joint"
    assert got["epsilon"] == [
        jax_epsilon_for(noise_multiplier=1.0, sample_rate=min(1.0, B / n),
                        steps=s, delta=1e-5) for n, s in zip(sizes, steps)]
    assert_runs_close(got, want)
