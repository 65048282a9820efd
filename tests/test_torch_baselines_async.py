"""The single-model methods on the async backend and under §3.4 dropout,
in the port against the JAX engine: AvgPush at staleness τ = 2 (four
rounds, so the mail sent in the first two rounds is delivered in the last
two) and FedAvg with ``dropout_rate=0.25`` (two rounds), each from the
reference's initial state and on its batch indices and DP noise, with the
sizes and grades of tests/test_torch_baselines.py (``use_pallas=True``,
the reference's Pallas kernels in interpret mode): params, Adam moments,
de-bias weights and the in-flight buffers at the ``close`` grade, epsilon
exactly, metrics NaN exactly where the reference's are.
"""
import numpy as np
import pytest

pytest.importorskip("torch")
from test_torch_threads import one_torch_thread  # noqa: E402,F401

from test_torch_baselines import (K, assert_epsilon_exact,  # noqa: E402
                                  assert_metrics_close, assert_states_close,
                                  federation)


@pytest.fixture(scope="module")
def async_avgpush():
    return federation("avgpush", backend="async", rounds=4, staleness=2)


@pytest.fixture(scope="module")
def dropout_fedavg():
    return federation("fedavg", dropout_rate=0.25)


RUNS = ["async_avgpush", "dropout_fedavg"]


@pytest.mark.parametrize("runs", RUNS)
def test_params_moments_and_debias_weights_close(request, runs):
    r = request.getfixturevalue(runs)
    assert_states_close(r["tstate"], r["jstate"])


@pytest.mark.parametrize("runs", RUNS)
def test_epsilon_exact(request, runs):
    assert_epsilon_exact(request.getfixturevalue(runs))


@pytest.mark.parametrize("runs", RUNS)
def test_losses_close(request, runs):
    assert_metrics_close(request.getfixturevalue(runs))


def test_in_flight_buffers_close(async_avgpush):
    ours, theirs = async_avgpush["tstate"], async_avgpush["jstate"]
    assert tuple(ours["stale_theta"].shape) == theirs["stale_theta"].shape
    assert tuple(ours["stale_theta"].shape)[:2] == (2, K)
    assert np.abs(theirs["stale_w"]).sum() > 0   # mail really in flight
    for key in ("stale_theta", "stale_w"):
        np.testing.assert_allclose(ours[key].numpy(), theirs[key],
                                   atol=1e-5, rtol=1e-4)


def test_the_seed_drops_a_client(dropout_fedavg):
    masks = dropout_fedavg["masks"]
    assert any(m is not None and not m.all() for m in masks)
    assert np.isnan(dropout_fedavg["tmetrics"]["loss"]).any()
