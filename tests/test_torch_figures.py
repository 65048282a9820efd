"""The port's figure drivers against the JAX package's
(``src/repro_torch/benchmarks/`` against ``benchmarks/``): fig. 5's
ablations, fig. 11, the dropout sweep, table 2 and fig. 6.

* Configurations: every call a driver makes to ``bench_methods`` (and, in
  fig. 5b, to ``federation_data`` and ``run_federated``) recorded in both
  packages and compared, quick and ``--full``. The port calls
  ``bench_methods`` one method at a time so that rows print as they
  finish; consecutive calls with the same arguments are merged before the
  comparison. The port runs on its kernels (``use_pallas=True``), which
  the reference's drivers leave off; fig. 6's ``--full`` asks for
  ``"vgg"`` where the reference asks for ``"vgg_small"``, a name its
  registry lacks.
* Rows: fig. 11's and table 2's privacy rows exactly equal; the dropout
  sweep's rows built alike from the same ``bench_methods`` rows.
* The command line at a tiny size on the CPU (fig. 6's Dirichlet cohort).
"""
import dataclasses
import json

import pytest

torch = pytest.importorskip("torch")
from test_torch_threads import one_torch_thread  # noqa: E402,F401
import benchmarks.fig11_batchsize as jax_fig11  # noqa: E402
import benchmarks.fig5_ablations as jax_fig5  # noqa: E402
import benchmarks.fig6_kvasir as jax_fig6  # noqa: E402
import benchmarks.fig_dropout as jax_dropout  # noqa: E402
import benchmarks.table2_histo as jax_table2  # noqa: E402

from repro.nn import vision as jax_vision  # noqa: E402
from repro_torch.benchmarks import (common, fig5_ablations,  # noqa: E402
                                    fig6_kvasir, fig11_batchsize,
                                    fig_dropout, table2_histo)

PAIRS = {"fig5": (jax_fig5, fig5_ablations),
         "dropout": (jax_dropout, fig_dropout),
         "table2": (jax_table2, table2_histo),
         "fig6": (jax_fig6, fig6_kvasir)}


def fake_bench(calls):
    """A ``bench_methods`` that records its arguments and returns a row
    per method, and a ``-proxy`` row for ProxyFL and FML."""
    def bench(ds, methods, **kw):
        kw.pop("device", None)
        kw["seeds"] = list(kw["seeds"])
        calls.append((ds, tuple(methods), kw))
        names = [n for m in methods for n in (
            (m, m + "-proxy") if m in ("proxyfl", "fml") else (m,))]
        return [dict(dataset=ds, method=n, acc_mean=len(n) / 100,
                     acc_std=0.1, epsilon=1.0, rounds=kw["rounds"],
                     clients=kw["n_clients"], dp=kw.get("dp", True),
                     seconds=0.0) for n in names]
    return bench


def fake_federation(calls, K=4):
    """``federation_data`` and ``run_federated`` that record their
    arguments (the config as a dict, ``use_pallas`` apart)."""
    def data(dataset, n_clients, seed, **kw):
        kw.pop("device", None)
        calls.append(("federation_data", dataset, n_clients, seed, kw))
        return [None] * n_clients, None, dict(shape=(28, 28, 1),
                                              n_classes=10)

    def run(method, private_specs, proxy_spec, client_data, test, cfg,
            **kw):
        kw.pop("device", None)
        cfg = dataclasses.asdict(cfg)
        cfg.pop("use_pallas")
        calls.append(("run_federated", method,
                      [s.name for s in private_specs], proxy_spec.name, cfg,
                      kw))
        return {"history": [{"private_acc": [0.5] * K, "acc": [0.5] * K}]}
    return data, run


def merged(calls):
    """Consecutive ``bench_methods`` calls with equal arguments as one."""
    out = []
    for call in calls:
        if (out and call[0] == "bench" and out[-1][0] == "bench"
                and out[-1][1] == call[1] and out[-1][3] == call[3]):
            out[-1] = ("bench", call[1], out[-1][2] + call[2], call[3])
        else:
            out.append(call)
    return out


def record(monkeypatch, module, common_module, full, port):
    """Every call of one driver's run, in order."""
    calls = []

    def bench(ds, methods, **kw):
        rows = fake_bench(raw)(ds, methods, **kw)
        calls.append(("bench",) + raw[-1])
        return rows

    raw = []
    data, run = fake_federation(calls)
    target = common_module if port else module
    monkeypatch.setattr(target, "bench_methods", bench)
    for name, fn in (("federation_data", data), ("run_federated", run)):
        if hasattr(module, name):
            monkeypatch.setattr(module, name, fn)
    rows = module.run(full, device="cpu") if port else module.run(full)
    return merged(calls), rows


@pytest.mark.parametrize("full", [False, True])
@pytest.mark.parametrize("figure", sorted(PAIRS))
def test_driver_configuration_equals_reference(monkeypatch, figure, full):
    jax_mod, port_mod = PAIRS[figure]
    theirs, their_rows = record(monkeypatch, jax_mod, None, full, port=False)
    ours, our_rows = record(monkeypatch, port_mod, common, full, port=True)
    if figure == "fig6" and full:
        # the reference's name for the model it registers as "vgg"
        for call in theirs:
            kw = call[3]
            assert kw["private_arch"] == kw["proxy_arch"] == "vgg_small"
            kw["private_arch"] = kw["proxy_arch"] = "vgg"
    assert ours == theirs
    assert len(ours) > 0
    assert our_rows == their_rows


def test_reference_fig6_full_names_a_model_it_lacks():
    assert "vgg_small" not in jax_vision.MODELS
    assert jax_vision.MODELS["vgg"].init is jax_vision.init_vgg_small
    with pytest.raises(KeyError):
        jax_vision.get_vision_model("vgg_small")


@pytest.mark.parametrize("full", [False, True])
def test_fig11_rows_equal_reference(full):
    assert fig11_batchsize.run(full) == jax_fig11.run(full)


def test_table2_privacy_rows_equal_reference(monkeypatch):
    monkeypatch.setattr(jax_table2, "bench_methods", lambda *a, **k: [])
    assert table2_histo.privacy_rows() == jax_table2.run(False)
    assert table2_histo.TRAIN_SIZES == jax_table2.TRAIN_SIZES
    assert table2_histo.PAPER_EPS == jax_table2.PAPER_EPS


def test_driver_command_line_on_the_cpu(capsys):
    common.driver_main(fig6_kvasir.__doc__, fig6_kvasir.iter_rows,
                       ["--device", "cpu", "--rounds", "1",
                        "--train-factor", "0.02"])
    rows = [json.loads(line) for line in
            capsys.readouterr().out.splitlines()]
    assert [r["method"] for r in rows] == [
        "proxyfl", "proxyfl-proxy", "fml", "fml-proxy", "avgpush", "fedavg",
        "regular", "joint"]
    assert all(r["dataset"] == "kvasir" and r["rounds"] == 1
               and r["clients"] == 4 and r["epsilon"] > 0 for r in rows)
