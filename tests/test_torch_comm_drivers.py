"""The port's drivers of the compressed exchange and the privacy check
against the JAX package's: ``repro_torch.benchmarks.fig4_comm``,
``fig_compress`` and ``mia_privacy``.

* Fig. 4: every row equal to the reference's ``benchmarks/fig4_comm.run``
  in its structural fields (none and int8 bytes, model and proxy bytes,
  bytes a round, the LLM rows) with the port's own init; with the
  reference's init params converted in, every row equal, the measured
  top-k bytes included; ``scripts/check_comm_claim.py`` (json and sys
  only) passes on the port's rows and on the file the driver writes.
* Fig_compress under ``REPRO_BENCH_COMPRESS_TINY`` and the MIA driver at a
  cut size run end to end on ``device="cpu"``: the claim gate's byte
  check passes, every AUC lies in [0, 1], epsilon is the JAX accountant's,
  and the member/holdout split is the reference's (numpy
  ``default_rng(7)``, one permutation per client in order).
"""
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from test_torch_threads import one_torch_thread  # noqa: E402,F401
import jax  # noqa: E402

from benchmarks import fig4_comm as jax_fig4  # noqa: E402
from repro.core.accountant import epsilon_for as jax_epsilon_for  # noqa: E402
from repro.nn.vision import get_vision_model as jax_vision  # noqa: E402
from repro_torch.benchmarks import common, fig4_comm, fig_compress  # noqa: E402
from repro_torch.benchmarks import mia_privacy  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
STRUCTURAL = ("scale", "clients", "method", "compress", "dtype_bytes",
              "model_bytes", "proxy_bytes")


def _claim_gate():
    spec = importlib.util.spec_from_file_location(
        "check_comm_claim", ROOT / "scripts" / "check_comm_claim.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def reference_fig4(tmp_path_factory):
    path = tmp_path_factory.mktemp("fig4") / "fig4_comm.json"
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("REPRO_BENCH_COMM_JSON", str(path))
        rows = jax_fig4.run(False)
    return rows


@pytest.fixture(scope="module")
def port_fig4():
    return fig4_comm.rows_of(*fig4_comm.init_params("cpu"))


def test_fig4_rows_structurally_equal(reference_fig4, port_fig4):
    # (4 paper-scale cohorts + 3 LLM ones) × 5 methods × 3 wire formats
    assert len(port_fig4) == len(reference_fig4) == (4 + 3) * 5 * 3
    for ours, theirs in zip(port_fig4, reference_fig4):
        assert list(ours) == list(theirs)
        assert {k: ours[k] for k in STRUCTURAL} == \
            {k: theirs[k] for k in STRUCTURAL}
        if ours["compress"] != "topk" or ours["scale"].startswith("llm"):
            assert ours == theirs
        else:   # measured: a bitmap and at most k bf16 values
            for key in ("wire_model_bytes", "wire_proxy_bytes"):
                assert ours[key] <= theirs[key]
                assert ours[key] > theirs[key] // 2


def test_fig4_rows_equal_on_the_reference_init(reference_fig4):
    priv = jax_vision("lenet5").init(jax.random.PRNGKey(0), (28, 28, 1), 10)
    prox = jax_vision("mlp").init(jax.random.PRNGKey(1), (28, 28, 1), 10)
    to_port = lambda p: params_from_numpy(  # noqa: E731
        jax.tree_util.tree_map(np.asarray, p))
    assert fig4_comm.rows_of(to_port(priv), to_port(prox)) == reference_fig4


def test_fig4_claim_gate_passes_on_the_port(port_fig4, tmp_path,
                                            monkeypatch, capsys):
    gate = _claim_gate()
    gate.check_fig4(port_fig4)
    path = tmp_path / "fig4_comm.json"
    monkeypatch.setenv("REPRO_BENCH_COMM_JSON", str(path))
    rows = fig4_comm.run(False, device="cpu")
    assert json.loads(path.read_text()) == rows
    gate.main(["check_comm_claim.py", str(path), str(tmp_path / "none")])
    assert "COMM CLAIM OK" in capsys.readouterr().out


def test_fig_compress_tiny_end_to_end(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("REPRO_BENCH_COMPRESS_TINY", "1")
    monkeypatch.setenv("REPRO_BENCH_COMPRESS_JSON",
                       str(tmp_path / "fig_compress.json"))
    rows = fig_compress.run(False, device="cpu")
    assert [(r["method"], r["compress"]) for r in rows] == \
        list(fig_compress.GRID)
    for r in rows:
        assert (r["clients"], r["rounds"]) == (4, 2)
        assert 0.0 <= r["acc_mean"] <= 1.0
    assert [r["reduction_vs_none"] for r in rows] == [1.0, 6.4, 4.0, None]
    assert rows[0]["wire_bytes_per_msg"] == 4 * 199_210
    gate = _claim_gate()
    gate.check_fig_compress(rows)
    assert "tiny slice" in capsys.readouterr().out
    assert json.loads((tmp_path / "fig_compress.json").read_text()) == rows


def test_bench_methods_passes_the_exchange_knobs(monkeypatch):
    """``compress`` reaches the run's config (fig_compress's rows change
    nothing else), at the ratio fig_compress's byte columns assume."""
    seen = []

    def capture(method, privs, prox, data, test, cfg, **kw):
        seen.append(cfg)
        return {"history": [{"round": 1, "acc": [0.5] * len(data)}],
                "epsilon": [None] * len(data), "clients": []}

    monkeypatch.setattr(common, "run_federated", capture)
    common.bench_methods("mnist", ("fedavg",), n_clients=2, rounds=1,
                         seeds=(0,), n_train_factor=0.01, device="cpu",
                         compress="topk")
    common.bench_methods("mnist", ("fedavg",), n_clients=2, rounds=1,
                         seeds=(0,), n_train_factor=0.01, device="cpu")
    assert [c.compress for c in seen] == ["topk", "none"]
    assert seen[0].compress_ratio == fig_compress.RATIO


def test_mia_privacy_at_a_cut_size_end_to_end():
    exp = mia_privacy.experiment(False, "cpu", rounds=1, n_train_factor=0.1)
    rows = mia_privacy.rows_of(exp)
    assert [r["client"] for r in rows] == [0, 1, 2, 3, "mean"]
    for r in rows:
        for key in ("mia_auc_proxy_dp", "mia_auc_proxy_no_dp",
                    "mia_auc_private_nonreleased"):
            assert 0.0 <= r[key] <= 1.0
    # 100 examples a client, halved: 50 members, B = 25, 2 steps a round
    h = 50
    want = jax_epsilon_for(noise_multiplier=2.0, sample_rate=25 / h,
                           steps=h // 25, delta=1e-5)
    assert exp["results"][True]["epsilon"] == [want] * 4
    assert exp["results"][False]["epsilon"] == [None] * 4
    assert rows[0]["epsilon"] == round(want, 3)
    data, _, _ = common.federation_data("mnist", 4, 0, n_train_factor=0.1,
                                        device="cpu")
    rng = np.random.default_rng(7)
    for (x, y), (xm, ym), (xh, _) in zip(data, exp["members"],
                                         exp["holdouts"]):
        perm = torch.as_tensor(rng.permutation(x.shape[0]))
        assert torch.equal(xm, x[perm[:h]]) and torch.equal(ym, y[perm[:h]])
        assert torch.equal(xh, x[perm[h:]])
